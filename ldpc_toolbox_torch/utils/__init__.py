from .rng import Rng, sort_by_random_sel, sort_by_random_min, compare_none_as_inf  # noqa: F401
