from .mesh import Mesh, default_mesh, shard_batch  # noqa: F401
