"""The standards code families: copies of ``ldpc_toolbox_tpu.codes``."""

from . import ccsds, dvbs2, nr5g  # noqa: F401
