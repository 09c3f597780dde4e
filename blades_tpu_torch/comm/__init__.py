"""Compressed update codecs under Byzantine-robust aggregation
(counterpart of ``blades_tpu/comm/``)."""

from blades_tpu_torch.comm.codecs import (  # noqa: F401
    CODEC_KEY_FOLD,
    CODEC_NAMES,
    CodecConfig,
    get_codec,
)
