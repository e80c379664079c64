"""Audio front-end: framing, fbank, LFR, CMVN (counterpart of lele_tpu.features)."""

from .cmvn import cmvn  # noqa: F401
from .fbank import (  # noqa: F401
    FbankConfig,
    FbankFrontend,
    fbank_features,
    fbank_features_batch,
)
from .framing import frame_signal  # noqa: F401
from .lfr import lfr_stack  # noqa: F401
