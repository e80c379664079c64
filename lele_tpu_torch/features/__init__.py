"""Audio front-end: framing, fbank, LFR, CMVN (counterpart of lele_tpu.features)."""

from .cmvn import cmvn  # noqa: F401
from .fbank import FbankConfig, FbankFrontend, fbank_features  # noqa: F401
from .framing import frame_signal  # noqa: F401
from .lfr import lfr_stack  # noqa: F401
