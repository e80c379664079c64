"""Model families of the port (counterpart of lele_tpu.models): SenseVoice so far."""

from .common import cast_big_params  # noqa: F401
from .sensevoice import (  # noqa: F401
    SenseVoiceConfig,
    SenseVoiceModel,
    greedy_ctc_decode,
    init_sensevoice,
    prepare_w8_params,
    sensevoice_encode,
    stack_layer_params,
)
