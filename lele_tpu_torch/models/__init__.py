"""Model families of the port (counterpart of lele_tpu.models): SenseVoice
(w8a16 and w4a16) and Silero VAD, native; both also run from ONNX
(`models.checkpoints`)."""

from .checkpoints import SenseVoiceOnnx, SileroOnnx  # noqa: F401
from .common import cast_big_params  # noqa: F401
from .sensevoice import (  # noqa: F401
    SenseVoiceConfig,
    SenseVoiceModel,
    greedy_ctc_decode,
    init_sensevoice,
    prepare_w4_params,
    prepare_w8_params,
    sensevoice_encode,
    stack_layer_params,
)
from .silero import (  # noqa: F401
    SileroConfig,
    SileroVad,
    VadSegmentConfig,
    collect_segments,
    init_silero,
    silero_features,
    silero_step,
    zero_state,
)
