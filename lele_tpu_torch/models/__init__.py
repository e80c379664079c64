"""Model families of the port (counterpart of lele_tpu.models): SenseVoice
(f32/bf16, w8a16, w4a16, dynamic int8, MoE; batch, long-form and
streaming), Silero VAD, Supertonic TTS and the YOLO26 detector and
segmenter, native; all four also run from ONNX (`models.checkpoints`)."""

from .checkpoints import SenseVoiceOnnx, SileroOnnx, SupertonicOnnx, YoloOnnx  # noqa: F401
from .common import cast_big_params  # noqa: F401
from .sensevoice import (  # noqa: F401
    SenseVoiceConfig,
    SenseVoiceModel,
    greedy_ctc_decode,
    init_sensevoice,
    moe_ffn,
    prepare_quantized_params,
    prepare_w4_params,
    prepare_w8_params,
    sensevoice_encode,
    stack_layer_params,
)
from .sensevoice_stream import (  # noqa: F401
    StreamConfig,
    StreamingSenseVoice,
    init_stream_state,
    stream_step,
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
from .supertonic import (  # noqa: F401
    AVAILABLE_LANGS,
    SupertonicConfig,
    SupertonicTts,
    UnicodeIndexer,
    is_valid_lang,
    load_voice_style,
    normalize_text,
    prepare_chunks,
    supertonic_params_from_jax,
)
from .yolo26 import (  # noqa: F401
    Yolo26Config,
    Yolo26Model,
    compose_masks,
    decode_detections,
    init_yolo26,
    yolo26_forward,
    yolo26_params_from_jax,
)
