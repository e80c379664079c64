"""ONNX op emitters of the port (counterpart of lele_tpu.ops): numpy when the
tracer folds a node, torch when the node runs on the device.

Importing this package registers every emitter in ``registry.OPS``: all
195 of the JAX package's ai.onnx emitters, everything of its `math_ops`,
`tensor_ops`, `nn_ops`, `activation_ops` and `quant_ops` (Conv, ConvTranspose
and ConvInteger over 1-3 spatial dims; QuantizeLinear, DequantizeLinear,
QLinearMatMul, QLinearConv, MatMulInteger, DynamicQuantizeLinear), the
recurrent LSTM, GRU and RNN, the long tail and the sequence and optional ops
(`extra_ops`: DFT, the windows, the losses, the sampling ops; sequences and
optionals are host-level values, as the JAX package's), `string_ops` and
`tfidf_ops` (strings fold on the host), `deform_ops`, the opset-23
attention family and AffineGrid (`attention_ops`), ImageDecoder (`io_ops`,
host-side at trace time), and all 52 of its com.microsoft ops, keyed on
their domain: all of JAX's `contrib_ops`, `genai_ops`, `qlinear_ops` (the
QOperator family), `fused_ops` and `diffusion_ops`, MoE and QMoE (`moe_ops`),
the generative search ops (`search_ops`: BeamSearch, GreedySearch, Sampling,
WhisperBeamSearch, NGramRepeatBlock) and the varlen ops (`packed_ops`);
com.microsoft Gelu, Trilu and Range reach the default emitters through
`registry.CONTRIB_ALIASES`. Any other op type follows the JAX dispatch rule: a
warning and an empty value, or a raise in strict mode.
"""

from . import (  # noqa: F401
    activation_ops,
    attention_ops,
    contrib_ops,
    deform_ops,
    diffusion_ops,
    extra_ops,
    fused_ops,
    genai_ops,
    io_ops,
    math_ops,
    moe_ops,
    nn_ops,
    packed_ops,
    qlinear_ops,
    quant_ops,
    search_ops,
    string_ops,
    tensor_ops,
    tfidf_ops,
)
from .registry import OPS, OpContext, make_ctx, op  # noqa: F401
