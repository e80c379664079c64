"""ONNX op emitters of the port (counterpart of lele_tpu.ops): numpy when the
tracer folds a node, torch when the node runs on the device.

Importing this package registers every emitter in ``registry.OPS``: 155 of
the JAX package's 195 ai.onnx emitters, everything of its `math_ops`,
`tensor_ops`, `nn_ops`, `activation_ops` and `quant_ops` (Conv, ConvTranspose
and ConvInteger over 1-3 spatial dims; QuantizeLinear, DequantizeLinear,
QLinearMatMul, QLinearConv, MatMulInteger, DynamicQuantizeLinear), the
recurrent LSTM, GRU and RNN, the sequence and optional ops (`extra_ops`:
host-level values, as the JAX package's), the opset-23 attention family
(`attention_ops`), ImageDecoder (`io_ops`, host-side at trace time), and the
com.microsoft ops, keyed on their domain: all of JAX's `contrib_ops`,
`genai_ops` and `qlinear_ops` (the QOperator family), MoE and QMoE
(`moe_ops`); com.microsoft Gelu, Trilu and Range reach the default emitters
through `registry.CONTRIB_ALIASES`. The 40 ai.onnx names still missing are
ROADMAP §1.1.3's: `extra_ops`' 33, `string_ops`, `tfidf_ops`, `deform_ops`
and AffineGrid. Any other op type follows the JAX dispatch rule: a warning
and an empty value, or a raise in strict mode.
"""

from . import (  # noqa: F401
    activation_ops,
    attention_ops,
    contrib_ops,
    extra_ops,
    genai_ops,
    io_ops,
    math_ops,
    moe_ops,
    nn_ops,
    qlinear_ops,
    quant_ops,
    tensor_ops,
)
from .registry import OPS, OpContext, make_ctx, op  # noqa: F401
