"""ONNX op emitters of the port (counterpart of lele_tpu.ops): numpy when the
tracer folds a node, torch when the node runs on the device.

Importing this package registers every emitter in ``registry.OPS``: the ones
the SAN-M int8 graph uses, Identity, Div and ReduceSum, which its common
export variants add, Equal, Log, Sigmoid, Gemm, ReduceMean, STFT and
LSTM, which the Silero-class graphs add, GRU and RNN, Constant,
ConstantOfShape, Expand, Where, Tanh, Softplus and ConvTranspose, which the
Supertonic graphs add, Neg and LeakyRelu, which control-flow bodies add,
the sequence and optional ops (`extra_ops`: host-level values, as the JAX
package's), Attention, RotaryEmbedding, Swish, TensorScatter,
RMSNormalization and Gelu, which opset-23 LLM step graphs add, ImageDecoder
(`io_ops`, host-side at trace time), and the com.microsoft ops, keyed on
their domain: all of JAX's `contrib_ops` (MatMulNBits, the norms,
RotaryEmbedding, Attention, FusedMatMul, the Gelus, EmbedLayerNormalization,
GatherBlockQuantized, MatMulBnb4), all of its `genai_ops`
(GroupQueryAttention, SparseAttention, MultiHeadAttention and the
DecoderMasked pair), MoE and QMoE (`moe_ops`); com.microsoft Gelu and Range
reach the default emitters through `registry.CONTRIB_ALIASES`. Conv takes
1-3 spatial dims. Any other op type follows the JAX dispatch rule: a
warning and an empty value, or a raise in strict mode.
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
    quant_ops,
    tensor_ops,
)
from .registry import OPS, OpContext, make_ctx, op  # noqa: F401
