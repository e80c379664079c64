"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Sources are under `lele_tpu_torch/csrc/`; `_build` compiles them with nvcc
at first use. Each wrapper keeps a launch count as an attribute
(`w8_matmul.launches`, ...); `launch_counts()` reads them all and
`reset_launch_counts()` sets them to 0.

A replay of a captured CUDA graph (runtime/graphs.py) runs no wrapper: the
capture records what its launches added (and sets the counts back with
`set_launch_counts`), and each replay adds that record once
(`add_launch_counts`), so `launch_counts()` reads what the uncaptured path
would, call by call.
"""

from .est_block import (  # noqa: F401
    estimator_blocks,
    estimator_blocks_plain,
    stack_est_blocks,
)
from .flash_attention import flash_attention, flash_attention_plain  # noqa: F401
from .gru import gru_seq, gru_seq_plain  # noqa: F401
from .lstm import lstm_seq, lstm_seq_plain  # noqa: F401
from .quant_matmul import (  # noqa: F401
    dynamic_quantize_u8,
    fused_dq_matmul,
    fused_dq_matmul_plain,
    int8_matmul,
    int8_matmul_plain,
    quantize_weight_int8,
    w8_matmul,
    w8_matmul_plain,
)
from .sanm_block import (  # noqa: F401
    fused_layer_available,
    sanm_layer_w8,
    sanm_layer_w8_plain,
    sanm_stack_dql,
    sanm_stack_dql_plain,
    sanm_stack_w4,
    sanm_stack_w4_plain,
    sanm_stack_w8,
    sanm_stack_w8_plain,
)
from .w4_matmul import (  # noqa: F401
    dequantize_int4,
    quantize_weight_int4,
    w4_matmul,
    w4_matmul_plain,
)

KERNEL_WRAPPERS = {
    "w8_gemm": w8_matmul,
    "sanm_layer_w8": sanm_layer_w8,
    "sanm_stack_w8": sanm_stack_w8,
    "dq_gemm": fused_dq_matmul,
    "sanm_stack_dql": sanm_stack_dql,
    "lstm_seq": lstm_seq,
    "w4_gemm": w4_matmul,
    "sanm_stack_w4": sanm_stack_w4,
    "gru_seq": gru_seq,
    "est_block": estimator_blocks,
    "flash_attn": flash_attention,
    "int8_gemm": int8_matmul,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def set_launch_counts(counts: dict[str, int]) -> None:
    for name, n in counts.items():
        KERNEL_WRAPPERS[name].launches = n


def add_launch_counts(counts: dict[str, int]) -> None:
    for name, n in counts.items():
        KERNEL_WRAPPERS[name].launches += n
