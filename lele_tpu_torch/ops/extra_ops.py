"""Sequence and optional values (the port's copy of the part of
lele_tpu/ops/extra_ops.py that Loop, Scan and SequenceMap graphs use).

ONNX sequences and optionals are trace-time structure, as in the JAX
package: a sequence is a host list of values (`TensorSeq`) whose length is
fixed while tracing, an optional a host wrapper (`OptionalVal`) that holds a
value or nothing. The ops that only restructure them (Optional,
OptionalHasElement, OptionalGetElement, SequenceEmpty, SequenceConstruct,
SequenceLength, SequenceAt, SequenceInsert, SequenceErase) are `host`
emitters: they run once while tracing and record no device step, and
SequenceLength and OptionalHasElement give static values. SplitToSequence
and ConcatFromSequence compute on the device: one recorded step each.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import OpContext, op

# -- optionals ------------------------------------------------------------------


class OptionalVal:
    """ONNX optional value: a trace-time wrapper holding a tensor, a sequence
    or nothing. Its structure is static (OptionalHasElement folds), so it has
    no device representation."""

    def __init__(self, value=None):
        self.value = value


@op("Optional", foldable=False, host=True)
def optional(ctx: OpContext, x=None):
    return OptionalVal(x)


@op("OptionalHasElement", foldable=False, host=True)
def optional_has_element(ctx: OpContext, x=None):
    if isinstance(x, OptionalVal):
        x = x.value
    return np.array(x is not None)


@op("OptionalGetElement", foldable=False, host=True)
def optional_get_element(ctx: OpContext, x):
    if isinstance(x, OptionalVal):
        if x.value is None:
            raise ValueError("OptionalGetElement on an empty optional")
        return x.value
    return x  # opset 18 takes a tensor or a sequence directly


# -- sequences --------------------------------------------------------------------


class TensorSeq(list):
    """ONNX sequence value: a trace-time list whose elements are tensors or
    static arrays. Its length is static; its elements may be device values."""


@op("SequenceEmpty", foldable=False, host=True)
def sequence_empty(ctx: OpContext):
    return TensorSeq()


@op("SequenceConstruct", foldable=False, host=True)
def sequence_construct(ctx: OpContext, *tensors):
    return TensorSeq(tensors)


@op("SequenceLength", foldable=False, host=True)
def sequence_length(ctx: OpContext, seq):
    return np.array(len(seq), np.int64)


def _seq_pos(position, n, default):
    if position is None:
        return default
    p = int(np.asarray(position))
    return p + n if p < 0 else p


@op("SequenceAt", foldable=False, static_args=(1,), host=True)
def sequence_at(ctx: OpContext, seq, position):
    return seq[_seq_pos(position, len(seq), 0)]


@op("SequenceInsert", foldable=False, static_args=(2,), host=True)
def sequence_insert(ctx: OpContext, seq, tensor, position=None):
    out = TensorSeq(seq)
    out.insert(_seq_pos(position, len(seq), len(seq)), tensor)
    return out


@op("SequenceErase", foldable=False, static_args=(1,), host=True)
def sequence_erase(ctx: OpContext, seq, position=None):
    out = TensorSeq(seq)
    del out[_seq_pos(position, len(seq), len(seq) - 1)]
    return out


@op("SplitToSequence", foldable=False, static_args=(1,))
def split_to_sequence(ctx: OpContext, x, split=None):
    axis = int(ctx.attr("axis", 0))
    axis = axis if axis >= 0 else axis + x.dim()
    n = x.shape[axis]
    if split is None:
        parts = torch.split(x, 1, dim=axis)
        if not int(ctx.attr("keepdims", 1)):
            parts = [p.squeeze(axis) for p in parts]
        return TensorSeq(parts)
    sp = np.asarray(split)
    if sp.ndim == 0:
        size = int(sp)
        sizes = [size] * (n // size) + ([n % size] if n % size else [])
    else:
        sizes = [int(s) for s in sp[:-1]]
        sizes.append(n - sum(sizes))  # the last part takes the rest, as jnp.split's cuts
    return TensorSeq(torch.split(x, sizes, dim=axis))


@op("ConcatFromSequence", foldable=False)
def concat_from_sequence(ctx: OpContext, seq):
    axis = int(ctx.attr("axis"))
    if int(ctx.attr("new_axis", 0)):
        return torch.stack(list(seq), dim=axis)
    return torch.cat(list(seq), dim=axis)
