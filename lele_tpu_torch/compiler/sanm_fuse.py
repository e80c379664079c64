"""Whole-layer SAN-M fusion for compiled int8 ONNX graphs (counterpart of
lele_tpu/compiler/sanm_fuse.py).

The pass recognizes SAN-M transformer layers in the traced node stream by
dataflow structure —

    LayerNormalization → [DQL → MatMulInteger → Cast → Mul(a_s·w_s) → Add b]
      → Split(q,k,v) → per-head attention (Reshape/Transpose/MatMul/
        Mul(scale)/Add(mask bias)/Softmax/MatMul/Transpose/Reshape)
      + FSMN branch (Transpose → Mul(mask) → depthwise Conv → Transpose)
      → Add → [int8 linear] → +residual → LayerNormalization
      → [int8 linear] → Relu → [int8 linear] → +residual

— stacks every matched layer's weights with a leading layer axis, sends
them to the device once, and routes the whole run of layers to
kernels/sanm_block.py's `sanm_stack_dql` (exact ONNX DynamicQuantizeLinear
semantics).

Matching is conservative: any deviation from the template (an extra
consumer of an intermediate, a graph output inside the layer, a weight zero
point that is not clean, dims that differ between layers) makes the pattern
bail, and the tracer falls through to the per-op path, which carries full
ONNX generality. Unmatched nodes interleaved between matched ones (mask
chains) are traced first, so their values (attention bias, FSMN value mask)
feed the kernel as values: the export's masking is preserved, not
re-derived.

The JAX pass bails where its TPU kernel would not fit VMEM; this one bails
where the port's kernel does not go: a head dim it does not compile, or more
rows than it takes (`kernels.sanm_block.sanm_stack_dql_supported`). The
decision is the same on every device. `patterns=[]` (or a pattern list
without this one) turns the pass off.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_static(v) -> bool:
    return v is None or isinstance(v, (np.ndarray, np.generic))


def _node_attr(node, name, default=None):
    from ..ops.registry import parse_attr

    for a in node.attribute:
        if a.name == name:
            return parse_attr(a)
    return default



class _Match:
    """One attempted match over a node list (shared consumer index)."""

    def __init__(self, tracer, state, nodes, env):
        from .patterns import _dataflow_index

        self.nodes = nodes
        self.env = env
        self.state = state
        self.graph_outputs = state.graph_outputs
        self.cons_map, _, self.captured = _dataflow_index(tracer, nodes)
        self.claimed: set[str] = set()   # intermediate output names
        self.matched: set[int] = set()   # node indices consumed
        # real exporters (torch.onnx) feed Reshape shapes / Div scales from
        # Constant nodes placed just before use — at match time those sit
        # AFTER the current walk position, so env doesn't hold them yet.
        # Resolve them structurally (the node itself is left unmatched; the
        # interleaved-trace loop evaluates it for the per-op consumers).
        self._consts = {
            n.output[0]: n for n in nodes
            if n.op_type == "Constant" and n.output
        }
        self._producer = {
            out: j for j, n in enumerate(nodes) for out in n.output if out
        }
        # known static shapes of CLAIMED intermediates (not in env at match
        # time) — lets resolve_static fold Shape(...) chains, the idiom
        # torch.onnx emits for tensor.chunk() boundaries
        self.shape_hints: dict[str, tuple] = {}

    def cons(self, name):
        return self.cons_map.get(name, [])

    def take(self, idx, *out_names):
        self.matched.add(idx)
        self.claimed.update(n for n in out_names if n)

    def thru_identity(self, name):
        """Follow (and claim) a chain of single-consumer Identity nodes —
        real FunASR/optimizer exports interleave them freely; they must not
        break a structural match. Multi-consumer Identities stop the chain
        (the bail-vs-fuse decision then falls to the normal rules)."""
        while True:
            c = self.cons(name)
            if len(c) != 1 or self.nodes[c[0]].op_type != "Identity":
                return name
            j = c[0]
            out = self.nodes[j].output[0]
            self.take(j, out)
            name = out

    def only_consumer(self, name, op_type):
        name = self.thru_identity(name)
        c = self.cons(name)
        if len(c) != 1:
            return None
        n = self.nodes[c[0]]
        return (c[0], n) if n.op_type == op_type else None

    def static(self, name):
        v = self.env.get(name)
        if v is not None and _is_static(v):
            return np.asarray(v)
        n = self._consts.get(name)
        if n is not None:
            from ..onnx.loader import tensor_to_array

            for a in n.attribute:
                if a.name == "value" and a.has("t"):
                    return tensor_to_array(a.t)
        return None

    def resolve_static(self, name, chain: set | None = None, depth: int = 0):
        """Fold a pure not-yet-traced producer chain to a numpy value.

        torch.onnx computes slice boundaries, reshape targets, etc. through
        Shape → Gather → Add/Div/Mul chains over tensors that are INTERNAL
        to the layer being matched — env can't hold them at match time, but
        their values are fully static (shapes are static under the tracer).
        Folds the small op vocabulary such chains use; `chain` collects the
        producer node indices so the caller can claim them (Constant nodes
        are left out — they may feed ops outside the match and are free to
        re-trace). Returns None on anything unresolvable."""
        v = self.static(name)
        if v is not None:
            return v
        if depth > 48:
            return None
        j = self._producer.get(name)
        if j is None:
            return None
        n = self.nodes[j]
        op = n.op_type
        if op == "Shape":
            shp = self.shape_hints.get(n.input[0])
            if shp is None:
                ev = self.env.get(n.input[0])
                if ev is not None and not _is_static(ev) \
                        and hasattr(ev, "shape"):
                    shp = tuple(ev.shape)
            if shp is None:
                return None
            arr = np.asarray(shp, np.int64)
            start = int(_node_attr(n, "start", 0))
            end = _node_attr(n, "end", None)
            arr = arr[start:(None if end is None else int(end))]
            if chain is not None:
                chain.add(j)
            return arr
        ins = []
        for nm in n.input:
            if not nm:
                ins.append(None)
                continue
            iv = self.resolve_static(nm, chain, depth + 1)
            if iv is None:
                return None
            ins.append(iv)
        out = self._fold_pure(n, ins)
        if out is None:
            return None
        if chain is not None:
            chain.add(j)
        return out

    @staticmethod
    def _fold_pure(n, ins):
        """numpy fold of one shape-arithmetic op (ONNX semantics)."""
        op = n.op_type
        a = ins[0] if ins else None
        try:
            if op == "Identity":
                return a
            if op == "Gather":
                ax = int(_node_attr(n, "axis", 0))
                return np.take(a, np.asarray(ins[1], np.int64), axis=ax)
            if op in ("Add", "Sub", "Mul"):
                f = {"Add": np.add, "Sub": np.subtract,
                     "Mul": np.multiply}[op]
                return f(a, ins[1])
            if op == "Div":
                b = ins[1]
                if np.issubdtype(np.asarray(a).dtype, np.integer):
                    # ONNX integer Div truncates toward zero
                    aa, bb = np.asarray(a), np.asarray(b)
                    return (np.sign(aa) * np.sign(bb)
                            * (np.abs(aa) // np.abs(bb))).astype(aa.dtype)
                return np.divide(a, b)
            if op == "Neg":
                return np.negative(a)
            if op == "Unsqueeze":
                axes = ins[1] if len(ins) > 1 and ins[1] is not None \
                    else _node_attr(n, "axes", [0])
                out = np.asarray(a)
                for ax in sorted(int(x) for x in np.reshape(axes, (-1,))):
                    out = np.expand_dims(out, ax)
                return out
            if op == "Squeeze":
                axes = ins[1] if len(ins) > 1 and ins[1] is not None \
                    else _node_attr(n, "axes", None)
                if axes is None:
                    return np.squeeze(np.asarray(a))
                return np.squeeze(
                    np.asarray(a),
                    tuple(int(x) for x in np.reshape(axes, (-1,))))
            if op == "Concat":
                ax = int(_node_attr(n, "axis", 0))
                return np.concatenate([np.atleast_1d(x) for x in ins], ax)
            if op == "Cast":
                from ..onnx.loader import DTYPE_MAP

                to = DTYPE_MAP.get(int(_node_attr(n, "to", 1)))
                return None if to is None else np.asarray(a).astype(to)
            if op == "Slice" and len(ins) >= 3:
                data = np.asarray(a)
                starts = np.reshape(ins[1], (-1,)).astype(np.int64)
                ends = np.reshape(ins[2], (-1,)).astype(np.int64)
                axes = (np.reshape(ins[3], (-1,)).astype(np.int64)
                        if len(ins) > 3 and ins[3] is not None
                        else np.arange(len(starts)))
                steps = (np.reshape(ins[4], (-1,)).astype(np.int64)
                         if len(ins) > 4 and ins[4] is not None
                         else np.ones(len(starts), np.int64))
                ix = [slice(None)] * data.ndim
                for s, e, ax, st in zip(starts, ends, axes, steps):
                    ix[int(ax)] = slice(int(s), int(e), int(st))
                return data[tuple(ix)]
        except Exception:
            return None
        return None

    def slice_split(self, src: str, D: int):
        """torch.onnx's chunk() form of the qkv split: three Slice nodes on
        `src` at boundaries [0,D),[D,2D),[2D,3D) over the last axis, fed by
        a Shape-arithmetic boundary chain. Returns (q,k,v) names or None;
        claims the Slices AND the boundary chain."""
        src = self.thru_identity(src)
        slices = [
            (j, self.nodes[j]) for j in self.cons(src)
            if self.nodes[j].op_type == "Slice"
            and self.nodes[j].input[0] == src
        ]
        if len(slices) != 3:
            return None
        chain: set[int] = set()
        bounds = []
        for j, n in slices:
            if len(n.input) < 3:
                return None
            starts = self.resolve_static(n.input[1], chain)
            ends = self.resolve_static(n.input[2], chain)
            axes = (self.resolve_static(n.input[3], chain)
                    if len(n.input) > 3 and n.input[3] else None)
            steps = (self.resolve_static(n.input[4], chain)
                     if len(n.input) > 4 and n.input[4] else None)
            if starts is None or ends is None or starts.size != 1 \
                    or ends.size != 1:
                return None
            if axes is not None and (
                axes.size != 1 or int(axes.reshape(-1)[0]) not in (2, -1)
            ):
                return None
            if axes is None:
                return None  # axes-less Slice over all dims — not this form
            if steps is not None and (
                steps.size != 1 or int(steps.reshape(-1)[0]) != 1
            ):
                return None
            bounds.append((int(starts.reshape(-1)[0]),
                           int(ends.reshape(-1)[0]), j, n))
        bounds.sort()
        want = [(0, D), (D, 2 * D), (2 * D, 3 * D)]
        for (s, e, _, _), (ws, we) in zip(bounds, want):
            # the final end may be clamp-form (INT64_MAX etc.)
            if s != ws or (e != we and not (we == 3 * D and e >= 3 * D)):
                return None
        for _, _, j, n in bounds:
            self.take(j, n.output[0])
        for j in chain:
            self.take(j, *self.nodes[j].output)
        return tuple(n.output[0] for _, _, _, n in bounds)

    # -- sub-matchers -------------------------------------------------------

    def dql_linear(self, src: str):
        """src → DQL → MatMulInteger → Cast → Mul(a_s·w_s) → Add bias.
        Returns dict(w i8 [K,N], ws f32 [N or 1], b f32 [N], out) or None."""
        nodes = self.nodes
        src = self.thru_identity(src)
        dql = next(
            ((j, nodes[j]) for j in self.cons(src)
             if nodes[j].op_type == "DynamicQuantizeLinear"
             and nodes[j].input[0] == src),
            None,
        )
        if dql is None:
            return None
        jd, d = dql
        q_name, as_name, az_name = (list(d.output) + ["", ""])[:3]
        mmi = next(
            ((j, nodes[j]) for j in self.cons(q_name)
             if nodes[j].op_type == "MatMulInteger"
             and nodes[j].input[0] == q_name),
            None,
        )
        if mmi is None:
            return None
        jm, m = mmi
        w = self.static(m.input[1])
        if w is None or w.ndim != 2:
            return None
        azp_n = m.input[2] if len(m.input) > 2 else ""
        # the stack kernel implements the zero-point-corrected dot, so the
        # export must wire the DQL zp here (omitted azp = ONNX default 0 —
        # different math; the per-op path handles it)
        if not azp_n or azp_n != az_name:
            return None
        bzp_n = m.input[3] if len(m.input) > 3 else ""
        bzp = self.static(bzp_n) if bzp_n else None
        if bzp_n and bzp is None:
            return None
        # pre-shift to i8; only "clean" weight zero points supported (the
        # common export case) — otherwise the per-op path takes over
        if w.dtype == np.uint8:
            wzp = np.asarray(bzp, np.int32) - 128 if bzp is not None \
                else np.int32(-128)
            wi = (w.astype(np.int32) - 128).astype(np.int8)
        else:
            wzp = np.asarray(bzp, np.int32) if bzp is not None else np.int32(0)
            wi = w.astype(np.int8)
        if not np.all(wzp == 0):
            return None
        mm_out = m.output[0]
        c = self.only_consumer(mm_out, "Cast")
        if c is None or _node_attr(c[1], "to", 1) != 1:
            return None
        jc, cast = c
        mu = self.only_consumer(cast.output[0], "Mul")
        if mu is None:
            return None
        jmu, mul = mu
        other = mul.input[1] if mul.input[0] == cast.output[0] else mul.input[0]
        # the combined scale: Mul(a_scale, static w_scale) in either order
        jp = next(
            (jx for jx in self.cons(as_name)
             if other in nodes[jx].output and nodes[jx].op_type == "Mul"),
            None,
        )
        if jp is None:
            return None
        smul = nodes[jp]
        const_n = smul.input[1] if smul.input[0] == as_name else smul.input[0]
        ws = self.static(const_n)
        if ws is None or ws.size not in (1, w.shape[1]):
            return None
        ad = self.only_consumer(mul.output[0], "Add")
        if ad is None:
            return None
        ja, add = ad
        bias_n = add.input[1] if add.input[0] == mul.output[0] else add.input[0]
        bias = self.static(bias_n)
        if bias is None or bias.reshape(-1).shape != (w.shape[1],):
            return None
        self.take(jd, q_name, as_name, az_name)
        self.take(jm, mm_out)
        self.take(jc, cast.output[0])
        self.take(jmu, mul.output[0])
        self.take(jp, smul.output[0])
        self.take(ja)  # the Add's output is the linear's public output
        self.claimed.add(add.output[0])
        return {
            "wq": wi,
            "ws": np.asarray(ws, np.float32).reshape(-1),
            "b": np.asarray(bias, np.float32).reshape(-1),
            "out": add.output[0],
        }

    def head_path(self, src: str, perm: tuple):
        """src → Reshape([1,-1,h,hd]) → Transpose(perm). Returns
        (out_name, n_heads) or None. src may have other consumers (v feeds
        the FSMN branch too), so the Reshape is found among them."""
        rs = next(
            ((j, self.nodes[j]) for j in self.cons(src)
             if self.nodes[j].op_type == "Reshape"
             and self.nodes[j].input[0] == src),
            None,
        )
        if rs is None:
            return None
        jr, r = rs
        shape = self.static(r.input[1])
        if shape is None or shape.size != 4:
            return None
        shape = [int(s) for s in shape.reshape(-1)]
        if shape[0] != 1 or shape[2] <= 0 or shape[3] <= 0:
            return None
        tr = self.only_consumer(r.output[0], "Transpose")
        if tr is None or tuple(_node_attr(tr[1], "perm", [])) != perm:
            return None
        jt, t = tr
        self.take(jr, r.output[0])
        self.take(jt, t.output[0])
        self.claimed.add(t.output[0])
        return t.output[0], shape[2], shape[3]

    def layer(self, i_ln: int, x_name: str, T: int, D: int):
        """Match one SAN-M layer rooted at the LayerNormalization at i_ln
        whose residual stream is [1, T, D]. Returns a spec dict or None
        (the CALLER rolls back matched/claimed state on failure)."""
        nodes = self.nodes
        ln1 = nodes[i_ln]
        if ln1.op_type != "LayerNormalization" or ln1.input[0] != x_name:
            return None
        if int(_node_attr(ln1, "axis", -1)) not in (-1, 2):
            return None
        g1 = self.static(ln1.input[1])
        b1 = self.static(ln1.input[2]) if len(ln1.input) > 2 else None
        if g1 is None or b1 is None:
            return None
        eps1 = float(_node_attr(ln1, "epsilon", 1e-5))
        if g1.reshape(-1).shape != (D,):
            return None
        self.take(i_ln, ln1.output[0])

        qkv = self.dql_linear(ln1.output[0])
        if qkv is None or qkv["wq"].shape != (D, 3 * D):
            return None
        self.shape_hints[qkv["out"]] = (1, T, 3 * D)
        sp = self.only_consumer(qkv["out"], "Split")
        if sp is not None:
            js, split = sp
            if len(split.output) != 3 or int(_node_attr(split, "axis", 0)) \
                    not in (2, -1):
                return None
            sizes = _node_attr(split, "split", None)
            if sizes is None and len(split.input) > 1 and split.input[1]:
                sv = self.static(split.input[1])
                sizes = sv.reshape(-1).tolist() if sv is not None else [-1]
            if sizes is not None and list(sizes) != [D, D, D]:
                return None
            q_n, k_n, v_n = split.output
            self.take(js, q_n, k_n, v_n)
        else:
            # torch.onnx exports tensor.chunk() as 3 Slices + a
            # Shape-arithmetic boundary chain
            names = self.slice_split(qkv["out"], D)
            if names is None:
                return None
            q_n, k_n, v_n = names

        qh = self.head_path(q_n, (0, 2, 1, 3))
        kh = self.head_path(k_n, (0, 2, 3, 1))
        vh = self.head_path(v_n, (0, 2, 1, 3))
        if qh is None or kh is None or vh is None:
            return None
        if not (qh[1] == kh[1] == vh[1]) or qh[1] * qh[2] != D:
            return None
        H = qh[1]

        mm1 = self.only_consumer(qh[0], "MatMul")
        if mm1 is None or list(mm1[1].input) != [qh[0], kh[0]]:
            return None
        self.take(mm1[0], mm1[1].output[0])
        sc = self.only_consumer(mm1[1].output[0], "Mul")
        scale = None
        if sc is not None:
            m = sc[1]
            o = m.input[1] if m.input[0] == mm1[1].output[0] else m.input[0]
            v = self.static(o)
            if v is not None and v.size == 1:
                scale = float(v)
        else:
            sc = self.only_consumer(mm1[1].output[0], "Div")
            if sc is not None and sc[1].input[0] == mm1[1].output[0]:
                v = self.static(sc[1].input[1])
                if v is not None and v.size == 1 and float(v) != 0:
                    scale = 1.0 / float(v)
        if scale is None:
            return None
        self.take(sc[0], sc[1].output[0])
        ab = self.only_consumer(sc[1].output[0], "Add")
        if ab is None:
            return None
        m = ab[1]
        bias_n = m.input[1] if m.input[0] == sc[1].output[0] else m.input[0]
        # the bias producer is often INTERLEAVED after this node (real
        # export layout) and not yet traced — its value/shape is validated
        # post-emit in sanm_stack_dataflow
        self.take(ab[0], m.output[0])
        sm = self.only_consumer(m.output[0], "Softmax")
        if sm is None or int(_node_attr(sm[1], "axis", -1)) not in (-1, 3):
            return None
        self.take(sm[0], sm[1].output[0])
        mm2 = self.only_consumer(sm[1].output[0], "MatMul")
        if mm2 is None or list(mm2[1].input) != [sm[1].output[0], vh[0]]:
            return None
        self.take(mm2[0], mm2[1].output[0])
        tr2 = self.only_consumer(mm2[1].output[0], "Transpose")
        if tr2 is None or tuple(_node_attr(tr2[1], "perm", [])) != (0, 2, 1, 3):
            return None
        self.take(tr2[0], tr2[1].output[0])
        rs2 = self.only_consumer(tr2[1].output[0], "Reshape")
        if rs2 is None:
            return None
        shp = self.static(rs2[1].input[1])
        if shp is None or [int(s) for s in shp.reshape(-1)] not in (
            [1, -1, D], [1, T, D]
        ):
            return None
        self.take(rs2[0], rs2[1].output[0])
        ctx_n = rs2[1].output[0]

        # FSMN branch from v: Transpose → Mul(mask) → depthwise Conv → Transpose
        trv = next(
            ((j, self.nodes[j]) for j in self.cons(v_n)
             if self.nodes[j].op_type == "Transpose"
             and self.nodes[j].input[0] == v_n
             and tuple(_node_attr(self.nodes[j], "perm", [])) == (0, 2, 1)),
            None,
        )
        if trv is None:
            return None
        self.take(trv[0], trv[1].output[0])
        mv = self.only_consumer(trv[1].output[0], "Mul")
        if mv is None:
            return None
        m = mv[1]
        vmask_n = m.input[1] if m.input[0] == trv[1].output[0] else m.input[0]
        # value/shape validated post-emit (see bias_n above)
        self.take(mv[0], m.output[0])
        cv = self.only_consumer(m.output[0], "Conv")
        if cv is None:
            return None
        conv = cv[1]
        fw = self.static(conv.input[1])
        if fw is None or fw.ndim != 3 or fw.shape[:2] != (D, 1):
            return None
        K = int(fw.shape[2])
        if int(_node_attr(conv, "group", 1)) != D:
            return None
        if list(_node_attr(conv, "strides", [1])) != [1]:
            return None
        if list(_node_attr(conv, "dilations", [1])) != [1]:
            return None
        pads = [int(p) for p in _node_attr(conv, "pads", [0, 0])]
        if len(pads) != 2 or pads[0] + pads[1] != K - 1:
            return None
        if len(conv.input) > 2 and conv.input[2]:
            return None  # FSMN convs are bias-free in the exports we fuse
        self.take(cv[0], conv.output[0])
        trf = self.only_consumer(conv.output[0], "Transpose")
        if trf is None or tuple(_node_attr(trf[1], "perm", [])) != (0, 2, 1):
            return None
        self.take(trf[0], trf[1].output[0])
        fs_n = trf[1].output[0]

        acf = self.only_consumer(ctx_n, "Add")
        if acf is None or set(acf[1].input) != {ctx_n, fs_n}:
            return None
        self.take(acf[0], acf[1].output[0])

        out_lin = self.dql_linear(acf[1].output[0])
        if out_lin is None or out_lin["wq"].shape != (D, D):
            return None
        ar1 = next(
            ((j, self.nodes[j]) for j in self.cons(out_lin["out"])
             if self.nodes[j].op_type == "Add"
             and set(self.nodes[j].input) == {x_name, out_lin["out"]}),
            None,
        )
        if ar1 is None:
            return None
        self.take(ar1[0], ar1[1].output[0])
        x1_n = ar1[1].output[0]

        ln2 = next(
            ((j, self.nodes[j]) for j in self.cons(x1_n)
             if self.nodes[j].op_type == "LayerNormalization"
             and self.nodes[j].input[0] == x1_n),
            None,
        )
        if ln2 is None:
            return None
        jl2, l2 = ln2
        if int(_node_attr(l2, "axis", -1)) not in (-1, 2):
            return None
        g2 = self.static(l2.input[1])
        b2 = self.static(l2.input[2]) if len(l2.input) > 2 else None
        if g2 is None or b2 is None or g2.reshape(-1).shape != (D,):
            return None
        eps2 = float(_node_attr(l2, "epsilon", 1e-5))
        self.take(jl2, l2.output[0])
        ff1 = self.dql_linear(l2.output[0])
        if ff1 is None or ff1["wq"].shape[0] != D:
            return None
        F = ff1["wq"].shape[1]
        rl = self.only_consumer(ff1["out"], "Relu")
        if rl is None:
            return None
        self.take(rl[0], rl[1].output[0])
        ff2 = self.dql_linear(rl[1].output[0])
        if ff2 is None or ff2["wq"].shape != (F, D):
            return None
        ar2 = next(
            ((j, self.nodes[j]) for j in self.cons(ff2["out"])
             if self.nodes[j].op_type == "Add"
             and set(self.nodes[j].input) == {x1_n, ff2["out"]}),
            None,
        )
        if ar2 is None:
            return None
        self.take(ar2[0])
        self.claimed.add(x1_n)
        return {
            "T": T, "D": D, "F": F, "H": H, "K": K, "pads": tuple(pads),
            "eps1": eps1, "eps2": eps2, "scale": scale,
            "norm1": {"g": g1.reshape(-1), "b": b1.reshape(-1)},
            "norm2": {"g": g2.reshape(-1), "b": b2.reshape(-1)},
            "qkv": qkv, "out_lin": out_lin, "ffn1": ff1, "ffn2": ff2,
            "fsmn": fw[:, 0, :].T.copy(),       # [D,1,k] → [k, D]
            "attn_bias": bias_n, "vmask": vmask_n,
            "out": ar2[1].output[0],
        }


def _stack_step(x, biases, vmasks, stacked, **kw):
    """The recorded device step: the graph's per-layer attention bias and
    FSMN value mask stacked to [L, T], and the fused stack on x [1, T, D]."""
    from ..kernels.sanm_block import sanm_stack_dql

    T = x.shape[1]
    bias_l = torch.cat([b.reshape(1, T).to(torch.float32) for b in biases])
    vmask_l = torch.cat([v.reshape(1, T).to(torch.float32) for v in vmasks])
    return sanm_stack_dql(x[0].to(torch.float32), bias_l, vmask_l, stacked, **kw)[None]


def sanm_stack_dataflow(tracer, state, nodes, i, env, scope):
    """Pattern entry (compiler/patterns.py calling convention): at a
    LayerNormalization, match a run of SAN-M layers and route them to the
    fused DQL stack kernel. None = no match (per-op path)."""
    from ..kernels.sanm_block import sanm_stack_dql_supported

    node = nodes[i]
    if node.op_type != "LayerNormalization":
        return None
    x0_name = node.input[0]
    x0 = env.get(x0_name)
    if x0 is None or _is_static(x0) or x0.dim() != 3 or x0.shape[0] != 1:
        return None
    T0, D0 = int(x0.shape[1]), int(x0.shape[2])
    # a gate that needs no match goes first: a row count the kernel does not
    # take skips the structural walk at every LayerNormalization
    if not sanm_stack_dql_supported(D0, None, T0):
        return None

    m = _Match(tracer, state, nodes, env)
    layers = []
    i_ln, x_name = i, x0_name
    while True:
        # snapshot: a failed partial match must not leak claimed state
        snap_m, snap_c = set(m.matched), set(m.claimed)
        spec = m.layer(i_ln, x_name, T0, D0)
        if spec is None or (layers and any(
            spec[k] != layers[0][k]
            for k in ("T", "D", "F", "H", "K", "pads", "eps1", "eps2", "scale")
        )):
            m.matched, m.claimed = snap_m, snap_c
            break
        layers.append(spec)
        x_name = spec["out"]
        nxt = next(
            (j for j in m.cons(x_name)
             if nodes[j].op_type == "LayerNormalization"
             and nodes[j].input[0] == x_name),
            None,
        )
        if nxt is None:
            break
        i_ln = nxt
    if not layers:
        return None
    # intermediate layer outputs are also internal to the fused region
    for ly in layers[:-1]:
        m.claimed.add(ly["out"])
    s0 = layers[0]
    if not sanm_stack_dql_supported(s0["D"], s0["H"], s0["T"]):
        return None

    final_out = layers[-1]["out"]
    m.claimed.discard(final_out)
    # safety sweep: every claimed intermediate stays inside the matched set
    last = max(m.matched)
    for name in m.claimed:
        if name in state.graph_outputs or name in m.captured:
            return None  # captured = read inside some If/Loop body
        if any(j not in m.matched for j in m.cons(name)):
            return None
    for j in range(i, last + 1):
        if j not in m.matched and any(n in m.claimed for n in nodes[j].input):
            return None

    # trace the interleaved unmatched nodes first (mask chains etc.) so their
    # values, the attention bias and FSMN mask among them, exist. If the
    # validation below still bails, the main walk traces them again and the
    # trace drops these copies as dead.
    extra: set[int] = set()
    for j in range(i, last + 1):
        if j in m.matched:
            continue
        out = tracer._emit(state, nodes[j], env, scope, tag=str(j))
        outs = out if isinstance(out, tuple) else (out,)
        for name, val in zip(nodes[j].output, outs):
            if name:
                env[name] = val
        extra.add(j)

    # post-emit validation: the bias broadcasts over the key axis only, the
    # value mask over the value rows only
    T = s0["T"]
    for ly in layers:
        for key in ("attn_bias", "vmask"):
            v = env.get(ly[key])
            if v is None:
                return None
            shp = tuple(int(s) for s in np.shape(v))
            if not shp or shp[-1] != T or any(s != 1 for s in shp[:-1]):
                return None

    def dev(name, arr):
        return state.to_device(scope + f"::sanm{i}/{name}", np.asarray(arr))

    def stack_lin(key):
        specs = [ly[key] for ly in layers]
        wq = np.stack([s["wq"] for s in specs])             # [L, K, N]
        n = wq.shape[-1]
        colsum = wq.astype(np.int32).sum(axis=1, dtype=np.int32)[:, None, :]
        ws = np.stack([
            np.broadcast_to(s["ws"].reshape(-1), (n,)) for s in specs
        ])[:, None, :]
        b = np.stack([s["b"] for s in specs])[:, None, :]
        return {
            "wq": dev(f"{key}_wq", wq),
            "colsum": dev(f"{key}_colsum", colsum),
            "ws": dev(f"{key}_ws", ws.astype(np.float32)),
            "b": dev(f"{key}_b", b.astype(np.float32)),
        }

    def stack_norm(key):
        g = np.stack([ly[key]["g"] for ly in layers])[:, None, :]
        b = np.stack([ly[key]["b"] for ly in layers])[:, None, :]
        return {"g": dev(f"{key}_g", g.astype(np.float32)),
                "b": dev(f"{key}_b", b.astype(np.float32))}

    stacked = {
        "qkv": stack_lin("qkv"), "out": stack_lin("out_lin"),
        "ffn1": stack_lin("ffn1"), "ffn2": stack_lin("ffn2"),
        "norm1": stack_norm("norm1"), "norm2": stack_norm("norm2"),
        "fsmn": dev("fsmn", np.stack([ly["fsmn"] for ly in layers])
                    .astype(np.float32)),
    }

    def value(key):
        # a static mask (no speech_lengths input) goes to the device once
        return [env[ly[key]] if not _is_static(env[ly[key]])
                else state.to_device(scope + ly[key], env[ly[key]])
                for ly in layers]

    y = state.run(_stack_step, env[x0_name], value("attn_bias"), value("vmask"),
                  stacked, n_heads=s0["H"], fsmn_k=s0["K"], pad_left=s0["pads"][0],
                  eps1=s0["eps1"], eps2=s0["eps2"], att_scale=s0["scale"])
    state.pattern_hits["sanm_fused_layers"] = (
        state.pattern_hits.get("sanm_fused_layers", 0) + len(layers))
    consumed = set(m.matched) | extra
    return consumed, {final_out: y}
