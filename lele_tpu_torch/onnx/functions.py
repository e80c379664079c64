"""ONNX local-function (FunctionProto) inlining: the port's copy of
lele_tpu/onnx/functions.py.

torch.onnx exports with `export_modules_as_functions` (and the dynamo
exporter's module packaging) ship graphs whose nodes call model-local
functions instead of spelling their ops out. They are inlined before
tracing, so the tracer and its patterns see one flat graph.

Semantics follow the ONNX spec (IR §Functions) and onnx.inliner:

- A node calls function F when (node.domain, node.op_type, node.overload)
  matches F's identity, unless F is in a standard domain ("", "ai.onnx",
  "ai.onnx.ml") and the op has an emitter: as in onnxruntime, a registered
  kernel wins over a same-named function.
- Formal inputs and outputs bind to the call's actuals; every other name in
  the body is local and gets a per-call prefix, inside attribute subgraphs
  too. Empty names (absent inputs) stay empty; trailing formals the call
  leaves unbound become "".
- An attribute with `ref_attr_name` takes the call's attribute of that
  name, else the function's `attribute_proto` default, else it is dropped
  (the op's default applies).
- Functions may call functions (depth first, with a recursion guard), and
  calls inside If, Loop and Scan bodies inline too.
- A function that pins another ai.onnx opset than the model's is refused:
  inlined, its opset-sensitive ops would change meaning.
"""

from __future__ import annotations

# domains whose ops the tracer implements natively; function definitions
# never shadow these (onnxruntime precedence rule)
_NATIVE_DOMAINS = {"", "ai.onnx", "ai.onnx.ml"}

_MAX_DEPTH = 64  # generous; real exports nest a handful of levels


def _fn_key(domain: str, name: str, overload: str) -> tuple:
    return (domain or "", name, overload or "")


def _has_native_kernel(op_type: str) -> bool:
    if op_type in ("If", "Loop", "Scan", "SequenceMap"):
        return True
    from ..ops import OPS  # late import: the ops package imports torch

    return op_type in OPS


def _rename(name: str, binding: dict[str, str], prefix: str) -> str:
    if not name:
        return ""
    got = binding.get(name)
    return got if got is not None else prefix + name


def _subst_attrs(attrs: list[dict], call_attrs: dict[str, dict],
                 defaults: dict[str, dict]) -> list[tuple[dict, bool]]:
    """Resolve ref_attr_name attributes of a body node against the call.

    Returns (attr, from_call) pairs: a substituted attribute's content
    lives in the CALLER's namespace, so the body rename must not touch it
    (matters when the forwarded attribute is a subgraph)."""
    out = []
    for a in attrs:
        ref = a.get("ref_attr_name")
        if isinstance(ref, (bytes, memoryview)):
            ref = bytes(ref).decode()
        if not ref:
            out.append((a, False))
            continue
        src = call_attrs.get(ref)
        from_call = src is not None
        if src is None:
            src = defaults.get(ref)
        if src is None:
            continue  # unspecified → op default
        src = dict(src)
        src["name"] = a.get("name", ref)
        src.pop("ref_attr_name", None)
        out.append((src, from_call))
    return out


def _inline_nodes(nodes: list[dict], table: dict[tuple, dict],
                  counter: list[int], depth: int) -> list[dict]:
    """Expand function-call nodes in `nodes` (recursively), returning a new
    node list. Non-call nodes pass through untouched (same dict objects)."""
    if depth > _MAX_DEPTH:
        raise ValueError(
            "ONNX function expansion exceeded depth "
            f"{_MAX_DEPTH} — recursive function definitions are invalid"
        )
    out: list[dict] = []
    for n in nodes:
        dom = n.get("domain", "") or ""
        key = _fn_key(dom, n.get("op_type", ""), n.get("overload", ""))
        fn = table.get(key)
        if fn is not None and dom in _NATIVE_DOMAINS \
                and _has_native_kernel(n.get("op_type", "")):
            # registered kernel beats a same-named default-domain function
            # (onnxruntime precedence) — but a default-domain function
            # matching NO kernel must still inline (onnx.inliner behavior)
            fn = None
        if fn is None:
            # still recurse into attribute subgraphs (If/Loop bodies can
            # call functions)
            new_attrs = None
            for i, a in enumerate(n.get("attribute", [])):
                for gk in ("g",):
                    g = a.get(gk)
                    if g is not None:
                        gn = _inline_nodes(list(g.get("node", [])), table,
                                           counter, depth)
                        if gn is not g.get("node"):
                            if new_attrs is None:
                                new_attrs = [dict(x) for x in n["attribute"]]
                            g2 = dict(g)
                            g2["node"] = gn
                            new_attrs[i] = dict(new_attrs[i])
                            new_attrs[i][gk] = g2
                if a.get("graphs"):
                    gs = []
                    changed = False
                    for g in a["graphs"]:
                        gn = _inline_nodes(list(g.get("node", [])), table,
                                           counter, depth)
                        g2 = dict(g)
                        g2["node"] = gn
                        gs.append(g2)
                        changed = changed or gn is not g.get("node")
                    if changed:
                        if new_attrs is None:
                            new_attrs = [dict(x) for x in n["attribute"]]
                        new_attrs[i] = dict(new_attrs[i])
                        new_attrs[i]["graphs"] = gs
            if new_attrs is not None:
                n = dict(n)
                n["attribute"] = new_attrs
            out.append(n)
            continue

        counter[0] += 1
        prefix = f"__fn{counter[0]}_{fn.get('name', 'f')}/"
        formals_in = list(fn.get("input", []))
        formals_out = list(fn.get("output", []))
        actual_in = list(n.get("input", []))
        actual_out = list(n.get("output", []))
        if len(actual_out) > len(formals_out):
            raise ValueError(
                f"call to function {fn.get('name')!r} produces "
                f"{len(actual_out)} outputs but it declares "
                f"{len(formals_out)}"
            )
        binding: dict[str, str] = {}
        for i, f_name in enumerate(formals_in):
            # unbound trailing formals (and explicitly-absent "" actuals)
            # become the absent-input spelling inside the body
            binding[f_name] = actual_in[i] if i < len(actual_in) else ""
        for i, f_name in enumerate(formals_out):
            binding[f_name] = (
                actual_out[i] if i < len(actual_out) and actual_out[i]
                else prefix + f_name
            )
        call_attrs = {a["name"]: a for a in n.get("attribute", [])}
        defaults = {a["name"]: a for a in fn.get("attribute_proto", [])}

        body = []
        for bn in fn.get("node", []):
            bn2 = dict(bn)
            bn2["input"] = [_rename(x, binding, prefix)
                            for x in bn.get("input", [])]
            bn2["output"] = [_rename(x, binding, prefix)
                             for x in bn.get("output", [])]
            if bn.get("name"):
                bn2["name"] = prefix + bn["name"]
            bn2["attribute"] = _xform_attrs(
                list(bn.get("attribute", [])), binding, prefix,
                call_attrs, defaults,
            )
            body.append(bn2)
        # body may itself call functions (incl. other overloads)
        out.extend(_inline_nodes(body, table, counter, depth + 1))
    return out


def _xform_attrs(attrs: list[dict], binding: dict[str, str], prefix: str,
                 call_attrs: dict[str, dict],
                 defaults: dict[str, dict]) -> list[dict]:
    """Body-attribute transform: resolve ref_attr_name against the call,
    then apply the call's renaming inside attribute subgraphs (body
    subgraph nodes may capture function-local names). An attribute taken
    from the CALL SITE is already in the caller's namespace and must not
    be renamed; one from the function's defaults (or a plain body
    attribute) is in the body's namespace and must be."""
    out = []
    for a, from_call in _subst_attrs(attrs, call_attrs, defaults):
        if from_call:
            out.append(a)
            continue
        g = a.get("g")
        gs = a.get("graphs")
        if g is None and not gs:
            out.append(a)
            continue
        a = dict(a)
        if g is not None:
            a["g"] = _rename_graph(g, binding, prefix, call_attrs, defaults)
        if gs:
            a["graphs"] = [_rename_graph(x, binding, prefix,
                                         call_attrs, defaults) for x in gs]
        out.append(a)
    return out


def _rename_graph(g: dict, binding: dict[str, str], prefix: str,
                  call_attrs: dict[str, dict],
                  defaults: dict[str, dict]) -> dict:
    g2 = dict(g)
    g2["input"] = [_rename_vi(vi, binding, prefix) for vi in g.get("input", [])]
    g2["output"] = [_rename_vi(vi, binding, prefix) for vi in g.get("output", [])]
    inits = []
    for t in g.get("initializer", []):
        t2 = dict(t)
        t2["name"] = _rename(t.get("name", ""), binding, prefix)
        inits.append(t2)
    if inits:
        g2["initializer"] = inits
    nodes = []
    for n in g.get("node", []):
        n2 = dict(n)
        n2["input"] = [_rename(x, binding, prefix) for x in n.get("input", [])]
        n2["output"] = [_rename(x, binding, prefix) for x in n.get("output", [])]
        if n.get("name"):
            n2["name"] = prefix + n["name"]
        n2["attribute"] = _xform_attrs(
            list(n.get("attribute", [])), binding, prefix,
            call_attrs, defaults,
        )
        nodes.append(n2)
    g2["node"] = nodes
    return g2


def _rename_vi(vi: dict, binding: dict[str, str], prefix: str) -> dict:
    vi2 = dict(vi)
    vi2["name"] = _rename(vi.get("name", ""), binding, prefix)
    return vi2


def inline_functions(model_raw: dict) -> dict:
    """Return `model_raw` with every local-function call expanded in place
    (main graph and all nested subgraphs) and the `functions` list dropped.
    No-op (same dict) when the model declares no functions."""
    fns = model_raw.get("functions", [])
    if not fns:
        return model_raw
    model_opset = max(
        (int(o.get("version", 0)) for o in model_raw.get("opset_import", [])
         if o.get("domain", "") in ("", "ai.onnx")),
        default=None,
    )
    table: dict[tuple, dict] = {}
    for f in fns:
        # a function body is re-interpreted under the MODEL's opset after
        # inlining; if the function pins a DIFFERENT ai.onnx opset, opset-
        # sensitive ops (Softmax axis, Split forms, …) would silently
        # change meaning — refuse instead (torch exports always match)
        f_opset = max(
            (int(o.get("version", 0)) for o in f.get("opset_import", [])
             if o.get("domain", "") in ("", "ai.onnx")),
            default=None,
        )
        if (f_opset is not None and model_opset is not None
                and f_opset != model_opset):
            raise NotImplementedError(
                f"function {f.get('name')!r} declares ai.onnx opset "
                f"{f_opset} but the model is opset {model_opset}: inlining "
                "would re-interpret opset-sensitive ops. Re-export with a "
                "single opset (torch.onnx does), or version-convert first."
            )
        table[_fn_key(f.get("domain", ""), f.get("name", ""),
                      f.get("overload", ""))] = f
    counter = [0]
    g = dict(model_raw["graph"])
    g["node"] = _inline_nodes(list(g.get("node", [])), table, counter, 0)
    out = dict(model_raw)
    out["graph"] = g
    out.pop("functions", None)
    return out


def inline_model(model):
    """An `OnnxModel` with its local functions inlined (the model itself
    where it declares none): what the compiler and the model wrappers
    trace."""
    if not model.model.functions:
        return model
    from .loader import OnnxModel
    from .schema import Proto

    return OnnxModel(Proto(inline_functions(model.model.raw()), "ModelProto"),
                     path=model.path, base_dir=model.base_dir)
