"""Weights blob: flat binary + JSON manifest (the port's copy of
lele_tpu/compiler/weights.py, in the same format byte for byte).

A little-endian flat byte stream of 16-byte-aligned records, identical
content stored once (sha256 dedup), each tensor addressed by (offset,
nbytes, shape, dtype) in a sidecar JSON manifest. `pack_weights` takes numpy
arrays or torch tensors (from any device); `load_weights` returns CPU
tensors that are zero-copy views of the mapped blob.

bf16 is written and read as its raw 16-bit words under the dtype name
"bfloat16", as the JAX package writes it through ml_dtypes; this module
imports no ml_dtypes (the card machine has none).
"""

from __future__ import annotations

import hashlib
import json
import mmap
from pathlib import Path

import numpy as np
import torch

ALIGN = 16
MAGIC = "lele-tpu-weights-v1"

# manifest dtype name → torch dtype (numpy's names; "bfloat16" as ml_dtypes')
TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
    **{n: getattr(torch, n) for n in ("uint16", "uint32", "uint64") if hasattr(torch, n)},
}


def _host(arr) -> tuple[np.ndarray, str]:
    """A tensor or array → (a numpy array whose bytes are its contents, the
    manifest dtype name). bf16 travels as its uint16 words."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), t.numpy().dtype.name
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # an ml_dtypes array from the JAX side
        return arr.view(np.uint16), "bfloat16"
    return arr, arr.dtype.name


def pack_weights(params: dict, quantize: bool = False) -> tuple[bytes, dict]:
    """→ (blob, manifest). Identical content stored once (dedup).

    quantize=True stores rank-≥2 float32/float64 tensors of at least 1,024
    elements as symmetric per-tensor int8 with a dequant scale in the
    manifest (round half to even); the loader dequantizes on read."""
    blob = bytearray()
    entries: dict[str, dict] = {}
    by_hash: dict[str, int] = {}
    for name, value in params.items():
        arr, dtype = _host(value)
        shape = arr.shape
        arr = np.ascontiguousarray(arr)  # NB: promotes 0-d to 1-d
        scale = None
        if (quantize and arr.ndim >= 2 and dtype in ("float32", "float64")
                and arr.size >= 1024):
            absmax = float(np.abs(arr).max()) or 1.0
            scale = absmax / 127.0
            arr = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
            dtype = "int8"
        raw = arr.tobytes()
        h = hashlib.sha256(raw).hexdigest()[:32]
        if h in by_hash:
            offset = by_hash[h]
        else:
            blob += b"\0" * ((-len(blob)) % ALIGN)
            offset = len(blob)
            blob += raw
            by_hash[h] = offset
        entries[name] = {"offset": offset, "nbytes": len(raw), "shape": list(shape),
                         "dtype": dtype}
        if scale is not None:
            entries[name]["dequant_scale"] = scale
            entries[name]["dequant_dtype"] = "float32"
    return bytes(blob), {"magic": MAGIC, "align": ALIGN, "tensors": entries}


def save_weights(path_prefix: str | Path, params: dict, quantize: bool = False) -> None:
    """Writes <prefix>.bin + <prefix>.json."""
    blob, manifest = pack_weights(params, quantize=quantize)
    bin_path(path_prefix).write_bytes(blob)
    json_path(path_prefix).write_text(json.dumps(manifest, indent=1))


def bin_path(path_prefix: str | Path) -> Path:
    """<prefix>.bin: the suffix is appended, never substituted ("model.enc"
    and "model.dec" must not collide)."""
    p = Path(path_prefix)
    return p.parent / (p.name + ".bin")


def json_path(path_prefix: str | Path) -> Path:
    p = Path(path_prefix)
    return p.parent / (p.name + ".json")


def read_manifest(path_prefix: str | Path) -> dict:
    manifest = json.loads(json_path(path_prefix).read_text())
    if manifest.get("magic") != MAGIC:
        raise ValueError(f"{path_prefix}: bad weights manifest magic")
    return manifest


def entry_tensor(buf: torch.Tensor, e: dict) -> torch.Tensor:
    """One manifest entry cut from the blob `buf` (a uint8 tensor on any
    device) as a view, dequantized (a new tensor) where the entry says so.
    Offsets are 16-byte aligned, so every dtype's view is aligned."""
    t = buf[e["offset"]: e["offset"] + e["nbytes"]].view(TORCH_DTYPES[e["dtype"]])
    t = t.view(e["shape"])
    if "dequant_scale" in e:
        # numpy's rule (the JAX loader's): f32(q) * f32(scale), rounded once
        t = t.to(TORCH_DTYPES[e.get("dequant_dtype", "float32")]) * e["dequant_scale"]
    return t


def entry_tensors(buf: torch.Tensor, manifest: dict) -> dict[str, torch.Tensor]:
    """Every manifest entry cut from `buf` (`entry_tensor`). An entry that
    the dedup stored at an offset already handed out is a copy, so that an
    in-place write to one tensor (the generated wrapper's `copy_` into its
    params, say) never reaches a twin; only duplicates pay for it."""
    out, seen = {}, set()
    for name, e in manifest["tensors"].items():
        t = entry_tensor(buf, e)
        if e["offset"] in seen and "dequant_scale" not in e:
            t = t.clone()
        seen.add(e["offset"])
        out[name] = t
    return out


def load_weights(path_prefix: str | Path) -> dict[str, torch.Tensor]:
    """Map the blob; tensors are CPU views of the mapping (copy-on-write: a
    write to one changes neither the file nor another process's map, nor
    another tensor: `entry_tensors`)."""
    manifest = read_manifest(path_prefix)
    with open(bin_path(path_prefix), "rb") as f:
        # frombuffer keeps the mapping alive as long as a view of it lives
        flat = (torch.frombuffer(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY),
                                 dtype=torch.uint8)
                if f.seek(0, 2) else torch.zeros(0, dtype=torch.uint8))
    return entry_tensors(flat, manifest)
