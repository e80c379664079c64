"""Build and load the hand-written CUDA kernels (`lele_tpu_torch/csrc/*.cu`).

Each source becomes one shared library with a plain C interface, compiled by
`nvcc` for Hopper (`sm_90a`) at first use into `lele_tpu_torch/_build/` (git
ignores it) and loaded with `ctypes`. The file name carries a hash of the
source and the shared headers, so an edited source is rebuilt and a stale
library is never loaded. `build()` starts one `nvcc` per source, all at
once. Nothing here runs when the module is imported.

Every C entry point takes pointers and the CUDA stream as `void*`, ints as
`int`, floats as `float`, and returns `cudaGetLastError()` after its
launches; `check()` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Stems of every kernel source, e.g. ["sanm_layer", "w8_gemm"]."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _lib_path(stem: str) -> Path:
    h = hashlib.sha1((CSRC / f"{stem}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:12]}.so"


def build(stems: list[str] | None = None, extra_flags: tuple[str, ...] = ()
          ) -> dict[str, str]:
    """Compile the libraries that are missing, one `nvcc` per source in
    parallel. Returns each compiler's output (stderr), keyed by stem; raises
    if any compilation fails."""
    stems = sources() if stems is None else stems
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for stem in stems:
        out = _lib_path(stem)
        if out.exists() and not extra_flags:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def library(stem: str) -> ctypes.CDLL:
    """The loaded library for csrc/<stem>.cu, built first if missing."""
    lib = _libs.get(stem)
    if lib is None:
        path = _lib_path(stem)
        if not path.exists():
            build([stem])
        lib = ctypes.CDLL(str(path))
        lib.lele_error_string.argtypes = [ctypes.c_int]
        lib.lele_error_string.restype = ctypes.c_char_p
        _libs[stem] = lib
    return lib


def bind(stem: str, name: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry `name` of csrc/<stem>.cu with its argument types set."""
    fn = getattr(library(stem), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(stem: str, name: str, code: int) -> None:
    if code != 0:
        msg = library(stem).lele_error_string(code).decode()
        raise RuntimeError(f"{name} ({stem}.cu): CUDA error {code}: {msg}")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

DETAIL = 16  # csrc/grid_stack.cuh DETAIL: stamps a phase in a persistent kernel's trace


def phase_us(name: str, x, n: int, phases, launch):
    """A persistent stack kernel's own timer (csrc/grid_stack.cuh): one
    launch(trace) of the kernel on x's card with an int64 trace of P n + 1 +
    P DETAIL entries (P = len(phases)), which gets the global timer (ns) at
    the start and after each of the n layers' (blocks') P grid barriers,
    then stamps inside layer 1's phases. Returns (f64 [n, P] microseconds of
    each phase up to the end of the barrier after it, the raw int64 trace).
    A measurement: it refuses a CPU tensor (the plain versions have no
    phases)."""
    import torch

    if not x.is_cuda:
        raise ValueError(f"{name}: x lies on {x.device}; the phase timer is the kernel's own")
    P = len(phases)
    trace = torch.zeros((P * n + 1 + P * DETAIL,), dtype=torch.int64, device=x.device)
    launch(trace)
    t = trace.cpu()
    return t[:P * n + 1].diff().double().reshape(n, P) / 1e3, t
