"""Build and load the hand-written CUDA kernels (`lele_tpu_torch/csrc/*.cu`)
and the host C++ source (`csrc/native.cpp`, runtime/native.py).

Each source becomes one shared library with a plain C interface, compiled at
first use into `BUILD_DIR` (by default `lele_tpu_torch/_build/`, which git
ignores; runtime/cache.enable_cache points it elsewhere) and loaded with
`ctypes`: a `.cu` by `nvcc` for Hopper (`sm_90a`), a `.cpp` by `g++`. Each
compiler writes a temporary file that `os.replace` moves into place, so a
process never loads a half-written library. The file name carries a hash of
the source (and, for CUDA, the shared headers and flags), so an edited
source is rebuilt and a stale library is never loaded. `build()` starts one
compiler per source, all at once, and records each stem it compiled in this
process in `BUILT`. `provide({stem: path})` hands over libraries built
elsewhere (an AOT bundle's, runtime/artifact.py), which `library` then
loads instead of building. Nothing here runs when the module is imported.

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
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
DEFAULT_BUILD_DIR = _PKG / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_provided: dict[str, Path] = {}
BUILT: list[str] = []  # the stems compiled in this process, in order


def sources() -> list[str]:
    """Stems of every kernel source, e.g. ["sanm_layer", "w8_gemm"]."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _source(stem: str) -> Path:
    cu = CSRC / f"{stem}.cu"
    return cu if cu.exists() else CSRC / f"{stem}.cpp"


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


def lib_name(stem: str) -> str:
    """The library's file name: lib<stem>-<hash of its source>.so."""
    src = _source(stem)
    h = hashlib.sha1(src.read_bytes())
    if src.suffix == ".cu":
        for hdr in sorted(CSRC.glob("*.cuh")):
            h.update(hdr.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    else:
        h.update(" ".join(CXX_FLAGS).encode())
    return f"lib{stem}-{h.hexdigest()[:12]}.so"


def _lib_path(stem: str) -> Path:
    return BUILD_DIR / lib_name(stem)


def library_path(stem: str) -> Path:
    """Where the library is loaded from: a provided one, else BUILD_DIR's."""
    return _provided.get(stem) or _lib_path(stem)


def provide(libs: dict[str, str | Path]) -> None:
    """Load these libraries, built elsewhere, instead of building: each
    file's name must be this checkout's `lib_name` of its stem (the same
    source), else ValueError."""
    for stem, path in libs.items():
        path = Path(path)
        if path.name != lib_name(stem) or not path.is_file():
            raise ValueError(f"{path}: not a library of this checkout's {_source(stem).name} "
                             f"(wants {lib_name(stem)})")
    for stem, path in libs.items():
        _provided[stem] = Path(path)


def _compile_cmd(stem: str, tmp: Path, extra_flags) -> list[str]:
    src = _source(stem)
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, *extra_flags, "-I", str(CSRC), "-o", str(tmp), str(src)]
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {src.name} builds with the host C++ compiler")
    return [cxx, *CXX_FLAGS, *extra_flags, "-o", str(tmp), str(src)]


def build(stems: list[str] | None = None, extra_flags: tuple[str, ...] = ()
          ) -> dict[str, str]:
    """Compile the libraries that are missing (or provided), one compiler
    per source in parallel. Returns each compiler's output (stderr), keyed
    by stem; raises with the output of each compilation that fails."""
    stems = sources() if stems is None else stems
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in stems:
        out = _lib_path(stem)
        if not extra_flags and (stem in _provided or out.exists()):
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        procs[stem] = (subprocess.Popen(_compile_cmd(stem, tmp, extra_flags),
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[stem] = log
        if proc.returncode != 0:
            failed.append(f"{_source(stem).name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            BUILT.append(stem)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return logs


def library(stem: str) -> ctypes.CDLL:
    """The loaded library for csrc/<stem>.cu (or .cpp), built first if
    missing."""
    lib = _libs.get(stem)
    if lib is None:
        with _lock:
            lib = _libs.get(stem)
            if lib is None:
                path = library_path(stem)
                if not path.exists():
                    build([stem])
                lib = ctypes.CDLL(str(path))
                if hasattr(lib, "lele_error_string"):
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
