"""The port's native host module (counterpart of
lele_tpu/runtime/native/__init__.py and its native.cpp).

`csrc/native.cpp` is plain C++ with a C interface, built with `g++` by
kernels/_build.py (the `native` stem: a temporary file moved into place,
so a concurrent build never exposes a half-written library) and loaded with
ctypes, which releases the GIL for each call. `get_native()` builds it at
first use and returns its functions; a failed build raises with the
compiler's output (the JAX package returns None and falls back silently).

- `decode_wav(bytes)` → (float32 mono samples as bytes, sample rate), the
  same samples as the Python parser (utils/wav.decode_wav_bytes with
  `try_native=False`);
- `decode_wav_files(paths)` → [(bytes, rate), ...], the files read and
  decoded on a pool of C++ threads; ValueError naming the first file that
  fails (`MissingFile`, also a FileNotFoundError, where it does not exist);
- `content_hash(bytes)` → int, FNV-1a 64;
- `scan_initializers(bytes)` → [(name, onnx dtype, dims, raw_data offset,
  raw_data length)] of a ModelProto's graph initializers (offset -1 without
  raw_data); ValueError for a malformed protobuf.
"""

from __future__ import annotations

import ctypes
import errno
import os
import struct
from pathlib import Path
from typing import Sequence

_STEM = "native"


class MissingFile(FileNotFoundError, ValueError):
    """A path of `decode_wav_files` that does not exist: a FileNotFoundError,
    as the Python reader raises, and a ValueError, as the JAX package's
    native loader raises."""


_ERRLEN = 512
_native = None


class Native:
    """The loaded library's functions, with the JAX module's signatures."""

    def __init__(self, lib: ctypes.CDLL):
        P, S = ctypes.c_void_p, ctypes.c_size_t
        self._lib = lib
        lib.lele_free.argtypes = [P]
        lib.lele_free.restype = None
        lib.lele_decode_wav.argtypes = [ctypes.c_char_p, S, ctypes.POINTER(P),
                                        ctypes.POINTER(S), ctypes.POINTER(ctypes.c_uint32),
                                        ctypes.c_char_p, S]
        lib.lele_decode_wav.restype = ctypes.c_int
        lib.lele_decode_wav_files.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                              ctypes.c_longlong, ctypes.c_int, P, P, P,
                                              ctypes.c_char_p, S]
        lib.lele_decode_wav_files.restype = ctypes.c_longlong
        lib.lele_content_hash.argtypes = [ctypes.c_char_p, S]
        lib.lele_content_hash.restype = ctypes.c_uint64
        lib.lele_scan_initializers.argtypes = [ctypes.c_char_p, S, ctypes.POINTER(P),
                                               ctypes.POINTER(S)]
        lib.lele_scan_initializers.restype = ctypes.c_longlong

    def _take(self, ptr: int, n: int) -> bytes:
        try:
            return ctypes.string_at(ptr, n)
        finally:
            self._lib.lele_free(ptr)

    def decode_wav(self, data: bytes) -> tuple[bytes, int]:
        data = bytes(data)
        out, n, sr = ctypes.c_void_p(), ctypes.c_size_t(), ctypes.c_uint32()
        err = ctypes.create_string_buffer(_ERRLEN)
        code = self._lib.lele_decode_wav(data, len(data), ctypes.byref(out), ctypes.byref(n),
                                         ctypes.byref(sr), err, _ERRLEN)
        if code:
            raise ValueError(err.value.decode(errors="replace") or f"decode_wav: code {code}")
        return self._take(out.value, 4 * n.value), int(sr.value)

    def decode_wav_files(self, paths: Sequence[str | Path],
                         n_threads: int | None = None) -> list[tuple[bytes, int]]:
        names = [os.fsencode(str(p)) for p in paths]
        n = len(names)
        if n == 0:
            return []
        threads = n_threads or min(16, os.cpu_count() or 2)
        c_names = (ctypes.c_char_p * n)(*names)
        outs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_size_t * n)()
        srs = (ctypes.c_uint32 * n)()
        err = ctypes.create_string_buffer(_ERRLEN)
        bad = self._lib.lele_decode_wav_files(c_names, n, threads, outs, lens, srs, err,
                                              _ERRLEN)
        if bad >= 0:
            msg = err.value.decode(errors="replace")
            if not os.path.exists(names[bad]):
                raise MissingFile(errno.ENOENT, msg, os.fsdecode(names[bad]))
            raise ValueError(msg)
        return [(self._take(outs[i], 4 * lens[i]), int(srs[i])) for i in range(n)]

    def content_hash(self, data: bytes) -> int:
        data = bytes(data)
        return int(self._lib.lele_content_hash(data, len(data)))

    def scan_initializers(self, data: bytes) -> list[tuple]:
        data = bytes(data)
        out, size = ctypes.c_void_p(), ctypes.c_size_t()
        n = self._lib.lele_scan_initializers(data, len(data), ctypes.byref(out),
                                             ctypes.byref(size))
        if n < 0:
            raise ValueError("malformed protobuf")
        rec = self._take(out.value, size.value)
        metas, pos = [], 0
        for _ in range(n):
            (nl,) = struct.unpack_from("<I", rec, pos)
            name = rec[pos + 4:pos + 4 + nl].decode()
            pos += 4 + nl
            dtype, nd = struct.unpack_from("<iI", rec, pos)
            pos += 8
            dims = struct.unpack_from(f"<{nd}q", rec, pos)
            pos += 8 * nd
            off, ln = struct.unpack_from("<qq", rec, pos)
            pos += 16
            metas.append((name, dtype, tuple(dims), off, ln))
        return metas


def get_native() -> Native:
    """The native module, built at first use; raises RuntimeError with the
    compiler's output where it does not build."""
    global _native
    if _native is None:
        from ..kernels import _build

        _native = Native(_build.library(_STEM))
    return _native
