"""The port's native host module (runtime/native.py, csrc/native.cpp)
against the JAX package's Python parser and loader: JAX's
tests/test_native.py:17-206 on the port (its `pack_s2d_u8` cases are a TPU
lane layout with no counterpart: ROADMAP §3), every native result held to
the JAX package's pure-Python reference bit for bit, plus each WAV form the
parsers take, the scan of every fixture, the build race and a failed build.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lele_tpu.onnx import OnnxModel as JOnnxModel
from lele_tpu.onnx.loader import DTYPE_MAP
from lele_tpu.utils.wav import decode_wav_bytes as j_decode
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.runtime.native import get_native

REPO = Path(__file__).resolve().parents[1]
nat = get_native()


def _jax_parse(data: bytes):
    return j_decode(data, try_native=False)


def _model(arrays):
    return ob.build_model_bytes(
        [ob.node("Identity", ["x"], ["y"])], inputs=[ob.value_info("x", 1, [1])],
        outputs=[ob.value_info("y", 1, [1])],
        initializers=[ob.tensor_from_array(v, k) for k, v in arrays.items()])


def test_scan_initializers_matches_python_loader():
    rng = np.random.default_rng(0)
    arrays = {"wf": rng.standard_normal((17, 5)).astype(np.float32),
              "wi": rng.integers(0, 100, (9,)).astype(np.int64),
              "wb": rng.integers(0, 255, (33,)).astype(np.uint8)}
    bs = _model(arrays)
    metas = nat.scan_initializers(bs)
    assert {m[0] for m in metas} == set(arrays)
    m = JOnnxModel.from_bytes(bs)
    for name, dtype, dims, off, ln in metas:
        view = np.frombuffer(bs[off:off + ln], dtype=DTYPE_MAP[dtype]).reshape(dims)
        np.testing.assert_array_equal(view, arrays[name])
        np.testing.assert_array_equal(view, m.initializer_array(name))


@pytest.mark.parametrize("fixture", sorted(p.name for p in (REPO / "fixtures").glob("*.onnx")))
def test_scan_of_each_fixture_matches_both_loaders(fixture):
    from lele_tpu_torch.onnx import OnnxModel

    bs = (REPO / "fixtures" / fixture).read_bytes()
    metas = nat.scan_initializers(bs)
    jm, pm = JOnnxModel.from_bytes(bs), OnnxModel.from_bytes(bs)
    raw = [m for m in metas if m[3] >= 0]
    assert raw
    for name, dtype, dims, off, ln in raw:
        view = np.frombuffer(bs[off:off + ln], dtype=DTYPE_MAP[dtype]).reshape(dims)
        np.testing.assert_array_equal(view, jm.initializer_array(name))
        np.testing.assert_array_equal(view, np.asarray(pm.initializer_array(name)))


def test_scan_rejects_garbage():
    with pytest.raises(ValueError):
        nat.scan_initializers(b"\xff\xff\xff\xff not a proto")


def test_scan_rejects_truncated_model():
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    bs = _model({"weight_with_a_long_name": w})
    for cut in [5, 10, 20, len(bs) // 2, len(bs) - 7, len(bs) - 1]:
        try:
            metas = nat.scan_initializers(bs[:cut])
        except ValueError:
            continue
        for _name, _dt, _dims, off, ln in metas:
            assert off + ln <= cut


def test_scan_rejects_oversized_raw_data_claim():
    w = np.ones(16, dtype=np.float32)
    bs = bytearray(_model({"w": w}))
    idx = bytes(bs).find(w.tobytes())
    assert idx > 0 and bs[idx - 1] == 64
    bs[idx - 1] = 0x7F  # claims 127 bytes; 64 remain
    with pytest.raises(ValueError):
        nat.scan_initializers(bytes(bs[:idx + 64]))


def _riff(fmt_code, channels, sr, bits, samples: bytes, extensible=False):
    block = channels * bits // 8
    if extensible:
        body = struct.pack("<HHIIHHHHI", 0xFFFE, channels, sr, sr * block, block, bits, 22,
                           bits, 0) + struct.pack("<H", fmt_code) + bytes(14)
    else:
        body = struct.pack("<HHIIHH", fmt_code, channels, sr, sr * block, block, bits)
    chunks = b"fmt " + struct.pack("<I", len(body)) + body
    chunks += b"LIST" + struct.pack("<I", 3) + b"abc\x00"  # an odd chunk, padded
    chunks += b"data" + struct.pack("<I", len(samples)) + samples
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _forms():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, 600)
    i16 = (x * 32767).astype("<i2").tobytes()
    return {
        "pcm16_mono": _riff(1, 1, 16000, 16, i16),
        "pcm16_stereo": _riff(1, 2, 8000, 16, i16),
        "pcm16_quad": _riff(1, 4, 8000, 16, i16),
        "pcm8": _riff(1, 1, 16000, 8, (x * 127 + 128).astype(np.uint8).tobytes()),
        "pcm24_stereo": _riff(1, 2, 22050, 24, b"".join(
            int(v).to_bytes(3, "little", signed=True) for v in (x * 2**23 * 0.99).astype(np.int64))),
        "pcm32": _riff(1, 1, 44100, 32, (x * 2**31 * 0.99).astype("<i4").tobytes()),
        "float32": _riff(3, 1, 16000, 32, x.astype("<f4").tobytes()),
        "float64_stereo": _riff(3, 2, 16000, 64, x.astype("<f8").tobytes()),
        "extensible_float": _riff(3, 1, 16000, 32, x.astype("<f4").tobytes(), extensible=True),
        "extensible_pcm24": _riff(1, 3, 48000, 24, b"".join(
            int(v).to_bytes(3, "little", signed=True) for v in (x * 2**22).astype(np.int64)),
            extensible=True),
    }


@pytest.mark.parametrize("form", list(_forms()))
def test_wav_forms_match_jaxs_python_parser(form):
    from lele_tpu_torch.utils.wav import decode_wav_bytes

    data = _forms()[form]
    raw, sr = nat.decode_wav(data)
    want, wsr = _jax_parse(data)
    assert sr == wsr
    np.testing.assert_array_equal(np.frombuffer(raw, np.float32), want)
    got, gsr = decode_wav_bytes(data)  # try_native=True: the native decoder
    py, psr = decode_wav_bytes(data, try_native=False)
    assert gsr == psr == wsr and got.dtype == py.dtype == np.float32
    np.testing.assert_array_equal(got, py)


def test_wav_decode_parity_16bit_stereo():
    sr, n = 16000, 500
    left = (np.sin(np.arange(n) / 5) * 0.5 * 32767).astype("<i2")
    right = (np.cos(np.arange(n) / 5) * 0.5 * 32767).astype("<i2")
    inter = np.empty(n * 2, "<i2")
    inter[0::2], inter[1::2] = left, right
    pcm = inter.tobytes()
    data = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, sr, sr * 4, 4, 16)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)
    raw, got_sr = nat.decode_wav(data)
    y = np.frombuffer(raw, np.float32)
    assert got_sr == sr and len(y) == n
    np.testing.assert_allclose(y, (left.astype(np.float64) + right) / 2 / 32768.0, atol=1e-6)
    np.testing.assert_array_equal(y, _jax_parse(data)[0])


def _f32_wav(x, size=None, sr=8000):
    pcm = x.tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, sr, sr * 4, 4, 32)
            + b"data" + struct.pack("<I", len(pcm) if size is None else size) + pcm)


def test_wav_decode_float32():
    x = np.linspace(-1, 1, 256).astype(np.float32)
    raw, sr = nat.decode_wav(_f32_wav(x))
    assert sr == 8000
    np.testing.assert_array_equal(np.frombuffer(raw, np.float32), x)


def test_wav_decode_garbage_raises():
    with pytest.raises(ValueError):
        nat.decode_wav(b"definitely not a wav file" * 10)
    with pytest.raises(ValueError):
        _jax_parse(b"definitely not a wav file" * 10)


def test_wav_decode_truncated_fmt_raises():
    blob = (b"RIFF" + struct.pack("<I", 100) + b"WAVE" + b"fmt " + struct.pack("<I", 16)
            + b"\x01\x00\x02\x00")  # claims a 16-byte body, gives 4
    with pytest.raises(ValueError):
        nat.decode_wav(blob)


def test_wav_decode_truncated_data_clamps():
    x = np.linspace(-1, 1, 64).astype(np.float32)
    data = _f32_wav(x, size=4 * 4 * 64)  # claims four times what is there
    raw, _ = nat.decode_wav(data)
    np.testing.assert_array_equal(np.frombuffer(raw, np.float32), x)
    np.testing.assert_array_equal(_jax_parse(data)[0], x)


def test_read_wav_uses_native_and_matches_python(tmp_path):
    from lele_tpu_torch.utils import wav as wav_mod

    x = (np.sin(np.arange(2000) / 9) * 0.7).astype(np.float32)
    wav_mod.write_wav(tmp_path / "t.wav", x, 22050)
    y, sr = wav_mod.read_wav(tmp_path / "t.wav")
    assert sr == 22050
    np.testing.assert_allclose(y, x, atol=1e-3)
    np.testing.assert_array_equal(y, _jax_parse((tmp_path / "t.wav").read_bytes())[0])
    with pytest.raises(ValueError, match="t.bad"):
        wav_mod.decode_wav_bytes(b"RIFFxxxxWAVE" + b"\x00" * 8, label="t.bad")


def _fnv1a(data: bytes) -> int:
    h = 1469598103934665603
    for b in data:
        h = ((h ^ b) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def test_content_hash_stable():
    h1, h2, h3 = nat.content_hash(b"abc"), nat.content_hash(b"abc"), nat.content_hash(b"abd")
    assert h1 == h2 != h3
    for data in (b"", b"abc", bytes(range(256)) * 3):
        assert nat.content_hash(data) == _fnv1a(data)


def _encoded(tmp_path, n, seed, base=4000, step=321):
    from lele_tpu.serving import encode_wav

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        pcm = (rng.standard_normal(base + step * i) * 0.2).astype(np.float32)
        p = tmp_path / f"a{i:02d}.wav"
        p.write_bytes(encode_wav(pcm, 16000))
        paths.append(p)
    return paths


def test_decode_wav_files_threaded_batch(tmp_path):
    from lele_tpu_torch.runtime.dataloader import decode_wav_files

    paths = _encoded(tmp_path, 12, 5)
    got = decode_wav_files(paths)
    assert len(got) == 12
    for p, (pcm, sr) in zip(paths, got):
        want, wsr = _jax_parse(p.read_bytes())
        assert sr == wsr
        np.testing.assert_array_equal(pcm, np.asarray(want, np.float32))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFFxxxxWAVE" + b"\x00" * 8)
    with pytest.raises(ValueError, match="bad.wav"):
        decode_wav_files([paths[0], bad])
    with pytest.raises(ValueError, match="missing.wav"):
        decode_wav_files([tmp_path / "missing.wav"])
    with pytest.raises(FileNotFoundError):
        decode_wav_files([paths[1], tmp_path / "missing.wav"])
    assert decode_wav_files([]) == []


def test_wav_batch_loader_prefetch_order(tmp_path):
    from lele_tpu_torch.runtime.dataloader import WavBatchLoader

    paths = _encoded(tmp_path, 7, 6, base=1000, step=1)
    loader = WavBatchLoader(paths, batch_size=3)
    assert len(loader) == 3
    batches = list(loader)
    assert [len(b) for b in batches] == [3, 3, 1]
    assert [len(p) for b in batches for p, _ in b] == [1000 + i for i in range(7)]
    with pytest.raises(ValueError):
        list(WavBatchLoader([paths[0], tmp_path / "nope.wav"], batch_size=1))


def test_concurrent_builds_into_one_cache_both_load(tmp_path):
    """Two processes building the native module into one empty cache at once
    both load a whole library: each compiler writes a file of its own that
    os.replace moves into place."""
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
            "from lele_tpu_torch.runtime import enable_cache\n"
            "from lele_tpu_torch.runtime.native import get_native\n"
            f"enable_cache({str(tmp_path / 'cache')!r})\n"
            "print(get_native().content_hash(b'abc'))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e[-1500:] for _, e in outs]
    assert {o.strip() for o, _ in outs} == {str(_fnv1a(b"abc"))}
    libs = sorted(f.name for f in (tmp_path / "cache").iterdir())
    assert len(libs) == 1 and libs[0].startswith("libnative-") and libs[0].endswith(".so")


def test_a_failed_build_raises_with_the_compilers_output(tmp_path):
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
            "from lele_tpu_torch.runtime import enable_cache\n"
            "from lele_tpu_torch.utils.wav import decode_wav_bytes\n"
            f"enable_cache({str(tmp_path / 'cache')!r})\n"
            "try:\n"
            "    decode_wav_bytes(b'RIFF')\n"
            "except RuntimeError as e:\n"
            "    print('RAISED', 'native.cpp' in str(e), 'no compiler here' in str(e))\n")
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    cxx.chmod(0o755)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env={**os.environ, "CXX": str(cxx)})
    assert r.returncode == 0, r.stderr[-1500:]
    assert "RAISED True True" in r.stdout, r.stdout
    assert not any((tmp_path / "cache").iterdir())  # no half-written library left
