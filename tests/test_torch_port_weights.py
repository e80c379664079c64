"""The port's weights blob (compiler/weights.py) and param-tree artifacts
(runtime/artifact.py) against the JAX package's: the same dict of numpy
arrays gives the same .bin and .json bytes, and each package reads the
other's files bit for bit (tolerance: none, every comparison is of bits).
"""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from lele_tpu.compiler import weights as jw
from lele_tpu.runtime import artifact as ja
from lele_tpu_torch.compiler import weights as pw
from lele_tpu_torch.params import array_to_tensor, from_numpy_tree
from lele_tpu_torch.runtime import artifact as pa

rng = np.random.default_rng(0)
ARRAYS = {
    "f32": rng.standard_normal((17, 3)).astype(np.float32),
    "f16": rng.standard_normal((4, 5)).astype(np.float16),
    "bf16": rng.standard_normal((6, 7)).astype(ml_dtypes.bfloat16),
    "i8": rng.integers(-128, 128, (33,), dtype=np.int8),
    "i64": rng.integers(-2**40, 2**40, (3, 2), dtype=np.int64),
    "u8": rng.integers(0, 255, (9,), dtype=np.uint8),
    "bool": rng.random((5,)) > 0.5,
    "0d": np.float32(3.25),
    "0d_i32": np.array(7, np.int32),
    "empty": np.zeros((0, 4), np.float32),
}


def _bits(a) -> np.ndarray:
    """A tensor or array as its raw bytes, viewed as uint8 (bf16 included)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous().reshape(-1)
        return a.view(torch.uint8).numpy() if a.numel() else np.zeros(0, np.uint8)
    return np.ascontiguousarray(a).view(np.uint8).reshape(-1)


def _same(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert tuple(port.shape) == ref.shape
    want = pw.TORCH_DTYPES[ref.dtype.name]
    assert port.dtype == want, (port.dtype, ref.dtype)
    np.testing.assert_array_equal(_bits(port).reshape(-1), _bits(ref).reshape(-1))


def _torch_params(arrays: dict) -> dict:
    return {k: array_to_tensor(v).reshape(np.shape(v)) for k, v in arrays.items()}


@pytest.mark.parametrize("name", list(ARRAYS))
def test_blob_bytes_equal_jax_and_cross_load(tmp_path, name):
    params = {name: ARRAYS[name], "other": ARRAYS["f32"]}
    jblob, jman = jw.pack_weights(params)
    pblob, pman = pw.pack_weights(params)
    tblob, tman = pw.pack_weights(_torch_params(params))
    assert pblob == jblob and pman == jman
    assert tblob == jblob and tman == jman
    jw.save_weights(tmp_path / "j", params)
    pw.save_weights(tmp_path / "p", _torch_params(params))
    for suffix in (".bin", ".json"):
        assert (tmp_path / f"p{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()
    got = pw.load_weights(tmp_path / "j")
    back = jw.load_weights(tmp_path / "p")
    for k, v in params.items():
        _same(got[k], v)
        assert back[k].dtype == np.asarray(v).dtype and back[k].shape == np.shape(v)
        np.testing.assert_array_equal(_bits(back[k]), _bits(v))


def test_blob_dedup_and_alignment_match_jax():
    a = np.arange(100, dtype=np.float32)
    params = {"x": a, "y": a.copy(), "z": a + 1, "w": ARRAYS["u8"], "v": ARRAYS["bf16"]}
    blob, man = pw.pack_weights(_torch_params(params))
    assert (blob, man) == jw.pack_weights(params)
    t = man["tensors"]
    assert t["x"]["offset"] == t["y"]["offset"] != t["z"]["offset"]
    assert all(e["offset"] % 16 == 0 for e in t.values())


def test_quantized_blob_matches_jax_both_ways(tmp_path):
    w = rng.standard_normal((64, 64)).astype(np.float32)
    w64 = rng.standard_normal((40, 30)).astype(np.float64)
    params = {"w": w, "w64": w64, "small": ARRAYS["f32"], "bf16": ARRAYS["bf16"],
              "zero": np.zeros((32, 32), np.float32)}
    assert pw.pack_weights(params, quantize=True) == jw.pack_weights(params, quantize=True)
    jw.save_weights(tmp_path / "j", params, quantize=True)
    pw.save_weights(tmp_path / "p", _torch_params(params), quantize=True)
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    got, ref = pw.load_weights(tmp_path / "j"), jw.load_weights(tmp_path / "j")
    back = jw.load_weights(tmp_path / "p")
    for k in params:
        _same(got[k], ref[k])
        np.testing.assert_array_equal(_bits(back[k]), _bits(ref[k]))
    assert got["w"].dtype == torch.float32 and got["w64"].dtype == torch.float32
    assert np.abs(got["w"].numpy() - w).max() <= np.abs(w).max() / 127.0 * 0.51


# -- JAX's tests/test_build_cli.py weights cases, on the port --------------------


def test_weights_blob_roundtrip_and_alignment(tmp_path):
    r = np.random.default_rng(1)
    params = {
        "a": r.standard_normal((17, 3)).astype(np.float32),
        "b": r.integers(0, 255, (33,)).astype(np.uint8),
        "c": r.standard_normal((4,)).astype(np.float16),
    }
    blob, manifest = pw.pack_weights(params)
    for e in manifest["tensors"].values():
        assert e["offset"] % 16 == 0
    pw.save_weights(tmp_path / "w", params)
    loaded = pw.load_weights(tmp_path / "w")
    for k in params:
        _same(loaded[k], params[k])


def test_weights_blob_bfloat16(tmp_path):
    a = torch.arange(64, dtype=torch.float32).to(torch.bfloat16)
    pw.save_weights(tmp_path / "w", {"a": a})
    loaded = pw.load_weights(tmp_path / "w")
    assert loaded["a"].dtype == torch.bfloat16 and torch.equal(loaded["a"], a)
    assert json.loads((tmp_path / "w.json").read_text())["tensors"]["a"]["dtype"] == "bfloat16"


def test_quantized_weight_blob_roundtrip(tmp_path):
    r = np.random.default_rng(3)
    w = r.standard_normal((64, 64)).astype(np.float32)
    small = r.standard_normal((8,)).astype(np.float32)
    pw.save_weights(tmp_path / "q", {"w": w, "small": small}, quantize=True)
    pw.save_weights(tmp_path / "f", {"w": w, "small": small})
    assert (tmp_path / "q.bin").stat().st_size < (tmp_path / "f.bin").stat().st_size * 0.3
    loaded = pw.load_weights(tmp_path / "q")
    np.testing.assert_array_equal(loaded["small"].numpy(), small)
    assert np.abs(loaded["w"].numpy() - w).max() <= np.abs(w).max() / 127.0 * 0.51
    assert loaded["w"].dtype == torch.float32


def test_load_weights_views_the_mapping(tmp_path):
    """Zero-copy: the loaded tensors are views of one mapping, and writing to
    one changes neither the file nor a later load (copy-on-write)."""
    params = {"a": ARRAYS["f32"], "b": ARRAYS["i64"]}
    pw.save_weights(tmp_path / "w", params)
    got = pw.load_weights(tmp_path / "w")
    assert got["a"].untyped_storage().data_ptr() == got["b"].untyped_storage().data_ptr()
    got["a"][0, 0] = 99.0
    np.testing.assert_array_equal(pw.load_weights(tmp_path / "w")["a"].numpy(), params["a"])


def test_deduplicated_entries_load_as_their_own_tensors(tmp_path):
    """Equal arrays share one record of the blob (the sha256 dedup) but load
    as tensors of their own: an in-place write to one (the generated
    wrapper's `copy_`) leaves its twin as it was, through load_weights and
    load_pytree alike; the other entries stay views of the mapping."""
    z = np.zeros((4, 3), np.float32)
    pw.save_weights(tmp_path / "w", {"a": z, "b": z.copy(), "c": ARRAYS["f32"]})
    man = json.loads(pw.json_path(tmp_path / "w").read_text())["tensors"]
    assert man["a"]["offset"] == man["b"]["offset"] != man["c"]["offset"]
    got = pw.load_weights(tmp_path / "w")
    got["a"].add_(1.0)
    np.testing.assert_array_equal(got["b"].numpy(), z)
    assert got["a"].untyped_storage().data_ptr() == got["c"].untyped_storage().data_ptr()
    assert got["b"].untyped_storage().data_ptr() != got["a"].untyped_storage().data_ptr()
    pa.save_pytree(tmp_path / "t", {"g": [np.ones(5, np.float32), np.ones(5, np.float32)]})
    tree = pa.load_pytree(tmp_path / "t", device="cpu")
    tree["g"][0].mul_(3.0)
    np.testing.assert_array_equal(tree["g"][1].numpy(), np.ones(5, np.float32))


# -- param-tree artifacts ---------------------------------------------------------


@pytest.fixture(scope="module")
def w8_tree():
    """A small SenseVoice w8a16 tree prepared by the JAX package (bf16 cast,
    int8 weights with scales, stacked layers), as numpy."""
    from lele_tpu.models import SenseVoiceConfig, SenseVoiceModel
    from lele_tpu.models.common import cast_big_params
    from lele_tpu.models.sensevoice import prepare_w8_params, stack_layer_params

    m = SenseVoiceModel(SenseVoiceConfig(n_layers=2, d_model=64, n_heads=2, ffn_dim=96,
                                         vocab_size=40, weight_int8=True))
    m.init(0)
    import jax.numpy as jnp

    tree = stack_layer_params(prepare_w8_params(cast_big_params(m.params, jnp.bfloat16)))
    return jax.tree.map(np.asarray, tree)


def test_pytree_names_and_order_equal_jax(w8_tree):
    jnames = [n for n, _, _ in ja._flatten_with_names(w8_tree)]
    pnames = [n for n, _, _ in pa._flatten_with_names(from_numpy_tree(w8_tree))]
    assert pnames == jnames and len(jnames) > 10
    jkeys = [k for _, _, k in ja._flatten_with_names(w8_tree)]
    assert [k for _, _, k in pa._flatten_with_names(w8_tree)] == jkeys
    mixed = {"b": [np.zeros(2), None, (np.ones(1), {"z": np.ones(3), "a": np.zeros(1)})],
             "a": np.arange(3), "c": None}
    assert ([(n, k) for n, _, k in pa._flatten_with_names(mixed)]
            == [(n, k) for n, _, k in ja._flatten_with_names(mixed)])


def _leaf_pairs(port_tree, ref_tree):
    return zip(jax.tree.leaves(jax.tree.map(np.asarray, ref_tree)),
               [v for _, v in pa._leaves(port_tree, [])])


def test_pytree_cross_load_both_ways(tmp_path, w8_tree):
    ja.save_pytree(tmp_path / "j", w8_tree)
    pa.save_pytree(tmp_path / "p", from_numpy_tree(w8_tree))
    for suffix in (".bin", ".json", ".tree.json"):
        assert (tmp_path / f"p{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()
    got = pa.load_pytree(tmp_path / "j", device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got, is_leaf=torch.is_tensor)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, w8_tree))
    n = 0
    for ref, port in _leaf_pairs(got, w8_tree):
        _same(port, ref)
        n += 1
    assert n == len(jax.tree.leaves(w8_tree))
    back = ja.load_pytree(tmp_path / "p", device=False)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(w8_tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_pytree_root_leaf_and_list_root(tmp_path):
    for tree in (np.arange(5, dtype=np.int32), [np.ones((2, 2), np.float32), {"k": np.zeros(3)}]):
        ja.save_pytree(tmp_path / "j", tree)
        got = pa.load_pytree(tmp_path / "j", device="cpu")
        for ref, port in _leaf_pairs(got, tree):
            _same(port, ref)
        pa.save_pytree(tmp_path / "p", tree)
        back = ja.load_pytree(tmp_path / "p", device=False)
        assert jax.tree.structure(back) == jax.tree.structure(tree)


def test_load_pytree_defaults_to_the_card(tmp_path):
    pa.save_pytree(tmp_path / "p", {"a": np.ones(2, np.float32)})
    if torch.cuda.is_available():
        assert pa.load_pytree(tmp_path / "p")["a"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            pa.load_pytree(tmp_path / "p")
