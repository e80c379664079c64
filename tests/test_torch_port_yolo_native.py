"""The port's native YOLO26 (`models/yolo26.py`) and `serving.Yolo26Engine`
against the JAX package's, on JAX's weights carried across
(`yolo26_params_from_jax`) and the same numpy images, at the small config
of tests/test_models.py:159-191 (img 128, widths 8/16/32/64: an 8x8 grid of
cells, stride 16).

- f32: the selected cells are JAX's, every output within 1e-4 (rtol and
  atol, JAX's own gate between its s2d and plain paths,
  tests/test_s2d.py:79-106), against JAX's model with its "s2d" params (its
  TPU fast path, taken where the image size is a multiple of 4) and
  without. JAX's selected cells are read back by matching each output row
  of scores to the port's per-cell class logits (distinct random vectors).
- bf16: both sides round the conv operands to bf16 in their own orders and
  the random head's logits are ~1e-2, so the order of near-equal cells
  differs; every cell is selected (64 <= 300), so rows are matched by cell
  and compared at 2e-2 of the largest magnitude.
- A tie (zero class weights, equal biases) selects cells 0, 1, 2, ... on both
  sides; img 136 takes XLA's asymmetric SAME split at even and odd sizes
  (68 → 34 → 17 → 9).
"""

import io

import jax
import numpy as np
import pytest
import torch

from lele_tpu.models import Yolo26Config as JConfig
from lele_tpu.models import Yolo26Model as JModel
from lele_tpu.serving import Yolo26Engine as JEngine
from lele_tpu_torch.models import Yolo26Config, Yolo26Model, yolo26_params_from_jax
from lele_tpu_torch.models.yolo26 import (init_yolo26, query_indices, yolo26_forward,
                                          yolo26_head_maps)
from lele_tpu_torch.params import tree_map
from lele_tpu_torch.serving import Yolo26Engine

SMALL = dict(img_size=128, widths=(8, 16, 32, 64))
F32_TOL = 1e-4
BF16_REL = 2e-2
_RNG = np.random.default_rng(2033)


def _pair(seg=False, dtype="float32", seed=0, **kw):
    """(JAX model with its init's params, the port's model on them)."""
    jcfg = JConfig(**{**SMALL, **kw}, dtype=dtype, segmentation=seg)
    jm = JModel(jcfg)
    jm.init(seed)
    cfg = Yolo26Config(**{**SMALL, **kw}, dtype=dtype, segmentation=seg)
    pm = Yolo26Model(cfg, params=yolo26_params_from_jax(jax.tree.map(np.asarray, jm.params)),
                     device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(seg=False, dtype="float32"):
        if (seg, dtype) not in cache:
            cache[seg, dtype] = _pair(seg, dtype)
        return cache[seg, dtype]

    return get


def _image(b, form, size=128):
    u8 = _RNG.integers(0, 256, (b, size, size, 3)).astype(np.uint8)
    img = u8 if form.startswith("u8") else _RNG.random((b, size, size, 3)).astype(np.float32)
    return np.ascontiguousarray(img.transpose(0, 3, 1, 2)) if form.endswith("chw") else img


def _run_jax(jm, params, img):
    return [np.asarray(o) for o in jax.jit(jm.forward_fn())(params, img)]


def _run_port(pm, img):
    outs = [o.numpy() for o in pm.forward_fn()(pm.params, img)]
    maps = yolo26_head_maps(pm.params, torch.from_numpy(img), pm.cfg)
    return outs, maps, query_indices(maps["cls"], pm.cfg.n_queries).numpy()


def _jax_cells(j_scores, maps):
    """JAX's selected cell of each output row: the cell whose class logits
    (the port's) lie nearest that row's scores."""
    cls = maps["cls"].flatten(1, 2).numpy()  # [B, cells, C]
    d = ((j_scores[:, :, None, :] - cls[:, None, :, :]) ** 2).sum(-1)
    return d.argmin(-1)


def _assert_f32(pm, jm, params, img):
    got, maps, idx = _run_port(pm, img)
    want = _run_jax(jm, params, img)
    assert len(got) == len(want) == (4 if pm.cfg.segmentation else 2)
    np.testing.assert_array_equal(idx, _jax_cells(want[0], maps))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    return got, idx


@pytest.mark.parametrize("form", ["f32_nhwc", "u8_nhwc", "f32_chw", "u8_chw"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("seg", [False, True], ids=["detect", "seg"])
def test_native_f32_matches_jax(models, seg, b, form):
    jm, pm = models(seg)
    assert "s2d" in jm.params  # JAX's init prepared its TPU fast path
    got, _ = _assert_f32(pm, jm, jm.params, _image(b, form))
    assert got[0].shape == (b, 64, 80) and got[1].shape == (b, 64, 4)
    if seg:
        assert got[2].shape == (b, 64, 32) and got[3].shape == (b, 16, 16, 32)


@pytest.mark.parametrize("seg", [False, True], ids=["detect", "seg"])
def test_native_f32_matches_jax_plain_path(models, seg):
    jm, pm = models(seg)
    plain = {k: v for k, v in jm.params.items() if k != "s2d"}
    _assert_f32(pm, jm, plain, _image(2, "u8_nhwc"))


@pytest.mark.parametrize("b,form", [(1, "u8_nhwc"), (2, "f32_chw")])
@pytest.mark.parametrize("seg", [False, True], ids=["detect", "seg"])
def test_native_bf16_matches_jax(models, seg, b, form):
    jm, pm = models(seg, "bfloat16")
    img = _image(b, form)
    got, maps, idx = _run_port(pm, img)
    want = _run_jax(jm, jm.params, img)
    cells = _jax_cells(want[0], maps)
    assert idx.shape == cells.shape == (b, 64)
    for r in range(b):  # every cell selected on both sides
        assert sorted(idx[r]) == sorted(cells[r]) == list(range(64))
    rows = np.argsort(idx, axis=1)  # the port's row of each cell
    jrows = np.argsort(cells, axis=1)
    for g, w in zip(got[:3], want[:3]):
        g = np.take_along_axis(g, rows[..., None], axis=1)
        w = np.take_along_axis(np.asarray(w, np.float32), jrows[..., None], axis=1)
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_REL * np.abs(w).max())
    if seg:
        np.testing.assert_allclose(got[3], want[3], rtol=0,
                                   atol=BF16_REL * np.abs(want[3]).max())


def test_native_selects_fewer_queries_than_cells():
    jm, pm = _pair(n_queries=16, seed=3)
    got, idx = _assert_f32(pm, jm, jm.params, _image(2, "u8_nhwc"))
    assert idx.shape == (2, 16) and got[0].shape == (2, 16, 80)


@pytest.mark.parametrize("seg", [False, True], ids=["detect", "seg"])
def test_native_odd_map_sizes(seg):
    """img 136: XLA's SAME pads (0, 1) at the even sizes 136, 68, 34 and (1, 1)
    at 17, so maps go 68 → 34 → 17 → 9 (81 cells)."""
    jm, pm = _pair(seg, img_size=136, seed=4)
    maps = yolo26_head_maps(pm.params, torch.from_numpy(_image(1, "u8_nhwc", 136)), pm.cfg)
    assert tuple(maps["cls"].shape) == (1, 9, 9, 80)
    plain = {k: v for k, v in jm.params.items() if k != "s2d"}
    for params in (plain, jm.params):
        _assert_f32(pm, jm, params, _image(2, "f32_nhwc", 136))


def test_native_tie_selects_lower_cells_first():
    """Zero class weights and equal biases: every cell's confidence is the
    same; lax.top_k and the port's stable sort both take cells 0, 1, 2, ...
    JAX's cells are read from its boxes (zero box head: centers on the
    cells)."""
    jm, pm = _pair(n_queries=16, seed=5)
    params = dict(jm.params)
    params["head_cls"] = {"w": np.zeros_like(params["head_cls"]["w"]),
                          "b": np.full_like(params["head_cls"]["b"], 0.25)}
    params["head_box"] = {"w": np.zeros_like(params["head_box"]["w"]),
                          "b": np.zeros_like(params["head_box"]["b"])}
    img = _image(2, "u8_nhwc")
    want = _run_jax(jm, params, img)
    stride = 16
    cx, cy = want[1][..., 0] / stride - 0.5, want[1][..., 1] / stride - 0.5
    np.testing.assert_array_equal(cy * 8 + cx, np.tile(np.arange(16.0), (2, 1)))
    port = yolo26_params_from_jax(jax.tree.map(np.asarray, params))
    maps = yolo26_head_maps(port, torch.from_numpy(img), pm.cfg)
    np.testing.assert_array_equal(query_indices(maps["cls"], 16).numpy(),
                                  np.tile(np.arange(16), (2, 1)))
    got = [o.numpy() for o in yolo26_forward(port, torch.from_numpy(img), pm.cfg)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("seg", [False, True], ids=["detect", "seg"])
def test_init_matches_jax_tree(seg):
    """The port's init gives JAX's tree: the same leaves and shapes, weights
    uniform within ±1/sqrt(fan-in), zero biases."""
    jm, _ = _pair(seg)
    cfg = Yolo26Config(**SMALL, segmentation=seg)
    gen = torch.Generator().manual_seed(0)
    ours = init_yolo26(gen, cfg)
    want = {k: v for k, v in jm.params.items() if k != "s2d"}
    assert tree_map(lambda t: tuple(t.shape), ours) == tree_map(lambda a: a.shape, want)
    leaves = []
    tree_map(leaves.append, ours)
    for p in leaves:
        if p.dim() == 1:
            assert not p.any()
        else:
            assert p.abs().max() <= 1.0 / np.sqrt(np.prod(p.shape[1:]))


def test_native_refuses_packed_input():
    _, pm = _pair()
    with pytest.raises(ValueError, match="48-channel"):
        pm.forward_fn()(pm.params, np.zeros((1, 32, 32, 48), np.float32))


# -- Yolo26Engine ------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    jm, pm = _pair(seed=7)
    return JEngine(model=jm, conf_threshold=0.0), Yolo26Engine(model=pm, conf_threshold=0.0)


def _assert_same_detections(got, want, tol=1e-5):
    assert len(got) == len(want) > 0
    by_anchor = {d["anchor"]: d for d in want}
    assert {d["anchor"] for d in got} == set(by_anchor)
    for d in got:
        w = by_anchor[d["anchor"]]
        assert d["class_id"] == w["class_id"]
        assert abs(d["score"] - w["score"]) <= tol
        np.testing.assert_allclose(d["xyxy"], w["xyxy"], rtol=0, atol=F32_TOL)
    assert [d["score"] for d in got] == sorted((d["score"] for d in got), reverse=True)


def test_engine_detect_matches_jax(engines):
    j_eng, eng = engines
    img = _RNG.integers(0, 255, (240, 320, 3)).astype(np.uint8)
    _assert_same_detections(eng.detect(img), j_eng.detect(img))
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG")
    _assert_same_detections(eng.detect(buf.getvalue()), j_eng.detect(buf.getvalue()))


def test_engine_empty_batch(engines):
    assert engines[1].detect_batch([]) == [] == engines[0].detect_batch([])


def test_engine_batch_matches_singles_and_jax(engines):
    """A batch of 3 rides the B = 4 forward: each image's detections are its
    single call's, and JAX's batch's."""
    j_eng, eng = engines
    imgs = [_RNG.integers(0, 255, (200 + 8 * i, 320, 3)).astype(np.uint8) for i in range(3)]
    batch = eng.detect_batch(imgs)
    assert len(batch) == 3
    for b, im, w in zip(batch, imgs, j_eng.detect_batch(imgs)):
        _assert_same_detections(b, eng.detect(im), tol=1e-6)
        _assert_same_detections(b, w)
