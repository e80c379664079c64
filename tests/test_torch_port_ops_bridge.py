"""PyTorch-exported CNN graphs through the port (the JAX package's bridge
suite, tests/test_torch_onnx.py:40, 231, 270, 292, 310, 326): a CNN with BN
and pooling, a resnet-style classifier, a U-Net decoder with ConvTranspose2d,
a wav2vec front-end with GroupNorm, PixelShuffle and nearest interpolation.

Each module, as JAX's suite writes it, goes through torch.onnx.export
(TorchScript, `lele_tpu_torch.onnx.torch_shim` as the `onnx` module) at
opsets 11, 13 and 17, and the bytes through the port's compile_model on the
CPU: held to torch's own outputs and to JAX's compile_model on the same
bytes at the suite's TOL (atol 5e-5, rtol 1e-4). chip_smoke phase 36's
ResNet-50 builder at a small width runs through both packages too.
"""

import io
import sys
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx import torch_shim

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ATOL, RTOL = 5e-5, 1e-4  # tests/test_torch_onnx.py:23, :34


class CnnBnPool(nn.Module):  # tests/test_torch_onnx.py:40
    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv2d(3, 8, 3, padding=1)
        self.bn = nn.BatchNorm2d(8)
        self.c2 = nn.Conv2d(8, 16, 3, stride=2, padding=1)
        self.fc = nn.Linear(16 * 8 * 8, 10)

    def forward(self, x):
        h = torch.relu(self.bn(self.c1(x)))
        h = torch.relu(self.c2(h))
        return torch.softmax(self.fc(h.flatten(1)), -1)


class Block(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.c1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.b1 = nn.BatchNorm2d(cout)
        self.c2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.b2 = nn.BatchNorm2d(cout)
        self.down = (nn.Conv2d(cin, cout, 1, stride=stride, bias=False)
                     if stride != 1 or cin != cout else None)

    def forward(self, x):
        h = torch.relu(self.b1(self.c1(x)))
        h = self.b2(self.c2(h))
        s = self.down(x) if self.down is not None else x
        return torch.relu(h + s)


class ResnetStyle(nn.Module):  # tests/test_torch_onnx.py:231
    def __init__(self):
        super().__init__()
        self.stem = nn.Conv2d(3, 8, 7, stride=2, padding=3, bias=False)
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)
        self.b1 = Block(8, 8)
        self.b2 = Block(8, 16, stride=2)
        self.fc = nn.Linear(16, 10)

    def forward(self, x):
        h = self.pool(torch.relu(self.stem(x)))
        h = self.b2(self.b1(h))
        return self.fc(h.mean(dim=(2, 3)))


class UnetDecoder(nn.Module):  # tests/test_torch_onnx.py:270
    def __init__(self):
        super().__init__()
        self.down = nn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.mid = nn.Conv2d(8, 8, 3, padding=1)
        self.up = nn.ConvTranspose2d(8, 4, 4, stride=2, padding=1)
        self.out = nn.Conv2d(4 + 3, 2, 1)

    def forward(self, x):
        d = torch.relu(self.down(x))
        m = torch.relu(self.mid(d))
        u = torch.relu(self.up(m))
        return self.out(torch.cat([u, x], dim=1))


class Wav2vecFrontend(nn.Module):  # tests/test_torch_onnx.py:292
    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv1d(1, 16, 10, stride=5)
        self.gn = nn.GroupNorm(4, 16)
        self.c2 = nn.Conv1d(16, 16, 3, stride=2)

    def forward(self, x):
        h = nn.functional.gelu(self.gn(self.c1(x)))
        return nn.functional.gelu(self.c2(h))


class PixelShuffleUp(nn.Module):  # tests/test_torch_onnx.py:310
    def __init__(self):
        super().__init__()
        self.c = nn.Conv2d(3, 12, 3, padding=1)
        self.ps = nn.PixelShuffle(2)

    def forward(self, x):
        return self.ps(self.c(x))


class InterpolateNearest(nn.Module):  # tests/test_torch_onnx.py:326
    def forward(self, x):
        return nn.functional.interpolate(x, scale_factor=2.0, mode="nearest")


MODULES = {  # name: (module class, its seed and input shape in JAX's suite)
    "cnn_bn_pool": (CnnBnPool, 0, (2, 3, 16, 16)),
    "resnet_style": (ResnetStyle, 9, (2, 3, 32, 32)),
    "unet_decoder": (UnetDecoder, 10, (1, 3, 16, 16)),
    "wav2vec_frontend": (Wav2vecFrontend, 11, (2, 1, 400)),
    "pixel_shuffle": (PixelShuffleUp, 12, (1, 3, 8, 8)),
    "interpolate_nearest": (InterpolateNearest, 13, (1, 2, 5, 5)),
}


def _export(m, x, opset) -> bytes:
    sys.modules.pop("onnx", None)
    torch_shim.install()
    f = io.BytesIO()
    with torch.no_grad():
        torch.onnx.export(m, (x,), f, opset_version=opset, dynamo=False)
    return f.getvalue()


@pytest.mark.parametrize("opset", [11, 13, 17])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_torch_export_matches_torch_and_jax(name, opset):
    cls, seed, shape = MODULES[name]
    torch.manual_seed(seed)
    m = cls().eval()
    x = torch.randn(*shape)
    with torch.no_grad():
        want = m(x).numpy()
    bs = _export(m, x, opset)
    (got,) = compile_model(bs, device="cpu", strict=True).run_np(x.numpy())
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    with redirect_stderr(io.StringIO()):
        (j,) = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(x.numpy())
    np.testing.assert_allclose(got, j, atol=ATOL, rtol=RTOL)


def test_resnet50_layout_small_width_matches_jax():
    """chip_smoke phase 36's builder at width 8, one block a stage and 64 x
    64 images (its full-width weights' scheme): both packages on the same
    bytes, logits at TOL and every index output equal where the logits'
    order is decided."""
    bs, macs = chip_smoke.resnet50_model(batch=2, width=8, blocks=(1, 1, 1, 1),
                                         classes=10, img=64)
    x = np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(np.float32)
    cm = compile_model(bs, device="cpu", strict=True)
    got = cm.run_np(data=x)
    with redirect_stderr(io.StringIO()):
        want = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(data=x)
    logits, probs, top5, top5_idx, argmax = got
    assert logits.shape == (2, 10) and np.isfinite(logits).all()
    assert 0.05 < np.abs(logits).max() < 50  # O(1) through the convs
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(top5_idx, want[3])
    np.testing.assert_array_equal(argmax, want[4])
    np.testing.assert_array_equal(top5_idx, np.argsort(-logits, axis=1, kind="stable")[:, :5])
    assert macs > 0 and cm.stats["capturable"]
