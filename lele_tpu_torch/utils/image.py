"""Image IO and preprocessing for the vision pipelines (the port's copy of
lele_tpu/utils/image.py, bit for bit).

PIL decodes (imported inside `load_image`: no module of the port needs it
to import); `preprocess` is the PIL-style nearest resize and /255 the
reference's YOLO examples apply, returning NHWC, the native detector's
layout (the compiled ONNX path transposes to the graph's NCHW). JAX's
`preprocess_s2d` (and its C++ `pack_s2d_u8`) packs the image into the TPU's
space-to-depth lanes and has no counterpart here.
"""

from __future__ import annotations

import numpy as np


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def nearest_resize(img: np.ndarray, size: int) -> np.ndarray:
    """PIL-style nearest resize (center-of-pixel mapping)."""
    h, w = img.shape[:2]
    ys = (np.arange(size) + 0.5) * h / size
    xs = (np.arange(size) + 0.5) * w / size
    yi = np.minimum(ys.astype(np.int64), h - 1)
    xi = np.minimum(xs.astype(np.int64), w - 1)
    return img[yi][:, xi]


def preprocess(img: np.ndarray, size: int = 640) -> np.ndarray:
    """uint8 HWC → f32 NHWC [1, size, size, 3] in [0, 1]."""
    out = nearest_resize(img, size).astype(np.float32) / 255.0
    return out[None]


def preprocess_u8(img: np.ndarray, size: int = 640) -> np.ndarray:
    """uint8 HWC → uint8 NHWC [1, size, size, 3]; the model normalizes on
    the device (`models.yolo26_forward`), so the upload is 4x smaller than
    the f32 path's."""
    return nearest_resize(img, size)[None]


def preprocess_chw(img: np.ndarray, size: int = 640) -> np.ndarray:
    """uint8 HWC → uint8 CHW [1, 3, size, size]; normalized on the device
    as `preprocess_u8`."""
    return nearest_resize(img, size).transpose(2, 0, 1)[None].copy()
