"""ImageDecoder (opset 20; counterpart of lele_tpu/ops/io_ops.py): encoded
JPEG/PNG/BMP/... bytes → [H, W, C] uint8.

The decode runs on the host, with PIL, while the tracer folds the node: an
encoded image is a variable-length byte stream whose output shape depends
on its data, so only bytes known at trace time (an initializer or a folded
constant) decode. An encoded input that arrives per request raises with the
JAX package's hint. PIL is imported inside the emitter: no module of the
port needs it to import.
"""

from __future__ import annotations

import io

import numpy as np

from .registry import OpContext, op


@op("ImageDecoder")
def image_decoder(ctx: OpContext, encoded):
    if not ctx.is_fold:
        raise NotImplementedError(
            "ImageDecoder needs the encoded bytes at trace time: image "
            "decode is host-side (data-dependent output shape). Hint: "
            "decode in your input pipeline and feed pixel tensors."
        )
    try:
        from PIL import Image
    except ImportError as e:
        raise NotImplementedError("ImageDecoder requires Pillow on the host") from e
    fmt = ctx.attr("pixel_format", "RGB")
    if isinstance(fmt, bytes):
        fmt = fmt.decode()
    data = np.asarray(encoded, dtype=np.uint8).tobytes()
    img = Image.open(io.BytesIO(data))
    if fmt == "Grayscale":
        return np.asarray(img.convert("L"), dtype=np.uint8)[..., None]
    if fmt in ("RGB", "BGR"):
        arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
        return arr[..., ::-1].copy() if fmt == "BGR" else arr
    raise ValueError(f"ImageDecoder: unknown pixel_format {fmt!r}")
