"""YOLO26-style NMS-free detector / segmenter (counterpart of
lele_tpu/models/yolo26.py).

A conv backbone in NHWC (a stride-2 stem and, for each further width, a
stage of a stride-2 down conv and a residual pair of 3x3 convs: stride 16 at
the four default widths) → per-cell heads (class logits, box, and for the
seg model mask coefficients plus prototypes from the stride-8 map); the
`n_queries` best cells by their best class logit are selected on the
device, so every output has a static shape and no NMS runs.

The network is split into `yolo26_head_maps` (the convs, up to the per-cell
maps) and `yolo26_select` (the query selection and the box decode);
`yolo26_forward` is the two in turn. Every conv rounds its operands to the
config's dtype and accumulates in f32 (`common.conv2d`), as the JAX
package's `preferred_element_type=f32` does.

Departures, each owed only in output:
- JAX's `Yolo26Model.init` adds an "s2d" subtree (the TPU's space-to-depth
  layout of the early stages, models/s2d.py) where `img_size % 4 == 0`;
  the port computes the plain NHWC chain, which JAX's tests hold equal to
  the s2d path at 1e-4 (`tests/test_s2d.py:79-106`). The host-packed
  48-channel input of that layout is not accepted.
- `jax.lax.top_k` puts the lower index first on ties; `torch.topk` promises
  no order, so the selection is a stable descending sort.
- `F.softplus` returns x itself above its threshold of 20, where
  `jax.nn.softplus` adds log1p(exp(-x)): < 3e-9 relative, below f32's
  resolution at x > 20.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from .. import default_device
from ..params import from_numpy_tree
from .common import Params, conv2d, init_conv2d


@dataclass
class Yolo26Config:
    img_size: int = 640
    n_classes: int = 80
    n_queries: int = 300
    widths: tuple = (32, 64, 128, 256)
    n_mask_coeffs: int = 32
    n_protos: int = 32
    segmentation: bool = False
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _csp_block(gen: torch.Generator, c: int) -> Params:
    return {"c1": init_conv2d(gen, c, c, 3), "c2": init_conv2d(gen, c, c, 3)}


def init_yolo26(gen: torch.Generator, cfg: Yolo26Config) -> Params:
    """Random weights on the generator's device, in JAX's tree layout."""
    w = cfg.widths
    p: Params = {
        "stem": init_conv2d(gen, 3, w[0], 3),
        "stages": [],
        "head_cls": init_conv2d(gen, w[-1], cfg.n_classes, 1),
        "head_box": init_conv2d(gen, w[-1], 4, 1),
    }
    for i in range(len(w) - 1):
        p["stages"].append({"down": init_conv2d(gen, w[i], w[i + 1], 3),
                            "csp": _csp_block(gen, w[i + 1])})
    if cfg.segmentation:
        p["head_coeff"] = init_conv2d(gen, w[-1], cfg.n_mask_coeffs, 1)
        p["proto1"] = init_conv2d(gen, w[2], cfg.n_protos, 3)
    return p


def yolo26_params_from_jax(tree: Params, device: torch.device | str = "cpu") -> Params:
    """JAX's param tree (numpy or JAX leaves) → the port's, on `device`. The
    "s2d" subtree is derived data of the TPU layout and is dropped."""
    return from_numpy_tree({k: v for k, v in tree.items() if k != "s2d"}, device)


def _image(img: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """[B, H, W, 3] or [B, 3, H, W], uint8 in [0, 255] or float in [0, 1] →
    NHWC in `dt`. uint8 is scaled as JAX does it, x·dt(1/255) in dt: a
    product by the rounded constant, not a division."""
    if img.dim() == 4 and img.shape[1] == 3 and img.shape[-1] != 3:
        img = img.permute(0, 2, 3, 1)  # CHW
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"image of shape {tuple(img.shape)}: expected [B, H, W, 3] or "
                         "[B, 3, H, W] (the TPU's packed 48-channel input is not taken)")
    if img.dtype == torch.uint8:
        return img.to(dt) * torch.tensor(1.0 / 255.0, dtype=dt).item()
    return img.to(dt)


def yolo26_head_maps(params: Params, img: torch.Tensor, cfg: Yolo26Config) -> dict:
    """The network up to its per-cell maps, f32: "cls" [B, Hc, Wc, C], "box"
    [B, Hc, Wc, 4] and, for the seg model, "coeff" [B, Hc, Wc, n_mask_coeffs]
    and "protos" [B, Hp, Wp, n_protos] (stride 8)."""
    dt = cfg.compute_dtype
    x = F.silu(conv2d(params["stem"], _image(img, dt), stride=2, dtype=dt))
    feats = [x]
    for st in params["stages"]:
        x = F.silu(conv2d(st["down"], x, stride=2, dtype=dt))
        h = F.silu(conv2d(st["csp"]["c1"], x, dtype=dt))
        x = x + conv2d(st["csp"]["c2"], h, dtype=dt)
        feats.append(x)
    maps = {"cls": conv2d(params["head_cls"], x, dtype=dt),
            "box": conv2d(params["head_box"], x, dtype=dt)}
    if cfg.segmentation:
        maps["coeff"] = conv2d(params["head_coeff"], x, dtype=dt)
        maps["protos"] = conv2d(params["proto1"], feats[2], dtype=dt)
    return maps


def query_indices(cls_map: torch.Tensor, n_queries: int) -> torch.Tensor:
    """[B, Hc, Wc, C] → [B, min(n_queries, Hc·Wc)] cell indices, by best class
    logit, descending; ties keep the lower index first, as `lax.top_k`."""
    conf = cls_map.flatten(1, 2).amax(dim=-1)
    order = torch.sort(conf, dim=-1, descending=True, stable=True).indices
    return order[:, : min(n_queries, conf.shape[1])]


def _take_rows(m: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    flat = m.flatten(1, 2)
    return torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[-1]))


def yolo26_select(maps: dict, cfg: Yolo26Config):
    """The head maps → (scores [B, Q, C], boxes [B, Q, 4] cxcywh in pixels[,
    coeffs [B, Q, n_mask_coeffs], protos]), the box decode in f32 as JAX's."""
    _, Hc, Wc, _ = maps["cls"].shape
    top_idx = query_indices(maps["cls"], cfg.n_queries)
    scores = _take_rows(maps["cls"], top_idx)
    boxes_raw = _take_rows(maps["box"], top_idx)
    stride = cfg.img_size // Hc
    cy = (top_idx // Wc).float()
    cx = (top_idx % Wc).float()
    cxcy = torch.stack([cx, cy], dim=-1) + 0.5
    centers = cxcy * stride + boxes_raw[..., :2] * stride
    wh = F.softplus(boxes_raw[..., 2:]) * stride
    boxes = torch.cat([centers, wh], dim=-1)
    if not cfg.segmentation:
        return scores, boxes
    return scores, boxes, _take_rows(maps["coeff"], top_idx), maps["protos"]


def yolo26_forward(params: Params, img: torch.Tensor, cfg: Yolo26Config):
    """img [B, H, W, 3] (or [B, 3, H, W]), f32 in [0, 1] or uint8 → (scores
    [B, Q, C], boxes [B, Q, 4] cxcywh in pixels[, coeffs [B, Q, 32], protos
    [B, Hp, Wp, 32]])."""
    return yolo26_select(yolo26_head_maps(params, img, cfg), cfg)


@dataclass
class Yolo26Model:
    """The detector on one device. `device` defaults to `default_device()`,
    which raises where there is no CUDA card: the CPU is taken only when the
    caller passes device="cpu"."""

    cfg: Yolo26Config = field(default_factory=Yolo26Config)
    params: Params | None = None
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = torch.device(self.device) if self.device is not None else default_device()

    def init(self, seed: int = 0) -> Params:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = init_yolo26(gen, self.cfg)
        return self.params

    def forward_fn(self):
        """(params, img: numpy or tensor) → `yolo26_forward`'s outputs."""
        cfg, device = self.cfg, self.device

        @torch.inference_mode()
        def fn(params, img):
            return yolo26_forward(params, torch.as_tensor(img, device=device), cfg)

        return fn


def decode_detections(
    scores: np.ndarray,
    boxes: np.ndarray,
    conf_threshold: float = 0.25,
    class_names: list[str] | None = None,
) -> list[dict]:
    """Threshold-only decode (no NMS) of the first image: sigmoid(best class
    logit) ≥ threshold → keep; cxcywh → xyxy; sorted by score."""
    out = []
    s = 1.0 / (1.0 + np.exp(-scores[0]))
    best = s.argmax(-1)
    conf = s.max(-1)
    for i in np.nonzero(conf >= conf_threshold)[0]:
        cx, cy, w, h = boxes[0, i]
        det = {
            "xyxy": (
                float(cx - w / 2), float(cy - h / 2),
                float(cx + w / 2), float(cy + h / 2),
            ),
            "score": float(conf[i]),
            "class_id": int(best[i]),
            # the query's row in the raw head outputs: compose_masks picks
            # its coeff and box rows by it
            "anchor": int(i),
        }
        if class_names:
            det["class"] = class_names[det["class_id"]]
        out.append(det)
    return sorted(out, key=lambda d: -d["score"])


def compose_masks(
    coeffs: np.ndarray, protos: np.ndarray, boxes: np.ndarray, keep: list[int],
    img_size: int = 640,
) -> np.ndarray:
    """sigmoid(coeffs @ protos) for each kept query, upsampled to img_size
    and cropped to its box → bool masks [len(keep), img_size, img_size]."""
    hp, wp, _ = protos[0].shape
    pm = protos[0].reshape(hp * wp, -1)  # [Hp*Wp, 32]
    masks = []
    for i in keep:
        m = 1.0 / (1.0 + np.exp(-(pm @ coeffs[0, i]).reshape(hp, wp)))
        m_big = np.kron(m, np.ones((img_size // hp, img_size // wp), np.float32))
        cx, cy, w, h = boxes[0, i]
        x0, y0 = max(0, int(cx - w / 2)), max(0, int(cy - h / 2))
        x1, y1 = min(img_size, int(cx + w / 2)), min(img_size, int(cy + h / 2))
        crop = np.zeros_like(m_big)
        crop[y0:y1, x0:x1] = m_big[y0:y1, x0:x1]
        masks.append(crop > 0.5)
    return np.stack(masks) if masks else np.zeros((0, img_size, img_size), bool)
