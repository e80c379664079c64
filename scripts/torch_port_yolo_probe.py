#!/usr/bin/env python3
"""The native YOLO26 forward's memory format on one NVIDIA card.

    python3 scripts/torch_port_yolo_probe.py [--runs 3]

`models.common.conv2d` keeps the JAX package's NHWC API and runs each conv
channels_last (the padded NHWC tensor, permuted, already is that layout).
The other choice is NCHW inside: the image permuted to contiguous NCHW
once, every conv and bias in NCHW, the maps permuted back at the end. This
times both on `Yolo26Config()` (640, widths 32-256) detect and seg, bf16
and f32, B = 1 and 8, as the head maps (`yolo26_head_maps`) in a CUDA graph
of 20 calls and by CUDA events, in turns (channels_last, NCHW, NCHW,
channels_last), and checks that both give the same maps (f32: 1e-5 of the
largest magnitude; bf16: chip_smoke.YOLO_MAP_REL). Prints the card's name
and power limit. Needs a card; imports no jax.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def head_maps_nchw(params, img, cfg):
    """`yolo26_head_maps` with every activation in contiguous NCHW."""
    import torch
    import torch.nn.functional as F

    from lele_tpu_torch.models.common import round_to, same_pads
    from lele_tpu_torch.models.yolo26 import _image

    dt = cfg.compute_dtype
    tf32 = dt in (torch.bfloat16, torch.float16)

    def conv(p, x, stride=1):
        (hl, hh), (wl, wh) = (same_pads(x.shape[2 + i], p["w"].shape[2 + i], stride)
                              for i in range(2))
        xp = F.pad(round_to(x, dt), (wl, wh, hl, hh))
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
            y = F.conv2d(xp, round_to(p["w"], dt), None, stride=stride)
        return y + p["b"].reshape(1, -1, 1, 1)

    x = _image(img, dt).permute(0, 3, 1, 2).contiguous()
    x = F.silu(conv(params["stem"], x, 2))
    feats = [x]
    for st in params["stages"]:
        x = F.silu(conv(st["down"], x, 2))
        x = x + conv(st["csp"]["c2"], F.silu(conv(st["csp"]["c1"], x)))
        feats.append(x)
    maps = {"cls": conv(params["head_cls"], x), "box": conv(params["head_box"], x)}
    if cfg.segmentation:
        maps["coeff"] = conv(params["head_coeff"], x)
        maps["protos"] = conv(params["proto1"], feats[2])
    return {k: v.permute(0, 2, 3, 1) for k, v in maps.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_port_yolo_probe: no CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    import chip_smoke as cs
    from lele_tpu_torch.models import Yolo26Config, Yolo26Model
    from lele_tpu_torch.models.yolo26 import yolo26_head_maps

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3, help="turns of each format")
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_identity()
    print(card)
    failures = []
    rng = np.random.default_rng(16)
    for seg in (False, True):
        for dtype in ("bfloat16", "float32"):
            cfg = Yolo26Config(segmentation=seg, dtype=dtype)
            model = Yolo26Model(cfg, device=dev)
            model.init(16)
            for b in (1, 8):
                img = torch.from_numpy(rng.integers(0, 256, (b, 640, 640, 3),
                                                    dtype=np.uint8)).to(dev)
                fns = {"channels_last": lambda: yolo26_head_maps(model.params, img, cfg),
                       "nchw": lambda: head_maps_nchw(model.params, img, cfg)}
                with torch.inference_mode():
                    a, c = fns["channels_last"](), fns["nchw"]()
                    rel = max(((a[k] - c[k]).abs().max() / a[k].abs().max()).item() for k in a)
                gate = cs.YOLO_MAP_REL[dtype]
                if rel > gate:
                    failures.append(f"{seg} {dtype} B={b}: formats differ by {rel:.2e}")
                times = {k: {"graph": [], "events": []} for k in fns}
                with torch.inference_mode():
                    for _ in range(args.runs):
                        for k in ("channels_last", "nchw", "nchw", "channels_last"):
                            times[k]["graph"].append(cs.graph_us(fns[k]))
                            times[k]["events"].append(cs.time_ms(fns[k]))
                label = f"{'seg' if seg else 'detect'} {dtype} B={b}"
                print(f"  {label}: " + "; ".join(
                    f"{k} {statistics.median(t['graph']):.2f} us in a CUDA graph, "
                    f"{statistics.median(t['events']):.4f} ms by events"
                    for k, t in times.items()) + f"; maps differ by {rel:.2e}  ({card})")
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
