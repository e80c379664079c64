"""HTTP serving daemon of the port over its engine layer (the counterpart of
lele_tpu/server.py), stdlib only:

    python -m lele_tpu_torch.server [--port 8570] [--tiny] [--device cpu]

    POST /recognize        body: WAV bytes → {"ids": [...]} (or {"text": ...})
    POST /recognize_batch  body: JSON [b64 wav, ...] → {"results": [...]}
    POST /detect           body: JPEG/PNG bytes → {"detections": [...]}
    POST /synthesize       body: {"text": ..., "voice": ..., "lang": ...} → WAV
    GET  /healthz          → {"ok": true, "mesh": null}
    GET  /                 the browser demo (web/index.html)

/recognize and /detect go through a `MicroBatcher` each (runtime/batcher.py):
concurrent requests within its window run as one batched program on the
card. The engines run on the card unless `--device cpu` (device="cpu") is
given. A request the engines refuse answers 400 with the error, and its
traceback goes to stderr. The listening socket's backlog is 64, not
socketserver's 5 (JAX's), so a burst of concurrent clients is not held back
by SYN retries. JAX's `--mesh` (a data-parallel layout over
several devices) has no counterpart yet: /healthz reports no mesh, as JAX
does on one device.
"""

from __future__ import annotations

import base64
import json
import sys
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

DEMO_PAGE = Path(__file__).resolve().parent / "web" / "index.html"

_LAST_ENGINES: dict = {}  # the engines of the last serve() (tests, observability)


def make_handler(engines: dict):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode())

        def do_GET(self):
            if self.path == "/healthz":
                return self._json(200, {"ok": True, "mesh": None})
            if self.path in ("/", "/index.html"):
                try:
                    return self._send(200, DEMO_PAGE.read_bytes(), "text/html; charset=utf-8")
                except OSError:
                    return self._json(500, {"error": "demo page missing"})
            return self._json(404, {"error": "unknown path"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            try:
                if self.path == "/recognize":
                    batcher = engines.get("asr_batcher")
                    out = (batcher.submit(body) if batcher is not None
                           else engines["asr"].recognize(body))
                    if isinstance(out, str):
                        return self._json(200, {"text": out})
                    return self._json(200, {"ids": out})
                if self.path == "/recognize_batch":
                    wavs = [base64.b64decode(w) for w in json.loads(body or b"[]")]
                    return self._json(200, {"results": engines["asr"].recognize_batch(wavs)})
                if self.path == "/detect":
                    batcher = engines.get("det_batcher")
                    dets = (batcher.submit(body) if batcher is not None
                            else engines["det"].detect(body))
                    return self._json(200, {"detections": dets})
                if self.path == "/synthesize":
                    req = json.loads(body or b"{}")
                    wav = engines["tts"].synthesize(req.get("text", ""), voice=req.get("voice"),
                                                    lang=req.get("lang", "en"))
                    return self._send(200, wav, "audio/wav")
                return self._json(404, {"error": "unknown path"})
            except Exception as e:  # the daemon keeps serving: report the request's error
                traceback.print_exc(file=sys.stderr)
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def build_engines(tiny: bool = False, device=None) -> dict:
    """The ASR, detection and TTS engines with random weights from seed 0, on
    `device` (the card by default): the JAX package's full-width configs, or
    with `tiny` its fast-start ones for tests; a MicroBatcher (8 requests,
    5 ms) in front of ASR and detection."""
    import torch

    from . import default_device
    from .models import (
        SenseVoiceConfig, SenseVoiceModel, SupertonicConfig, SupertonicTts,
        Yolo26Config, Yolo26Model,
    )
    from .runtime.batcher import MicroBatcher
    from .serving import SenseVoiceEngine, TtsEngine, Yolo26Engine

    device = torch.device(device) if device is not None else default_device()
    if tiny:
        asr_cfg = SenseVoiceConfig(n_layers=1, d_model=32, ffn_dim=64, vocab_size=40,
                                   n_heads=2, dtype="float32")
        det_cfg = Yolo26Config(img_size=128, widths=(8, 16, 32, 64), dtype="float32")
        tts_cfg = SupertonicConfig(n_text_layers=1, n_est_layers=1, latent_buckets=(32,))
    else:
        asr_cfg, det_cfg, tts_cfg = SenseVoiceConfig(), Yolo26Config(), SupertonicConfig()
    asr_m = SenseVoiceModel(asr_cfg, device=device)
    det_m = Yolo26Model(det_cfg, device=device)
    tts_m = SupertonicTts(tts_cfg, device=device)
    for m in (asr_m, det_m, tts_m):
        m.init(0)
    asr = SenseVoiceEngine(model=asr_m)
    det = Yolo26Engine(model=det_m)
    return {
        "asr": asr,
        "asr_batcher": MicroBatcher(asr.recognize_batch, max_batch=8, window_ms=5.0),
        "det": det,
        "det_batcher": MicroBatcher(det.detect_batch, max_batch=8, window_ms=5.0),
        "tts": TtsEngine(tts=tts_m),
    }


class DaemonServer(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: when more clients than that
    # connect at once (a burst the batcher would coalesce, up to its 8), the
    # kernel drops the extra SYNs and each such client retries after 1 s
    request_queue_size = 64


def serve(port: int = 8570, tiny: bool = False, engines: dict | None = None, device=None):
    """A DaemonServer (ThreadingHTTPServer) on 127.0.0.1:`port` (0: any free port) over
    `engines` (by default `build_engines(tiny, device)`); returned without
    serving: call its `serve_forever()` (the __main__ path does)."""
    global _LAST_ENGINES
    engines = engines or build_engines(tiny, device)
    _LAST_ENGINES = engines
    httpd = DaemonServer(("127.0.0.1", port), make_handler(engines))
    print(f"lele-tpu-torch serving on http://127.0.0.1:{httpd.server_address[1]}")
    return httpd


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="lele_tpu_torch.server")
    ap.add_argument("--port", type=int, default=8570)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the engines (default: the card)")
    args = ap.parse_args(argv)
    serve(args.port, args.tiny, device=args.device).serve_forever()


if __name__ == "__main__":
    main()
