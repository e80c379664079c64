"""The port's HTTP daemon (lele_tpu_torch/server.py): JAX's eight
tests/test_server.py cases against one module-scoped server of the tiny
engines on the CPU, each answer also held to the engines called directly
on the same input (ids, detections and WAV bytes equal; none of these has a
tolerance). The /recognize burst is held batch by batch: the batchers'
`process_batch` is wrapped to record which requests formed each batch
(`chip_smoke.record_batches`). Every route at once (`chip_smoke.mixed_traffic`,
phase 38's check) and the engines' `CARD_LOCK` are held here too. Then the
same requests go to JAX's tiny server and to the port's, the ASR, detection
and TTS weights shared through the pytree artifact, and the answers are
compared: status, content type and body structure, and the payloads where
the two packages compute the same numbers.
"""

import base64
import concurrent.futures
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import chip_smoke as cs
from lele_tpu_torch.serving import encode_wav


@pytest.fixture(scope="module")
def server():
    from lele_tpu_torch import server as srv

    httpd = srv.serve(port=0, tiny=True, device="cpu")  # port 0: any free port
    engines = srv._LAST_ENGINES
    batches = cs.record_batches(engines["asr_batcher"])
    det_batches = cs.record_batches(engines["det_batcher"])
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", engines, batches, det_batches
    httpd.shutdown()
    httpd.server_close()
    t.join(30)


def _post(url, body):
    req = urllib.request.Request(url, data=body)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:  # 4xx/5xx still carry a body
        return e.code, e.read(), e.headers.get("Content-Type")


def _wav(n, f, amp=0.2):
    return encode_wav((np.sin(np.arange(n) / f) * amp).astype(np.float32), 16000)


def test_healthz(server):
    url, *_ = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"ok": True, "mesh": None}


def test_demo_page(server):
    from lele_tpu_torch.server import DEMO_PAGE

    url, *_ = server
    with urllib.request.urlopen(url + "/", timeout=30) as r:
        assert r.status == 200
        assert r.headers.get("Content-Type", "").startswith("text/html")
        page = r.read()
    assert page == DEMO_PAGE.read_bytes()
    assert DEMO_PAGE.parent.parent.name == "lele_tpu_torch"
    for endpoint in ("/recognize", "/detect", "/synthesize", "/healthz"):
        assert endpoint in page.decode(), endpoint


def test_recognize_endpoint(server):
    url, engines, *_ = server
    wav = _wav(12000, 9)
    status, body, _ = _post(url + "/recognize", wav)
    assert status == 200
    out = json.loads(body)
    assert out == {"ids": engines["asr"].recognize(wav)}
    assert isinstance(out["ids"], list)


def test_detect_endpoint(server):
    from PIL import Image

    url, engines, *_ = server
    img = Image.fromarray((np.random.default_rng(0).random((120, 160, 3)) * 255)
                          .astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, "JPEG")
    status, body, _ = _post(url + "/detect", buf.getvalue())
    assert status == 200
    dets = json.loads(body)["detections"]
    assert isinstance(dets, list)
    assert dets == json.loads(json.dumps(engines["det"].detect(buf.getvalue())))


def test_synthesize_endpoint(server):
    url, engines, *_ = server
    status, body, ctype = _post(url + "/synthesize", json.dumps({"text": "Server test."}).encode())
    assert status == 200 and ctype == "audio/wav"
    assert body[:4] == b"RIFF"
    assert body == engines["tts"].synthesize("Server test.")


def test_bad_requests(server):
    url, engines, *_ = server
    status, body, _ = _post(url + "/recognize", b"not a wav")
    assert status == 400
    err = json.loads(body)["error"]
    with pytest.raises(ValueError) as direct:
        engines["asr"].recognize(b"not a wav")
    assert err == f"ValueError: {direct.value}"
    status, body, _ = _post(url + "/nope", b"")
    assert status == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert e.value.code == 404
    status, _, _ = _post(url + "/synthesize", b"{not json")
    assert status == 400


def test_recognize_batch_endpoint(server):
    url, engines, *_ = server
    wavs = [_wav(9000, f) for f in (7.0, 11.0)]
    body = json.dumps([base64.b64encode(w).decode() for w in wavs]).encode()
    status, resp, _ = _post(url + "/recognize_batch", body)
    assert status == 200
    results = json.loads(resp)["results"]
    assert len(results) == 2 and all(isinstance(r, list) for r in results)
    assert results == engines["asr"].recognize_batch(wavs)


def test_recognize_concurrent_microbatch(server):
    """Concurrent /recognize requests inside the batching window coalesce
    into batched programs, and every client gets what recognize_batch gives
    its batch."""
    url, engines, batches, _ = server
    wavs = [_wav(8000 + 800 * i, 7 + i, 0.3) for i in range(6)]
    _post(url + "/recognize", wavs[0])  # warm the program once
    batcher = engines["asr_batcher"]
    before, seen = len(batcher.batch_sizes), len(batches)
    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as ex:
        rs = list(ex.map(lambda w: _post(url + "/recognize", w), wavs))
    answers = {}
    for w, (status, body, _) in zip(wavs, rs):
        assert status == 200
        answers[w] = json.loads(body)["ids"]
    flushed = batcher.batch_sizes[before:]
    assert sum(flushed) == 6
    assert len(flushed) < 6, f"no coalescing happened: {flushed}"
    for batch in batches[seen:]:
        assert [answers[w] for w in batch] == engines["asr"].recognize_batch(batch)


def test_listen_backlog_takes_a_burst():
    """16 clients connect at once while the daemon accepts none: every
    handshake completes. socketserver's backlog of 5 (JAX's server) lets 6
    through; the kernel drops the later SYNs and each such client retries
    after 1 s, which a burst the batcher would coalesce must not wait for."""
    import socket

    from lele_tpu_torch.server import serve

    httpd = serve(port=0, engines={"asr": None})
    socks = []
    try:
        for _ in range(16):
            socks.append(socket.create_connection(httpd.server_address, timeout=0.5))
    finally:
        for s in socks:
            s.close()
        httpd.server_close()
    assert len(socks) == 16


def test_every_route_at_once(server):
    """Phase 38's mixed round on the tiny engines: 8 /recognize, 2
    /recognize_batch, 2 /detect and 4 /synthesize in flight together, each
    answer what the engine gives called directly (bits)."""
    url, engines, batches, det_batches = server
    bad, asr_sizes, det_sizes = cs.mixed_traffic(url, engines, batches, det_batches, seed=38)
    assert not bad, bad
    assert sum(asr_sizes) == cs.ENTRY_BURST and sum(det_sizes) == 2


def test_engines_hold_the_card_lock(server):
    """A request waits while another thread holds `CARD_LOCK` and is answered
    once it is let go: the engines run their card work under it, so two
    requests' programs never interleave (on the CPU there is nothing to
    interleave; the card case is in test_torch_port_card.py)."""
    from lele_tpu_torch.runtime.graphs import CARD_LOCK

    url, engines, *_ = server
    body = json.dumps({"text": "Held."}).encode()
    for path, req in (("/synthesize", body), ("/recognize", _wav(8000, 5))):
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            with CARD_LOCK:
                fut = ex.submit(_post, url + path, req)
                with pytest.raises(concurrent.futures.TimeoutError):
                    fut.result(timeout=0.5)
            assert fut.result(timeout=120)[0] == 200, path


def _jax_and_port_servers(tmp_path):
    """The port's tiny engines on the CPU (`build_engines(tiny=True)`) behind
    the port's handler, and JAX's tiny configurations (lele_tpu/server.py's
    `build_engines(tiny=True)`) behind JAX's handler, the JAX models given
    the port's weights: the port saves each param tree (`save_pytree`) and
    JAX loads the files (`lele_tpu.runtime.artifact.load_pytree`), then
    runs the layout passes its own `init` ends with (YOLO26's space-to-depth
    weights, the vocoder's packed form)."""
    from http.server import ThreadingHTTPServer

    from lele_tpu import server as jserver
    from lele_tpu.models import (SenseVoiceConfig, SenseVoiceModel, SupertonicConfig,
                                 SupertonicTts, Yolo26Config, Yolo26Model)
    from lele_tpu.models.packed1d import prepare_vocoder_packed
    from lele_tpu.models.yolo26 import prepare_s2d_params
    from lele_tpu.runtime import artifact as jartifact
    from lele_tpu.runtime.batcher import MicroBatcher
    from lele_tpu.serving import SenseVoiceEngine, TtsEngine, Yolo26Engine
    from lele_tpu_torch import server as pserver
    from lele_tpu_torch.runtime import artifact as partifact

    peng = pserver.build_engines(tiny=True, device="cpu")

    def carried(name, tree):
        partifact.save_pytree(tmp_path / name, tree)
        return jartifact.load_pytree(tmp_path / name, device=False)

    asr = SenseVoiceModel(SenseVoiceConfig(n_layers=1, d_model=32, ffn_dim=64, vocab_size=40,
                                           n_heads=2, dtype="float32"))
    asr.params = carried("asr", peng["asr"].model.params)
    det = Yolo26Model(Yolo26Config(img_size=128, widths=(8, 16, 32, 64), dtype="float32"))
    det.params = prepare_s2d_params(carried("det", peng["det"].model.params), det.cfg)
    tts = SupertonicTts(SupertonicConfig(n_text_layers=1, n_est_layers=1, latent_buckets=(32,)))
    ptts = peng["tts"].tts.params  # less the port's stacked copy of the estimator blocks
    tts.params = carried("tts", {**ptts, "estimator": {k: v for k, v in ptts["estimator"].items()
                                                       if k != "blocks_stacked"}})
    tts.params["vocoder"] = prepare_vocoder_packed(tts.params["vocoder"], tts.cfg)
    asr_e, det_e = SenseVoiceEngine(model=asr), Yolo26Engine(model=det)
    jeng = {"asr": asr_e, "asr_batcher": MicroBatcher(asr_e.recognize_batch, 8, 5.0),
            "det": det_e, "det_batcher": MicroBatcher(det_e.detect_batch, 8, 5.0),
            "tts": TtsEngine(tts=tts), "mesh": None, "plan": None}
    servers = [ThreadingHTTPServer(("127.0.0.1", 0), jserver.make_handler(jeng)),
               pserver.DaemonServer(("127.0.0.1", 0), pserver.make_handler(peng))]
    for h in servers:
        threading.Thread(target=h.serve_forever, daemon=True).start()
    return servers, jeng, peng


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _wav_header(body: bytes):
    import wave

    with wave.open(io.BytesIO(body)) as w:
        return w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes()


def test_port_and_jax_servers_agree(tmp_path):
    """The same requests to JAX's tiny server and to the port's, with the
    weights shared: equal status codes and content types on every route,
    equal JSON bodies for /healthz, the 404s and the 400s (JAX's error
    strings), equal ids from /recognize and /recognize_batch (speech-like
    input: the port's logits sit within 3.3e-5 of JAX's, 20 times below the
    smallest top-2 margin of JAX's, 6.7e-4; a pure tone would not do, its
    empty mel bins take the log of rounding-level energies), the same
    detections (class ids equal, boxes and scores within 1e-4 of max(1,
    |JAX's|); measured 7.6e-6 over 64), and /synthesize WAVs of the
    same format and length (the samples differ: the flow's noise comes from
    jax.random in one and torch.Generator in the other). The demo pages
    reference the same endpoints."""
    from PIL import Image

    servers, jeng, peng = _jax_and_port_servers(tmp_path)
    jurl, purl = (f"http://127.0.0.1:{h.server_address[1]}" for h in servers)
    rng = np.random.default_rng(23)
    speech = [cs.wav_bytes(cs.synth_speechlike(s, rng)) for s in (0.6, 1.0, 2.3)]
    buf = io.BytesIO()
    Image.fromarray((np.random.default_rng(0).random((120, 160, 3)) * 255)
                    .astype(np.uint8)).save(buf, "JPEG")
    batch = json.dumps([base64.b64encode(w).decode() for w in speech]).encode()
    posts = [("/recognize", speech[1]), ("/recognize", b"not a wav"),
             ("/recognize_batch", batch), ("/recognize_batch", b"{"),
             ("/detect", buf.getvalue()), ("/synthesize", json.dumps({"text": "Server test."})
                                           .encode()),
             ("/synthesize", b"{not json"), ("/nope", b"")]
    try:
        for path in ("/healthz", "/nope", "/"):
            (js, jb, jc), (ps, pb, pc) = _get(jurl + path), _get(purl + path)
            assert (ps, pc) == (js, jc), path
            if path == "/":
                routes = ("/recognize", "/recognize_batch", "/detect", "/synthesize", "/healthz")
                assert ([r in pb.decode() for r in routes] == [r in jb.decode() for r in routes])
            else:
                assert json.loads(pb) == json.loads(jb), path
        for path, body in posts:
            (js, jb, jc), (ps, pb, pc) = _post(jurl + path, body), _post(purl + path, body)
            assert (ps, pc) == (js, jc), (path, body[:20])
            if pc == "audio/wav":
                assert pb[:4] == jb[:4] == b"RIFF"
                assert _wav_header(pb) == _wav_header(jb)
                continue
            got, want = json.loads(pb), json.loads(jb)
            if path != "/detect":
                assert got == want, (path, body[:20])
                continue
            assert len(got["detections"]) == len(want["detections"]) > 0
            for g, w in zip(got["detections"], want["detections"]):
                assert g.keys() == w.keys() and g["class_id"] == w["class_id"]
                for k in g:
                    np.testing.assert_allclose(g[k], w[k], rtol=0,
                                               atol=1e-4 * max(1.0, np.abs(w[k]).max()))
    finally:
        for h in servers:
            h.shutdown()
            h.server_close()
        for engines in (jeng, peng):
            engines["asr_batcher"].close()
            engines["det_batcher"].close()
