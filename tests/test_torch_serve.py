"""yolov5_tpu_torch.serve against yolov5_tpu.serve: both handlers on
ThreadingHTTPServers bound to 127.0.0.1, the same .ckpt (yolov5n, f32, on
the CPU), the same raw and multipart BMP bodies: the same records (boxes
within 1e-3 px, confidences within 1e-5), and the 401/404/400 answers."""

import json
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest

import yolov5_tpu.serve as jax_serve
import yolov5_tpu_torch.serve as serve
from tests.torch_port_helpers import assert_same_records, save_jax_checkpoint, yolov5n_cfg
from yolov5_tpu.infer import Detector as JaxDetector
from yolov5_tpu_torch.data.imageio import bmp_bytes
from yolov5_tpu_torch.infer import Detector

# above the from-maps NMS's 2048-candidate cap, where both packages sort the
# candidates globally (ROADMAP, Open items 3)
IMGSZ = 192


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    ckpt = save_jax_checkpoint(yolov5n_cfg(3), tmp_path_factory.mktemp("w") / "best.ckpt")
    out = {}
    for name, mod, det in (("jax", jax_serve, JaxDetector(str(ckpt), imgsz=IMGSZ)),
                           ("port", serve, Detector(str(ckpt), imgsz=IMGSZ, device="cpu"))):
        handler = mod.make_handler({"m": det}, "k1", 0.25)
        srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        out[name] = (f"http://127.0.0.1:{srv.server_port}", srv, t, handler)
    yield {k: v[0] for k, v in out.items()}
    for _, srv, t, handler in out.values():
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)
    out["port"][3].executor.shutdown()


def _post(url, body, ctype="application/octet-stream", key="k1", path="/v1/object-detection/m"):
    req = urllib.request.Request(url + path, data=body, method="POST",
                                 headers={"Content-Type": ctype, **({"X-API-Key": key} if key
                                                                    else {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _multipart(data, filename="im.bmp"):
    b = "xYzBoundary"
    body = (f"--{b}\r\nContent-Disposition: form-data; name=\"image\"; filename=\"{filename}\""
            f"\r\nContent-Type: image/bmp\r\n\r\n").encode() + data + f"\r\n--{b}--\r\n".encode()
    return body, f"multipart/form-data; boundary={b}"


def _images():
    rng = np.random.default_rng(0)
    for h, w in ((144, 192), (192, 144), (120, 120), (100, 192)):
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        im[h // 4:h // 2, w // 4:w // 2] = (40, 120, 250)
        yield im


@pytest.mark.parametrize("form", ["raw", "multipart"])
def test_records_match_jax(servers, form):
    for im in _images():
        data = bmp_bytes(im)
        body, ctype = _multipart(data) if form == "multipart" else (data, "image/bmp")
        (sj, rj), (sp, rp) = (_post(servers[k], body, ctype) for k in ("jax", "port"))
        assert sj == sp == 200
        assert len(rp) > 0
        assert_same_records(rp, rj)
        assert set(rp[0]) == {"xmin", "ymin", "xmax", "ymax", "confidence", "class", "name"}


def test_health_and_errors_match_jax(servers):
    bmp = bmp_bytes(next(_images()))
    for k in ("jax", "port"):
        url = servers[k]
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read()) == {"ok": True, "models": ["m"]}
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/nope", timeout=30)
        assert e.value.code == 404
        assert _post(url, bmp, key=None)[0] == 401
        assert _post(url, bmp, key="wrong")[0] == 401
        assert _post(url, bmp, path="/v1/object-detection/other")[0] == 404
        assert _post(url, b"")[0] == 400
        assert _post(url, *_multipart(bmp, "im.exe")) == (400, {"error": "extension .exe not allowed"})
        assert _post(url, b"garbage bytes") == (400, {"error": "undecodable image"})
        assert _post(url, bmp[:200])[0] == 400  # a truncated BMP


def test_png_without_cv2_is_a_400_that_says_why(servers, monkeypatch):
    """With OpenCV the port's handler decodes a PNG as the JAX one does;
    without it, the answer is a 400 naming the missing decoder."""
    png = cv2.imencode(".png", next(_images()))[1].tobytes()
    (sj, rj), (sp, rp) = (_post(servers[k], png, "image/png") for k in ("jax", "port"))
    assert sj == sp == 200
    assert_same_records(rp, rj)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    code, reply = _post(servers["port"], png, "image/png")
    assert code == 400 and "OpenCV" in reply["error"] and "BMP" in reply["error"]


def test_detectors_run_on_one_worker_thread():
    """Requests arrive on threads of their own; every detector call runs on
    the handler's one worker thread."""
    seen = []

    class Probe:
        imgsz, names = 64, {0: "x"}

        def __call__(self, ims, conf_thres):
            seen.append(threading.get_ident())
            return Detector(cfg="yolov5n", imgsz=64, device="cpu")(ims, conf_thres=conf_thres)

    handler = serve.make_handler({"m": Probe()}, None, 0.25)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}"
        replies = [_post(url, bmp_bytes(im), key=None) for im in list(_images())[:3]]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=5)
        handler.executor.shutdown()
    assert [code for code, _ in replies] == [200] * 3
    assert len(seen) == 3 and len(set(seen)) == 1 and seen[0] != threading.get_ident()


def test_detections_to_records_matches_jax():
    rows = np.array([[1.5, 2, 30, 40.25, 0.9, 2, 0.1], [0, 0, 5, 5, 0.3, 0, 0.2]], np.float32)
    names = {0: "a", 2: "c"}
    assert serve.detections_to_records(rows, names) == jax_serve.detections_to_records(rows, names)


def test_run_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(cfg="yolov5n", imgsz=64, port=0)
