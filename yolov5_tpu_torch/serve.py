"""HTTP object-detection service, the port of ``yolov5_tpu/serve.py`` (the
reference's Flask REST API, utils/flask_rest_api/restapi.py:13-76, on the
stdlib http.server).

  POST /v1/object-detection/<model>   body: raw image bytes or multipart
  -> JSON [{xmin, ymin, xmax, ymax, confidence, class, name}, ...]
  GET /healthz -> {"ok": true, "models": [...]}

Optional API key: start with api_key=...; clients send X-API-Key. Upload
validation mirrors the reference: extension allow-list + size cap. Bodies
are decoded by ``data.imageio.imdecode``: 24-bit BMP without OpenCV; a body
that cannot be decoded, or whose format needs a decoder that is not
installed, gets a 400 that says which.

Each request is read, decoded and letterboxed on its own thread, and the
detectors run on one worker thread that the handler class owns
(``Handler.executor``): PyTorch caches cuDNN's execution plans per thread,
so a model called from a new thread per request builds every plan anew.

    python -m yolov5_tpu_torch.serve --weights best.ckpt --port 5000
    python -m yolov5_tpu_torch.serve --device cpu --weights best.ckpt
"""

from __future__ import annotations

import json
import re
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

ALLOWED_EXT = {"jpg", "jpeg", "png", "bmp", "webp", "tif", "tiff"}
MAX_BYTES = 25 * 1024 * 1024


def detections_to_records(rows, names):
    out = []
    for x1, y1, x2, y2, conf, cls, *rest in rows:
        out.append({
            "xmin": float(x1), "ymin": float(y1),
            "xmax": float(x2), "ymax": float(y2),
            "confidence": float(conf), "class": int(cls),
            "name": str(names.get(int(cls), int(cls))),
        })
    return out


def _extract_image_bytes(handler: BaseHTTPRequestHandler):
    """Raw body or the first file part of a multipart form."""
    length = int(handler.headers.get("Content-Length", 0))
    if length <= 0 or length > MAX_BYTES:
        return None, "missing or oversized body"
    body = handler.rfile.read(length)
    ctype = handler.headers.get("Content-Type", "")
    if ctype.startswith("multipart/form-data"):
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            return None, "bad multipart boundary"
        boundary = m.group(1).encode()
        for part in body.split(b"--" + boundary):
            if b"filename=" not in part:
                continue
            header, _, content = part.partition(b"\r\n\r\n")
            fn = re.search(rb'filename="([^"]*)"', header)
            if fn:
                ext = fn.group(1).rsplit(b".", 1)[-1].decode().lower()
                if ext not in ALLOWED_EXT:
                    return None, f"extension .{ext} not allowed"
            return content.rstrip(b"\r\n"), None
        return None, "no file part"
    return body, None


def make_handler(detectors: dict, api_key: str | None, conf_thres: float):
    """The request handler class for ``detectors`` (name -> Detector). Its
    ``executor`` runs every detector call on one thread; shut it down when
    the server stops."""
    from yolov5_tpu_torch.data.imageio import imdecode
    from yolov5_tpu_torch.data.letterbox import letterbox, scale_boxes_np
    from yolov5_tpu_torch.ops.nms import detections_to_numpy

    def detect(det, im):
        return detections_to_numpy(det(im[..., ::-1][None].copy(), conf_thres=conf_thres))[0]

    class Handler(BaseHTTPRequestHandler):
        executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="detector")

        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code, payload):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "models": sorted(detectors)})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if api_key and self.headers.get("X-API-Key") != api_key:
                return self._reply(401, {"error": "invalid api key"})
            m = re.match(r"^/v1/object-detection/([\w.-]+)$", self.path)
            if not m or m.group(1) not in detectors:
                return self._reply(404, {"error": f"unknown model; have {sorted(detectors)}"})
            det = detectors[m.group(1)]
            raw, err = _extract_image_bytes(self)
            if err:
                return self._reply(400, {"error": err})
            try:
                im0 = imdecode(raw)
            except ImportError as e:
                return self._reply(400, {"error": f"undecodable image: {e}"})
            if im0 is None:
                return self._reply(400, {"error": "undecodable image"})
            im, _, _ = letterbox(im0, det.imgsz)
            rows = self.executor.submit(detect, det, im).result()
            if len(rows):
                rows[:, :4] = scale_boxes_np(im.shape[:2], rows[:, :4], im0.shape[:2])
            self._reply(200, detections_to_records(rows, det.names))

    return Handler


def run(weights="", cfg="yolov5s", models=None, host="0.0.0.0", port=5000,
        imgsz=640, conf_thres=0.25, api_key=None, device="cuda"):
    """Serve one or more detectors on ``device``. ``models`` maps name ->
    weights path."""
    from yolov5_tpu_torch.infer import Detector

    specs = models or {"yolov5s": weights}
    detectors = {name: Detector(w or None, cfg=cfg if len(specs) == 1 else name, imgsz=imgsz,
                                device=device) for name, w in specs.items()}
    handler = make_handler(detectors, api_key, conf_thres)
    for det in detectors.values():  # on the thread that will run it
        handler.executor.submit(det.warmup).result()
    server = ThreadingHTTPServer((host, port), handler)
    print(f"serving {sorted(detectors)} on http://{host}:{port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        handler.executor.shutdown()


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(prog="python -m yolov5_tpu_torch.serve",
                                description="REST detection API (reference utils/flask_rest_api)")
    p.add_argument("--weights", default="")
    p.add_argument("--cfg", default="yolov5s")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--api-key", default=None)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    a = p.parse_args()
    run(weights=a.weights, cfg=a.cfg, host=a.host, port=a.port, imgsz=a.imgsz,
        conf_thres=a.conf_thres, api_key=a.api_key, device=a.device)
