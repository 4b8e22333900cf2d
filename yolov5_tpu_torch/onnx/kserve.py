"""A minimal KServe v2 HTTP endpoint (stdlib only) that runs an exported
.onnx through the port's ``Runtime``, the server side of
``remote.KServeV2Client`` and ``Detector("triton+http://host:port/<name>")``:

- ``GET /v2/models/<name>``: the model's metadata, with ``nc`` and ``names``
  from the file's metadata as parameters;
- ``POST /v2/models/<name>/infer``: a UINT8 JSON tensor in, the graph's first
  output as an FP32 JSON tensor out.

JSON tensors only, one model, one worker thread for the runtime (so that a
card is driven from one thread): enough to exercise the remote backend end
to end, not a production server.
"""

from __future__ import annotations

import contextlib
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


@contextlib.contextmanager
def serve_kserve(runtime, name="det", host="127.0.0.1", port=0):
    """Serve ``runtime`` (an ``onnx.runtime.Runtime``) as model ``name`` on
    ``host:port`` (0: a free port) while the context is open. Yields the
    base URL, ``http://host:port``."""
    meta = {k: json.loads(v) for k, v in runtime.metadata.items()}
    worker = ThreadPoolExecutor(max_workers=1)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, payload, code=200):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != f"/v2/models/{name}":
                return self._json({"error": "not found"}, 404)
            self._json({"name": name, "inputs": [{"name": "images", "datatype": "UINT8"}],
                        "outputs": [{"name": "output_0", "datatype": "FP32"}],
                        "parameters": {"nc": meta["nc"], "names": meta["names"]}})

        def do_POST(self):
            if self.path != f"/v2/models/{name}/infer":
                return self._json({"error": "not found"}, 404)
            req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            x = req["inputs"][0]
            images = np.asarray(x["data"], np.uint8).reshape(x["shape"])
            out = worker.submit(lambda: runtime(images)[0].cpu().numpy()).result()
            self._json({"outputs": [{"name": "output_0", "datatype": "FP32",
                                     "shape": list(out.shape), "data": out.reshape(-1).tolist()}]})

    srv = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://{host}:{srv.server_port}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        worker.shutdown()
