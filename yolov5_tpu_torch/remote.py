"""Remote-inference clients (the reference's TritonRemoteModel role,
utils/triton.py:11-78): a copy of ``yolov5_tpu/remote.py`` (stdlib and
numpy only), held to its original by ``tests/test_torch_backends.py``.

Two protocols:

- `RestClient` — the serving API of ``serve.py`` (both packages):
  POST /v1/object-detection/<model> with image bytes -> JSON records.
- `KServeV2Client` — the KServe/Triton v2 HTTP inference protocol
  (GET v2/models/<m> metadata, POST v2/models/<m>/infer with a JSON tensor
  payload), so a Detector can point at a Triton-style server with
  `weights="triton+http://host:8000/model"`.

Local/private endpoints are expected here (a serving fleet lives on the
internal network), so SSRF validation is intentionally NOT applied — these
URLs are operator configuration, not user-supplied data.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request

import numpy as np


def _http(url, data=None, headers=None, timeout=60.0):
    req = urllib.request.Request(url, data=data, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


class RestClient:
    """Client for serve.py's /v1/object-detection API."""

    def __init__(self, url, model="yolov5s", api_key=None, timeout=60.0):
        self.base = url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.timeout = timeout

    def health(self):
        return json.loads(_http(f"{self.base}/healthz", timeout=self.timeout))

    def detect_bytes(self, image_bytes):
        """Raw encoded image bytes -> list of detection records."""
        headers = {"Content-Type": "application/octet-stream"}
        if self.api_key:
            headers["X-API-Key"] = self.api_key
        out = _http(f"{self.base}/v1/object-detection/{self.model}",
                    data=image_bytes, headers=headers, timeout=self.timeout)
        return json.loads(out)

    def detect_file(self, path):
        with open(path, "rb") as f:
            return self.detect_bytes(f.read())


class KServeV2Client:
    """Minimal KServe / Triton v2 HTTP client for a single-input,
    single-output image model (the DetectMultiBackend 'triton' role)."""

    def __init__(self, url, timeout=60.0):
        # accepted forms: http://host:8000/modelname or triton+http://...
        url = url.replace("triton+", "", 1)
        parsed = urllib.parse.urlparse(url)
        self.base = f"{parsed.scheme}://{parsed.netloc}"
        self.model = parsed.path.strip("/").split("/")[-1]
        self.timeout = timeout
        self.metadata = json.loads(
            _http(f"{self.base}/v2/models/{self.model}", timeout=timeout))
        self.input_name = self.metadata["inputs"][0]["name"]
        self.input_dtype = self.metadata["inputs"][0].get("datatype", "FP32")
        self.output_name = self.metadata["outputs"][0]["name"]

    _NP2V2 = {"float32": "FP32", "float16": "FP16", "uint8": "UINT8",
              "int32": "INT32", "int64": "INT64"}
    _V22NP = {v: k for k, v in _NP2V2.items()}

    def infer(self, array):
        """array: numpy input tensor -> numpy output tensor."""
        array = np.asarray(array)
        payload = {
            "inputs": [{
                "name": self.input_name,
                "shape": list(array.shape),
                "datatype": self._NP2V2.get(str(array.dtype), "FP32"),
                "data": array.reshape(-1).tolist(),
            }],
            "outputs": [{"name": self.output_name}],
        }
        out = json.loads(_http(
            f"{self.base}/v2/models/{self.model}/infer",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, timeout=self.timeout))
        o = out["outputs"][0]
        return np.asarray(o["data"],
                          self._V22NP.get(o.get("datatype", "FP32"), "float32")
                          ).reshape(o["shape"])

    def __call__(self, images):
        return self.infer(images)
