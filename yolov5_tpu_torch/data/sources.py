"""Inference input sources (host side): LoadImages over files, dirs, globs,
txt lists, videos and URLs, LoadStreams over webcams and RTSP with one reader
thread per source, and LoadScreenshots for screen capture.

The port of ``yolov5_tpu/data/sources.py`` (the reference's LoadImages /
LoadStreams / LoadScreenshots, utils/dataloaders.py:208-466). Images are read
by ``data.imageio.imread`` (24-bit BMP without OpenCV); videos and streams
need OpenCV and screenshots ``mss``, each imported when such a source is met,
with an error naming the source where it is missing. URL sources are
downloaded through the SSRF-validated fetcher in ``utils/net.py``.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np

from yolov5_tpu_torch.data.dataset import IMG_FORMATS
from yolov5_tpu_torch.data.imageio import imread
from yolov5_tpu_torch.data.letterbox import letterbox

VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv"}


def _cv2_for(source):
    """OpenCV, which videos and streams need; ImportError naming the source
    where it is not installed."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{source}: reading videos and streams needs OpenCV (cv2), "
                          "which is not installed") from e
    return cv2


class LoadImages:
    """Iterate (path, letterboxed RGB (s, s, 3) uint8, original BGR, meta)
    over files, dirs, globs, txt lists and videos."""

    def __init__(self, path, img_size=640, stride=32, auto=False,
                 allow_private_urls=False, vid_stride=1):
        files = []
        for p in path if isinstance(path, (list, tuple)) else [str(path)]:
            if str(p).startswith(("http://", "https://")):
                from yolov5_tpu_torch.utils.net import fetch_url_to_file

                p = fetch_url_to_file(str(p), allow_private=allow_private_urls)
            else:
                p = str(Path(p).resolve())
            if "*" in p:
                files.extend(sorted(glob.glob(p, recursive=True)))
            elif os.path.isdir(p):
                files.extend(sorted(glob.glob(os.path.join(p, "*.*"))))
            elif os.path.isfile(p):
                if p.endswith(".txt"):
                    files.extend(Path(p).read_text().split())
                else:
                    files.append(p)
            else:
                raise FileNotFoundError(f"{p} does not exist")
        self.images = [f for f in files if f.rsplit(".", 1)[-1].lower() in IMG_FORMATS]
        self.videos = [f for f in files if f.rsplit(".", 1)[-1].lower() in VID_FORMATS]
        self.files = self.images + self.videos
        self.img_size = img_size
        self.stride = stride
        self.auto = auto
        self.vid_stride = vid_stride  # video frame-rate stride (ref detect.py --vid-stride)
        self.nf = len(self.files)
        if self.nf == 0:
            raise FileNotFoundError(f"no images/videos found in {path}")

    def __len__(self):
        return self.nf

    def __iter__(self):
        for f in self.images:
            try:
                im0 = imread(f)
            except (FileNotFoundError, ValueError):  # cv2.imread gives None: skipped
                continue
            im, ratio, pad = letterbox(im0, self.img_size, auto=self.auto, stride=self.stride)
            yield f, im[..., ::-1].copy(), im0, {
                "ratio": ratio, "pad": pad, "frame": 0, "mode": "image"}
        for f in self.videos:
            cv2 = _cv2_for(f)
            cap = cv2.VideoCapture(f)
            fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
            frame = 0
            while cap.isOpened():
                ok, im0 = cap.read()
                if not ok:
                    break
                if frame % self.vid_stride:
                    frame += 1
                    continue
                im, ratio, pad = letterbox(im0, self.img_size, auto=self.auto, stride=self.stride)
                yield f, im[..., ::-1].copy(), im0, {
                    "ratio": ratio, "pad": pad, "frame": frame, "mode": "video",
                    "fps": fps / self.vid_stride}
                frame += 1
            cap.release()


class LoadStreams:
    """Multi-stream source (webcam index / RTSP / HTTP video URLs) with one
    reader thread per source (reference utils/dataloaders.py:374-466).
    Yields the latest frame of every stream, letterboxed."""

    def __init__(self, sources, img_size=640, stride=32, vid_stride=1):
        import threading

        if isinstance(sources, str):
            sources = [s.strip() for s in sources.split(",") if s.strip()]
        cv2 = _cv2_for(", ".join(map(str, sources)))
        self.sources = sources
        self.img_size = img_size
        self.stride = stride
        self.vid_stride = vid_stride
        self.frames = [None] * len(sources)
        self.running = True
        self.caps = []
        self.threads = []
        # converted sources (webcam '0' -> device index 0) are kept so signal-
        # loss reopen uses the same form, not the raw string as a filename
        self.cv_sources = [int(s) if str(s).isnumeric() else s for s in sources]
        self.fps = [30.0] * len(sources)
        for i, src in enumerate(self.cv_sources):
            s = sources[i]
            cap = cv2.VideoCapture(src)
            if not cap.isOpened():
                raise ConnectionError(f"failed to open stream {s}")
            ok, frame = cap.read()
            if not ok:
                raise ConnectionError(f"failed to read from stream {s}")
            self.frames[i] = frame
            self.fps[i] = cap.get(cv2.CAP_PROP_FPS) or 30.0
            self.caps.append(cap)
            t = threading.Thread(target=self._reader, args=(i,), daemon=True)
            t.start()
            self.threads.append(t)

    def _reader(self, i):
        n = 0
        while self.running and self.caps[i].isOpened():
            n += 1
            self.caps[i].grab()
            if n % self.vid_stride == 0:
                ok, frame = self.caps[i].retrieve()
                if ok:
                    self.frames[i] = frame
                else:  # signal loss: try to reopen
                    self.caps[i].open(self.cv_sources[i])

    def close(self):
        self.running = False
        for t in self.threads:  # join before releasing: a reader inside
            t.join(timeout=2.0)  # cap.grab() at teardown segfaults cv2
        for c in self.caps:
            c.release()

    def __iter__(self):
        import time as _t

        frame = 0
        while self.running:
            for i, s in enumerate(self.sources):
                im0 = self.frames[i]
                if im0 is None:
                    continue
                im, ratio, pad = letterbox(im0, self.img_size, auto=False,
                                           stride=self.stride)
                yield str(s), im[..., ::-1].copy(), im0.copy(), {
                    "ratio": ratio, "pad": pad, "stream": i, "frame": frame,
                    "mode": "stream", "fps": self.fps[i]}
            frame += 1
            _t.sleep(0.0)


class LoadScreenshots:
    """Screen-capture source (reference utils/dataloaders.py:208-262).

    source: "screen [number] [left top width height]" — e.g. "screen 0" or
    "screen 0 100 100 512 256". Requires the optional `mss` package and a
    display; both absences produce a clear error instead of a stack trace.
    """

    def __init__(self, source, img_size=640, stride=32, auto=False):
        try:
            import mss  # optional dependency
        except ImportError as e:
            raise RuntimeError(
                f"{source}: screen capture requires the 'mss' package, which is not "
                "installed in this environment") from e
        params = str(source).split()[1:]  # drop the 'screen' token
        self.screen = int(params[0]) if params else 0
        self.img_size = img_size
        self.stride = stride
        self.auto = auto
        self.frame = 0
        try:
            self.sct = mss.mss()
        except Exception as e:  # no display server
            raise RuntimeError(f"screen capture unavailable (no display?): {e}") from e
        mon = self.sct.monitors[self.screen]
        left, top, width, height = (
            (int(params[1]), int(params[2]), int(params[3]), int(params[4]))
            if len(params) == 5 else
            (mon["left"], mon["top"], mon["width"], mon["height"]))
        self.monitor = {"left": left, "top": top, "width": width,
                        "height": height}

    def __iter__(self):
        while True:
            im0 = np.asarray(self.sct.grab(self.monitor))[..., :3]  # BGRA->BGR
            im, ratio, pad = letterbox(im0, self.img_size, auto=self.auto,
                                       stride=self.stride)
            yield (f"screen{self.screen}", im[..., ::-1].copy(), im0,
                   {"ratio": ratio, "pad": pad, "frame": self.frame})
            self.frame += 1


def batched(source, batch_size=1):
    """Group source items into fixed-size batches (pad by repeating last)."""
    buf = []
    for item in source:
        buf.append(item)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf:
        while len(buf) < batch_size:
            buf.append(buf[-1])
        yield buf
