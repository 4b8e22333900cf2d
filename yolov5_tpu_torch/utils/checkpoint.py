"""Reading the JAX package's ``.ckpt`` checkpoints without flax or msgpack.

A checkpoint is a msgpack file written by ``flax.serialization`` (a tree of
{params, batch_stats, ema_params, ema_stats, ...}) and a JSON sidecar
``<path>.json`` with cfg, names and the live anchors
(``yolov5_tpu/utils/checkpoint.py``). ``msgpack_restore`` decodes what flax
writes: nil, bool, every int and float width, str, bin, array and map in
their fix/8/16/32 forms, and flax's ext types 1 (an ndarray: a packed
(shape, dtype name, raw bytes)) and 3 (a numpy scalar). Any other type
raises. bfloat16 arrays become ``torch.bfloat16`` tensors, from their raw
bytes; every other array is a numpy array. Saving comes with training.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"  # flax's form of arrays over 1 GiB


class _Reader:
    """A cursor over msgpack bytes."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (need {n} more)")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-width scalars: type byte -> struct format (big-endian)
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# type byte -> (kind, length format) for the 8/16/32 forms
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _decode(r: _Reader, ext_hook):
    t = r.take(1)[0]
    if t <= 0x7F:
        return t
    if t >= 0xE0:
        return t - 0x100
    if 0x80 <= t <= 0x8F:
        return _decode_map(r, t & 0x0F, ext_hook)
    if 0x90 <= t <= 0x9F:
        return [_decode(r, ext_hook) for _ in range(t & 0x0F)]
    if 0xA0 <= t <= 0xBF:
        return str(r.take(t & 0x1F), "utf-8")
    if t == 0xC0:
        return None
    if t in (0xC2, 0xC3):
        return t == 0xC3
    if t in _SCALARS:
        return r.unpack(_SCALARS[t])
    if t in _FIXEXT:
        code = r.unpack(">b")
        return ext_hook(code, bytes(r.take(_FIXEXT[t])))
    if t in _SIZED:
        kind, fmt = _SIZED[t]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return str(r.take(n), "utf-8")
        if kind == "array":
            return [_decode(r, ext_hook) for _ in range(n)]
        if kind == "map":
            return _decode_map(r, n, ext_hook)
        code = r.unpack(">b")
        return ext_hook(code, bytes(r.take(n)))
    raise ValueError(f"msgpack: type byte 0x{t:02x} at {r.pos - 1} is not valid msgpack")


def _decode_map(r: _Reader, n: int, ext_hook):
    out = {}
    for _ in range(n):
        k = _decode(r, ext_hook)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"msgpack: map key of type {type(k).__name__}; only str "
                             "and bytes keys are read")
        out[k] = _decode(r, ext_hook)
    return out


def unpackb(data: bytes, ext_hook=None):
    """Decode one msgpack object that fills ``data``. ``ext_hook(code,
    payload)`` decodes ext types; without one, any ext type raises."""
    def no_ext(code, _):
        raise ValueError(f"msgpack: ext type {code} is not read")

    r = _Reader(data)
    out = _decode(r, ext_hook or no_ext)
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the object")
    return out


def _ndarray(payload: bytes):
    shape, dtype_name, raw = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        flat = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
        return flat.reshape(tuple(shape))
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)


def _flax_ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        a = _ndarray(payload)
        return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"msgpack: ext type {code} is not one flax writes for arrays")


def _unchunk(tree):
    """Reassemble flax's chunked form of very large arrays, in place."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        for k, v in tree.items():
            tree[k] = _unchunk(v)
    return tree


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` gives for ``data``,
    with bfloat16 arrays as ``torch.bfloat16`` tensors."""
    return _unchunk(unpackb(data, ext_hook=_flax_ext))


def load_checkpoint(path):
    """Returns (payload dict of numpy trees, meta dict)."""
    path = Path(path)
    payload = msgpack_restore(path.read_bytes())
    meta_path = Path(str(path) + ".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return payload, meta


def variables_from_checkpoint(payload, prefer_ema=True):
    """Model variables from a checkpoint, the EMA ones when present and
    ``prefer_ema`` (the reference attempt_load's ema-or-model selection)."""
    if prefer_ema and payload.get("ema_params") is not None:
        return {"params": payload["ema_params"], "batch_stats": payload["ema_stats"]}
    return {"params": payload["params"], "batch_stats": payload["batch_stats"]}


def anchors_from_yaml(flat):
    """YAML-style flat lists -> nested ((w,h),...) tuples per level."""
    return tuple(tuple(zip(a[0::2], a[1::2])) for a in flat)
