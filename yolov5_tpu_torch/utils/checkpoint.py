"""The JAX package's ``.ckpt`` checkpoints, read and written without flax or
msgpack.

A checkpoint is a msgpack file written by ``flax.serialization`` (a tree of
{params, batch_stats, ema_params, ema_stats, ema_updates, step, ...}) and a
JSON sidecar ``<path>.json`` with cfg, names and the live anchors
(``yolov5_tpu/utils/checkpoint.py``). ``msgpack_restore`` decodes what flax
writes: nil, bool, every int and float width, str, bin, array and map in
their fix/8/16/32 forms, and flax's ext types 1 (an ndarray: a packed
(shape, dtype name, raw bytes)) and 3 (a numpy scalar). Any other type
raises. bfloat16 arrays become ``torch.bfloat16`` tensors, from their raw
bytes; every other array is a numpy array. ``msgpack_serialize`` is the
inverse, and ``save_checkpoint`` writes files that the JAX package's
``load_checkpoint`` reads: the same payload keys in the JAX layout, the
same meta. The port's optimizer state goes under a key of its own,
``torch_opt_state``; the JAX package's optax state (``opt_state``) cannot be
resumed here and raises.
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


def _pack_len(out: list, n: int, fix_base, fix_max, wide):
    """A length header: the fix form under fix_max, else the 8/16/32-bit one."""
    if fix_base is not None and n < fix_max:
        out.append(struct.pack(">B", fix_base | n))
        return
    for code, fmt, limit in wide:
        if n < limit:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"msgpack: length {n} is too long")


_ARR = ((0xDC, "H", 1 << 16), (0xDD, "I", 1 << 32))
_MAP = ((0xDE, "H", 1 << 16), (0xDF, "I", 1 << 32))
_STR = ((0xD9, "B", 1 << 8), (0xDA, "H", 1 << 16), (0xDB, "I", 1 << 32))
_BIN = ((0xC4, "B", 1 << 8), (0xC5, "H", 1 << 16), (0xC6, "I", 1 << 32))
_EXT = ((0xC7, "B", 1 << 8), (0xC8, "H", 1 << 16), (0xC9, "I", 1 << 32))


def _pack_int(out: list, v: int):
    if 0 <= v < 0x80:
        out.append(struct.pack(">B", v))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, limit in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16),
                                 (0xCE, "I", 1 << 32), (0xCF, "Q", 1 << 64)):
            if v < limit:
                out.append(struct.pack(">B" + fmt, code, v))
                return
        raise ValueError(f"msgpack: int {v} is too large")
    else:
        for code, fmt, limit in ((0xD0, "b", 1 << 7), (0xD1, "h", 1 << 15),
                                 (0xD2, "i", 1 << 31), (0xD3, "q", 1 << 63)):
            if v >= -limit:
                out.append(struct.pack(">B" + fmt, code, v))
                return
        raise ValueError(f"msgpack: int {v} is too small")


def _array_payload(a) -> bytes:
    """flax's ndarray payload: msgpack of (shape, dtype name, C-order bytes)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return packb([list(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()])
        a = t.numpy()
    a = np.asarray(a)
    if a.dtype.hasobject:
        raise ValueError("msgpack: object arrays are not written")
    return packb([list(a.shape), a.dtype.name, a.tobytes()])


def _encode(out: list, obj):
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, _STR)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, _BIN)
        out.append(bytes(obj))
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, _MAP)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise ValueError(f"msgpack: map key of type {type(k).__name__}; keys are str")
            _encode(out, k)
            _encode(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, _ARR)
        for v in obj:
            _encode(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor, np.generic)):
        code = _EXT_NPSCALAR if isinstance(obj, np.generic) else _EXT_NDARRAY
        payload = _array_payload(np.asarray(obj) if isinstance(obj, np.generic) else obj)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(struct.pack(">B", fixext[n]))
        else:
            _pack_len(out, n, None, 0, _EXT)
        out.append(struct.pack(">b", code))
        out.append(payload)
    else:
        raise ValueError(f"msgpack: cannot write a {type(obj).__name__}")


def packb(obj) -> bytes:
    """One msgpack object: the inverse of ``unpackb`` for None, bool, int,
    float (as float64), str, bytes, lists and tuples, str-keyed dicts, and
    numpy arrays, numpy scalars and tensors as flax's ext types."""
    out = []
    _encode(out, obj)
    return b"".join(out)


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_sorted(v) for v in tree]
    return tree


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts, lists,
    scalars and arrays (numpy or torch; bfloat16 as flax writes it): the
    same bytes, maps in sorted key order as flax's tree flattening leaves
    them."""
    return packb(_sorted(tree))


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


def anchors_to_yaml(anchors):
    """Nested ((w,h),...) per level -> YAML-style flat [w,h,w,h,...] lists."""
    return [[round(float(v), 5) for pair in lvl for v in pair] for lvl in anchors]


def _numpy_tree(tensors: dict) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in tensors.items()}


def save_checkpoint(path, state, epoch=-1, best_fitness=0.0, extra=None, include_opt=False):
    """Write ``state`` (a ``train.trainer.TrainState``) to <path> (msgpack)
    and <path>.json (meta), in the JAX package's format: params and
    batch_stats, the EMA's, ema_updates and step in the JAX layout, so that
    ``yolov5_tpu.utils.checkpoint.load_checkpoint`` reads the file.
    ``include_opt`` adds the port's optimizer state under ``torch_opt_state``
    (last.ckpt, for --resume); without it the file is the stripped
    inference artifact (best.ckpt)."""
    from yolov5_tpu_torch.models.weights import to_jax_variables
    from yolov5_tpu_torch.train.trainer import batch_stats

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    model = state.model
    live = to_jax_variables({**_numpy_tree(dict(model.named_parameters())),
                             **_numpy_tree(batch_stats(model))})
    ema = to_jax_variables({**_numpy_tree(state.ema.params), **_numpy_tree(state.ema.batch_stats)})
    payload = {
        "params": live["params"], "batch_stats": live.get("batch_stats", {}),
        "ema_params": ema["params"], "ema_stats": ema.get("batch_stats", {}),
        "ema_updates": int(state.ema.updates), "step": int(state.step),
    }
    if include_opt:
        opt = state.opt.state_dict()
        payload["torch_opt_state"] = {k: (_numpy_tree(v) if isinstance(v, dict) else v)
                                      for k, v in opt.items()}
    path.write_bytes(msgpack_serialize(payload))
    meta = {
        "epoch": epoch,
        "best_fitness": float(best_fitness),
        "cfg": model.cfg if isinstance(model.cfg, dict) else str(model.cfg),
        "nc": model.nc,
        "names": {int(k): v for k, v in model.names.items()},
        "stride": list(model.stride),
        # the live anchors, not the cfg's: autoanchor may have evolved them
        # (a classifier has none)
        "anchors": anchors_to_yaml(getattr(model, "anchors", ())),
        "format": "yolov5_tpu-ckpt-v1",
    }
    if extra:
        meta.update(extra)
    Path(str(path) + ".json").write_text(json.dumps(meta, indent=1, default=str))


def strip_optimizer(path, out=None):
    """Drop the optimizer state (the JAX package's or the port's) from a
    checkpoint and mark it finished (meta epoch -1): the reference's
    strip_optimizer. Rewrites in place unless ``out`` is given; returns the
    output path."""
    path = Path(path)
    payload = msgpack_restore(path.read_bytes())
    before = path.stat().st_size
    payload.pop("opt_state", None)
    payload.pop("torch_opt_state", None)
    out = Path(out) if out else path
    out.write_bytes(msgpack_serialize(payload))
    meta_path = Path(str(path) + ".json")
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        meta["epoch"] = -1
        Path(str(out) + ".json").write_text(json.dumps(meta, indent=1, default=str))
    print(f"strip_optimizer: {path} {before / 1e6:.1f}MB -> {out.stat().st_size / 1e6:.1f}MB")
    return out


@torch.no_grad()
def restore_train_state(state, payload):
    """Load a checkpoint payload into ``state`` (a TrainState) in place and
    return it: params and batch stats into the model, the EMA (params,
    stats, updates), the step, and, when the file has it, the port's
    optimizer state (momentum or Adam moments, accumulation, counters).

    A payload with the JAX package's optax ``opt_state`` and no port state
    raises: its momentum buffers are not mapped to the port's, and resuming
    with fresh ones would silently change the run. A file without optimizer
    state (best.ckpt, or one written without it) restores the rest and
    keeps the optimizer as it is."""
    from yolov5_tpu_torch.models.weights import from_jax_variables
    from yolov5_tpu_torch.train.optim import EMAState
    from yolov5_tpu_torch.train.trainer import batch_stats

    if payload.get("opt_state") is not None and payload.get("torch_opt_state") is None:
        raise ValueError(
            "this checkpoint holds the JAX package's optax optimizer state (opt_state); "
            "the port cannot resume it. Start a new run from its weights (--weights) "
            "instead of --resume.")
    model = state.model
    own = {**dict(model.named_parameters()), **batch_stats(model)}
    live = from_jax_variables({"params": payload["params"],
                               "batch_stats": payload["batch_stats"]})
    missing = sorted(set(own) - set(live))
    if missing:
        raise ValueError(f"checkpoint does not match the model: missing {missing[:5]}")
    for k, v in own.items():
        v.copy_(live[k])
    ema_vars = from_jax_variables({
        "params": payload.get("ema_params") or payload["params"],
        "batch_stats": payload.get("ema_stats") or payload["batch_stats"]})
    dev = next(model.parameters()).device
    params = {k: ema_vars[k].to(dev) for k in dict(model.named_parameters())}
    stats = {k: ema_vars[k].to(dev) for k in batch_stats(model)}
    state.ema = EMAState(params, stats, int(payload.get("ema_updates", 0)))
    state.step = int(payload.get("step", 0))
    if payload.get("torch_opt_state") is not None:
        state.opt.load_state_dict(payload["torch_opt_state"])
    return state
