"""Training loggers: console + CSV always; TensorBoard and the cloud sinks
(W&B / ClearML / Comet) when their SDKs are importable.

The port of ``yolov5_tpu/utils/loggers.py``. It mirrors the reference
fan-out (utils/loggers/__init__.py): each cloud logger is enabled by a
successful import, as the reference's ``try: import wandb ... except: wandb
= None`` does, and disabled with YOLOV5_TPU_LOGGERS=off (or a comma list
naming the ones to keep). The SDKs need the network at run time; the tests
drive them through fake modules and hold ``results.csv`` byte-equal to the
JAX package's and the SDK calls equal to its calls. It differs from the JAX
module in two ways, on purpose:

- ``TBLogger`` writes the TensorBoard event file itself (``EventWriter``:
  the protobuf records with their CRC-32C framing), without the
  ``tensorboard`` package, whose import loads TensorFlow;
- a sink whose SDK raises while it starts (wandb without an API key) is
  left out with a warning, where the JAX package's run stops.
"""

from __future__ import annotations

import csv
import os
import struct
import time
from pathlib import Path

COMET_PREFIX = "comet://"
CLEARML_PREFIX = "clearml://"
WANDB_PREFIX = "wandb-artifact://"


def check_comet_resume(resume, project="runs/train"):
    """``--resume comet://workspace/project/experiment[?checkpoint.ckpt]``:
    rehydrate a run from Comet — fetch the experiment's logged ``opt.yaml``
    (the run's full config) and download its newest model checkpoint
    (reference utils/loggers/comet/comet_utils.py:21-120
    check_comet_resume / set_opt_parameters / download_model_checkpoint).

    Returns ``(opt_dict, ckpt_path)`` or None when the URI is not comet://.
    """
    if not (isinstance(resume, str) and resume.startswith(COMET_PREFIX)):
        return None
    import comet_ml
    import yaml as _yaml
    from urllib.parse import urlparse

    api = comet_ml.API()
    res = urlparse(resume)
    experiment = api.get(f"{res.netloc}{res.path}")

    opt_dict = {}
    assets = {a["fileName"]: a["assetId"] for a in experiment.get_asset_list()}
    if "opt.yaml" in assets:
        opt_dict = _yaml.safe_load(
            experiment.get_asset(assets["opt.yaml"], return_type="binary",
                                 stream=False)) or {}

    # newest checkpoint asset; ?query selects a specific filename
    wanted = res.query or "last.ckpt"
    models = sorted(experiment.get_model_asset_list("yolov5_tpu"),
                    key=lambda a: a.get("step") or 0, reverse=True)
    by_name = {}
    for a in models:  # newest step wins for duplicate filenames
        by_name.setdefault(a["fileName"], a["assetId"])
    asset_id = by_name.get(wanted)
    if asset_id is None and not res.query and models:
        # only the default 'last.ckpt' may fall back to the newest asset; an
        # explicitly ?query-named checkpoint must exist or the user would
        # silently resume from a different one
        asset_id = models[0]["assetId"]
    if asset_id is None:
        raise FileNotFoundError(
            f"comet resume: no checkpoint asset '{wanted}' in {resume}")
    out_dir = Path(project) / experiment.name
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = out_dir / wanted
    ckpt.write_bytes(
        experiment.get_asset(asset_id, return_type="binary", stream=False))
    return opt_dict, str(ckpt)


def check_wandb_resume(resume, project="runs/train"):
    """``--resume wandb-artifact://entity/project/run_<id>_model:alias``:
    download the run's model artifact and resume from its last.ckpt
    (the reference's historic wandb-artifact resume,
    utils/loggers/wandb/wandb_utils.py). Returns a ckpt path or None."""
    if not (isinstance(resume, str) and resume.startswith(WANDB_PREFIX)):
        return None
    import wandb

    art = wandb.Api().artifact(resume[len(WANDB_PREFIX):], type="model")
    d = Path(art.download(root=str(Path(project) / "wandb_artifact")))
    for name in ("last.ckpt", "best.ckpt"):
        if (d / name).exists():
            return str(d / name)
    ckpts = sorted(d.glob("*.ckpt"))
    if not ckpts:
        raise FileNotFoundError(f"no .ckpt file inside artifact {resume}")
    return str(ckpts[0])


def construct_clearml_dataset(uri):
    """``--data clearml://<dataset_id>``: materialize a ClearML dataset
    version locally and return its resolved data_dict (reference
    utils/loggers/clearml/clearml_utils.py:41-81 construct_dataset)."""
    from clearml import Dataset

    root = Path(Dataset.get(dataset_id=uri[len(CLEARML_PREFIX):])
                .get_local_copy())
    yamls = sorted(list(root.glob("*.yaml")) + list(root.glob("*.yml")))
    if len(yamls) != 1:
        raise ValueError(
            f"clearml dataset must hold exactly one root yaml definition, "
            f"found {len(yamls)} in {root}")
    import yaml as _yaml

    d = _yaml.safe_load(yamls[0].read_text())
    missing = {"train", "val"} - set(k for k in d if d.get(k))
    if missing or not ({"nc", "names"} & set(d)):
        raise ValueError(
            f"clearml dataset yaml needs train/val + nc|names; missing {missing}")
    out = {"nc": d.get("nc"), "names": d.get("names"), "path": str(root)}
    for split in ("train", "val", "test"):
        out[split] = str((root / d[split]).resolve()) if d.get(split) else None
    return {k: v for k, v in out.items() if v is not None}


class CSVLogger:
    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._keys = None
        # resume: adopt the existing header instead of appending a second
        # one mid-file (which would break plot_results on resumed runs)
        if self.path.exists():
            try:
                with open(self.path, newline="") as f:
                    first = f.readline().strip()
                if first:
                    self._keys = [k.strip() for k in first.split(",")]
            except OSError:
                pass

    def log(self, row: dict):
        write_header = self._keys is None
        if write_header:
            self._keys = list(row.keys())
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._keys, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames its records."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_CRC32C = [0] * 256
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC32C[_i] = _c


def _masked_crc(data: bytes) -> bytes:
    crc = _crc32c(data)
    return struct.pack("<I", (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:  # a length-delimited protobuf field
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _event(step: int, wall_time: float, summary: bytes = b"", file_version: str = "") -> bytes:
    """A serialized ``tensorboard.Event``: wall_time (1), step (2),
    file_version (3) or summary (5)."""
    out = b"\x09" + struct.pack("<d", wall_time) + b"\x10" + _varint(step)
    if file_version:
        out += _field(3, file_version.encode())
    if summary:
        out += _field(5, summary)
    return out


class EventWriter:
    """A TensorBoard event file of scalars: TFRecord-framed ``Event``
    protobufs, the format ``torch.utils.tensorboard.SummaryWriter`` writes.
    It is written here because that writer loads TensorFlow where TensorFlow
    is installed, and TensorFlow 2.21 imports JAX
    (tensorflow/lite/python/util.py), which the port does not load."""

    def __init__(self, log_dir):
        import socket

        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self.path = log_dir / (f"events.out.tfevents.{int(time.time())}."
                               f"{socket.gethostname()}.{os.getpid()}.0")
        self._write([_event(0, time.time(), file_version="brain.Event:2")])

    def _write(self, events):
        """Append TFRecords: length, its masked CRC, the data, its masked CRC."""
        with open(self.path, "ab") as f:
            for data in events:
                head = struct.pack("<Q", len(data))
                f.write(head + _masked_crc(head) + data + _masked_crc(data))

    def add_scalars(self, row: dict, step: int):
        """One event per scalar (a Summary.Value with tag (1) and
        simple_value (2)), as ``SummaryWriter.add_scalar`` writes them."""
        now = time.time()
        self._write([_event(step, now, summary=_field(1, _field(1, str(k).encode())
                                                      + b"\x15" + struct.pack("<f", v)))
                     for k, v in row.items()])

    def close(self):
        pass


class TBLogger:
    def __init__(self, log_dir):
        try:
            self.writer = EventWriter(log_dir)
        except OSError:
            self.writer = None

    def log(self, row: dict, step: int):
        if self.writer is None:
            return
        self.writer.add_scalars({k: v for k, v in row.items() if isinstance(v, (int, float))},
                                step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


class WandbLogger:
    """Weights & Biases sink (reference utils/loggers/wandb logic): run per
    training, scalar metrics per epoch, final checkpoint as an artifact."""

    def __init__(self, save_dir, config=None):
        try:
            import wandb
        except ImportError:
            self.run = None
            return
        self.wandb = wandb
        self.run = wandb.run or wandb.init(
            project=Path(save_dir).parent.name or "yolov5_tpu",
            name=Path(save_dir).name, config=config or {})

    def log(self, row: dict, step: int):
        if self.run:
            self.run.log(dict(row), step=step)

    def log_model(self, ckpt_path, epoch=None, fitness=None, best=False,
                  opt=None):
        """Checkpoint as a versioned model artifact with training metadata
        and latest/last/best/epoch-N aliases (reference
        utils/loggers/wandb/wandb_utils.py:96-130 log_model)."""
        if not self.run:
            return
        opt = opt or {}
        art = self.wandb.Artifact(
            f"run_{self.run.id}_model", type="model",
            metadata={
                "original_url": str(ckpt_path),
                "epochs_trained": None if epoch is None else epoch + 1,
                "total_epochs": opt.get("epochs"),
                "save period": opt.get("save_period"),
                "project": opt.get("project"),
                "fitness_score": fitness,
            })
        art.add_file(str(ckpt_path), name="last.ckpt")
        aliases = ["latest", "last"]
        if epoch is not None:
            aliases.append(f"epoch {epoch}")
        if best:
            aliases.append("best")
        self.run.log_artifact(art, aliases=aliases)

    def log_dataset(self, data_dict, yaml_file=None):
        """Dataset version as an artifact: the yaml definition plus the split
        directories (reference wandb_utils.py log_dataset_artifact role, the
        --upload-dataset path)."""
        if not self.run:
            return
        art = self.wandb.Artifact(
            f"run_{self.run.id}_dataset", type="dataset",
            metadata={"nc": data_dict.get("nc"),
                      "names": data_dict.get("names")})
        if yaml_file and Path(yaml_file).exists():
            art.add_file(str(yaml_file), name=Path(yaml_file).name)
        for split in ("train", "val", "test"):
            v = data_dict.get(split)
            for p in ([v] if isinstance(v, (str, Path)) else (v or [])):
                if Path(p).is_dir():
                    art.add_dir(str(p), name=split)
        self.run.log_artifact(art)

    def close(self):
        if self.run:
            self.run.finish()


class ClearmlLogger:
    """ClearML sink (reference utils/loggers/clearml logic)."""

    def __init__(self, save_dir, config=None):
        try:
            from clearml import Task
        except ImportError:
            self.task = None
            return
        self.task = Task.init(project_name="yolov5_tpu",
                              task_name=Path(save_dir).name,
                              auto_connect_frameworks=False)
        if config:
            self.task.connect(dict(config))

    def log(self, row: dict, step: int):
        if self.task:
            logger = self.task.get_logger()
            for k, v in row.items():
                if isinstance(v, (int, float)):
                    title, _, series = k.partition("/")
                    logger.report_scalar(title, series or title, v, step)

    def log_model(self, ckpt_path, epoch=None, fitness=None, best=False,
                  opt=None):
        if self.task:
            name = ("Best Model" if best else
                    f"Checkpoint epoch {epoch}" if epoch is not None else None)
            self.task.update_output_model(model_path=str(ckpt_path),
                                          model_name=name, auto_delete_file=False)

    def log_dataset(self, data_dict, yaml_file=None):
        """Record the dataset definition on the task config; versioned
        dataset CONSUMPTION is the clearml:// --data path
        (construct_clearml_dataset above)."""
        if self.task:
            self.task.connect_configuration(
                {k: str(v) for k, v in data_dict.items()}, name="dataset")

    def close(self):
        if self.task:
            self.task.close()


class CometLogger:
    """Comet sink (reference utils/loggers/comet logic)."""

    def __init__(self, save_dir, config=None):
        try:
            import comet_ml
        except ImportError:
            self.exp = None
            return
        self.exp = comet_ml.Experiment(project_name="yolov5_tpu")
        self.exp.set_name(Path(save_dir).name)
        if config:
            self.exp.log_parameters(dict(config))

    def log(self, row: dict, step: int):
        if self.exp:
            self.exp.log_metrics(
                {k: v for k, v in row.items() if isinstance(v, (int, float))},
                step=step)

    def log_model(self, ckpt_path, epoch=None, fitness=None, best=False,
                  opt=None):
        """Checkpoint under the model registry name check_comet_resume
        downloads from; file_name + step let the resume pick the newest
        (reference utils/loggers/comet/__init__.py log_model)."""
        if self.exp:
            self.exp.log_model("yolov5_tpu", str(ckpt_path),
                               file_name=Path(ckpt_path).name,
                               metadata={"epoch": epoch, "fitness": fitness,
                                         "best": best})

    def log_asset(self, path):
        """opt.yaml / hyp.yaml as assets — what set_opt_parameters reads back
        on comet:// resume."""
        if self.exp:
            self.exp.log_asset(str(path))

    def log_dataset(self, data_dict, yaml_file=None):
        if self.exp:
            self.exp.log_others({f"data/{k}": str(v)
                                 for k, v in data_dict.items()})
            if yaml_file and Path(yaml_file).exists():
                self.exp.log_asset(str(yaml_file))

    def close(self):
        if self.exp:
            self.exp.end()


_CLOUD = {"wandb": WandbLogger, "clearml": ClearmlLogger, "comet": CometLogger}


def _enabled_cloud():
    import os

    spec = os.environ.get("YOLOV5_TPU_LOGGERS", "").strip().lower()
    if spec in ("off", "none", "0"):
        return {}
    if spec:
        return {k: v for k, v in _CLOUD.items() if k in spec.split(",")}
    return dict(_CLOUD)  # default: anything importable


class Loggers:
    """Facade over console/CSV/TB + importable cloud sinks, driven by the
    callback bus."""

    def __init__(self, save_dir, enable_tb=True, config=None):
        self.save_dir = Path(save_dir)
        self.csv = CSVLogger(self.save_dir / "results.csv")
        self.tb = TBLogger(self.save_dir) if enable_tb else None
        self.cloud = []
        for cls in _enabled_cloud().values():
            try:
                sink = cls(save_dir, config=config)
            except Exception as e:  # an SDK without credentials must not stop training
                print(f"WARNING: {cls.__name__} off: {type(e).__name__}: {e}")
                continue
            if (getattr(sink, "run", None) or getattr(sink, "task", None)
                    or getattr(sink, "exp", None)):
                self.cloud.append(sink)

    def log_metrics(self, row: dict, step: int):
        self.csv.log({"step": step, **row})
        if self.tb:
            self.tb.log(row, step)
        for sink in self.cloud:
            sink.log(row, step)

    def log_model(self, ckpt_path, epoch=None, fitness=None, best=False,
                  opt=None):
        for sink in self.cloud:
            sink.log_model(ckpt_path, epoch=epoch, fitness=fitness,
                           best=best, opt=opt)

    def log_dataset(self, data_dict, yaml_file=None):
        for sink in self.cloud:
            if hasattr(sink, "log_dataset"):
                sink.log_dataset(data_dict, yaml_file=yaml_file)

    def log_asset(self, path):
        for sink in self.cloud:
            if hasattr(sink, "log_asset"):
                sink.log_asset(path)

    def close(self):
        if self.tb:
            self.tb.close()
        for sink in self.cloud:
            sink.close()
