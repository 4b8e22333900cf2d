"""The port's training loggers (``yolov5_tpu_torch.utils.loggers``) against
the JAX package's (``yolov5_tpu.utils.loggers``): the CSV sink byte for
byte, the TensorBoard sink's event file, and the W&B, ClearML and Comet
sinks, resumes and datasets driven through fake SDK modules in
``sys.modules`` (the real SDKs need the network). Each cloud case runs the
same calls through both modules and compares what the fake SDKs saw."""

import shutil
import sys
import types
from pathlib import Path

import pytest
import yaml

from yolov5_tpu.utils import loggers as JL
from yolov5_tpu_torch.utils import loggers as PL

ROWS = [{"train/box": 0.125, "train/obj": 0.0625, "val/map50": 0.5, "fitness": 0.25},
        {"train/box": 0.1, "train/obj": 0.05, "val/map50": 0.625, "fitness": 0.3333333333333333}]


def test_csv_logger_byte_equal_to_jax(tmp_path):
    for mod in (PL, JL):
        log = mod.CSVLogger(tmp_path / mod.__name__ / "r.csv")
        log.log({"a": 1, "b": 2.5})
        log.log({"a": 2, "b": 3.5, "c": "dropped"})
        # a resumed run adopts the header instead of writing a second one
        mod.CSVLogger(tmp_path / mod.__name__ / "r.csv").log({"a": 3, "b": 4.5})
    got = (tmp_path / PL.__name__ / "r.csv").read_bytes()
    assert got == (tmp_path / JL.__name__ / "r.csv").read_bytes()
    assert got.decode().splitlines() == ["a,b", "1,2.5", "2,3.5", "3,4.5"]


def test_results_csv_byte_equal_to_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("YOLOV5_TPU_LOGGERS", "off")
    for mod in (PL, JL):
        lg = mod.Loggers(tmp_path / mod.__name__, enable_tb=False)
        for step, row in enumerate(ROWS):
            lg.log_metrics(row, step)
        lg.close()
    got = (tmp_path / PL.__name__ / "results.csv").read_bytes()
    assert got == (tmp_path / JL.__name__ / "results.csv").read_bytes()
    assert got.decode().splitlines()[0] == "step,train/box,train/obj,val/map50,fitness"


def test_tensorboard_event_file_is_readable(tmp_path, monkeypatch):
    """The TB sink writes one scalar series per numeric key, readable by
    TensorBoard's own event reader; strings are skipped. It needs neither
    the ``tensorboard`` package nor TensorFlow (which imports JAX), so the
    run that writes it loads no JAX."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    monkeypatch.setenv("YOLOV5_TPU_LOGGERS", "off")
    for name in ("tensorboard", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, name, None)
    lg = PL.Loggers(tmp_path / "exp")
    assert lg.tb is not None and lg.tb.writer is not None
    for step, row in enumerate(ROWS):
        lg.log_metrics({**row, "note": "text"}, step)
    lg.close()
    monkeypatch.undo()
    events = list((tmp_path / "exp").glob("events.out.tfevents.*"))
    assert len(events) == 1
    acc = EventAccumulator(str(tmp_path / "exp"))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == sorted(ROWS[0])
    for k in ROWS[0]:
        got = [(e.step, e.value) for e in acc.Scalars(k)]
        assert got == [(s, pytest.approx(r[k], rel=1e-7)) for s, r in enumerate(ROWS)], k


def test_event_records_are_framed_as_tfrecords(tmp_path):
    """Each record: length (u64), masked CRC-32C of it, the Event, masked
    CRC-32C of the Event (CRC-32C of b"123456789" is 0xE3069283)."""
    import struct

    assert PL._crc32c(b"123456789") == 0xE3069283
    w = PL.EventWriter(tmp_path)
    w.add_scalars({"x": 1.5}, 7)
    raw = w.path.read_bytes()
    records = []
    while raw:
        (n,) = struct.unpack("<Q", raw[:8])
        assert raw[8:12] == PL._masked_crc(raw[:8])
        data = raw[12:12 + n]
        assert raw[12 + n:16 + n] == PL._masked_crc(data)
        records.append(data)
        raw = raw[16 + n:]
    assert len(records) == 2 and b"brain.Event:2" in records[0]
    assert records[1].endswith(b"\x15" + struct.pack("<f", 1.5)) and b"\x10\x07" in records[1]


def fake_sdks(monkeypatch, events):
    """Fake wandb, clearml and comet_ml modules recording their calls."""
    wandb = types.ModuleType("wandb")
    wandb.run = None

    class _Run:
        id = "abc"

        def log(self, row, step=None):
            events.append(("wandb.log", dict(row), step))

        def log_artifact(self, art, aliases=None):
            events.append(("wandb.artifact", art.type, art.files, art.metadata, aliases))

        def finish(self):
            events.append(("wandb.finish",))

    class _Art:
        def __init__(self, name, type, metadata=None):
            self.name, self.type, self.metadata = name, type, metadata or {}
            self.files = []

        def add_file(self, p, name=None):
            self.files.append((Path(p).name, name))

        def add_dir(self, p, name=None):
            self.files.append((Path(p).name, name))

    wandb.init = lambda **kw: (events.append(("wandb.init", kw)), _Run())[1]
    wandb.Artifact = _Art

    clearml = types.ModuleType("clearml")

    class _TaskLogger:
        def report_scalar(self, title, series, v, step=None, iteration=None):
            events.append(("clearml.scalar", title, series, v, step, iteration))

    class _Task:
        @staticmethod
        def init(**kw):
            events.append(("clearml.init", kw))
            return _Task()

        def connect(self, cfg, name=None):
            events.append(("clearml.connect", dict(cfg), name))

        def get_logger(self):
            return _TaskLogger()

        def update_output_model(self, model_path, model_name=None, auto_delete_file=True):
            events.append(("clearml.model", Path(model_path).name, model_name))

        def connect_configuration(self, cfg, name=None):
            events.append(("clearml.dataset", sorted(cfg), name))

        def close(self):
            events.append(("clearml.close",))

    clearml.Task = _Task

    comet = types.ModuleType("comet_ml")

    class _Exp:
        def __init__(self, **kw):
            events.append(("comet.init", kw))

        def set_name(self, n):
            events.append(("comet.name", n))

        def log_parameters(self, p):
            events.append(("comet.params", dict(p)))

        def log_metrics(self, m, step=None):
            events.append(("comet.metrics", dict(m), step))

        def log_model(self, name, path, file_name=None, metadata=None):
            events.append(("comet.model", name, Path(path).name, file_name, metadata))

        def log_asset(self, path):
            events.append(("comet.asset", Path(path).name))

        def log_others(self, d):
            events.append(("comet.others", sorted(d)))

        def end(self):
            events.append(("comet.end",))

    comet.Experiment = _Exp
    for name, mod in (("wandb", wandb), ("clearml", clearml), ("comet_ml", comet)):
        monkeypatch.setitem(sys.modules, name, mod)


def _drive(mod, root):
    """Every facade call a training run makes, through ``mod``."""
    save = root / "runs" / "exp"
    lg = mod.Loggers(save, enable_tb=False, config={"lr0": 0.01})
    n = len(lg.cloud)
    for step, row in enumerate(ROWS):
        lg.log_metrics({**row, "note": "str-skipped"}, step)
    (root / "data.yaml").write_text("train: images\n")
    (root / "images").mkdir(exist_ok=True)
    lg.log_dataset({"train": str(root / "images"), "nc": 2, "names": {0: "a", 1: "b"}},
                   yaml_file=root / "data.yaml")
    (save / "opt.yaml").write_text("epochs: 3\n")
    lg.log_asset(save / "opt.yaml")
    ckpt = save / "last.ckpt"
    ckpt.write_bytes(b"x")
    lg.log_model(ckpt, epoch=2, fitness=0.42, best=True, opt={"epochs": 3, "project": "p"})
    lg.log_model(ckpt)
    lg.close()
    return n


@pytest.mark.parametrize("keep", ["", "off", "comet", "wandb,clearml"])
def test_cloud_sinks_match_jax_with_fake_sdks(monkeypatch, tmp_path, keep):
    """Each cloud sink activates when its SDK imports, unless
    YOLOV5_TPU_LOGGERS leaves it out; the SDKs see the same calls from the
    port's facade as from the JAX package's."""
    monkeypatch.setenv("YOLOV5_TPU_LOGGERS", keep)
    seen = {}
    for mod in (PL, JL):  # in one directory, as the artifacts carry their paths
        events = []
        fake_sdks(monkeypatch, events)
        n = _drive(mod, tmp_path)
        shutil.rmtree(tmp_path / "runs")
        seen[mod] = (n, events)
    assert seen[PL] == seen[JL]
    n, events = seen[PL]
    assert n == {"": 3, "off": 0, "comet": 1, "wandb,clearml": 2}[keep]
    if keep == "":
        assert ("wandb.log", {**ROWS[1], "note": "str-skipped"}, 1) in events
        assert ("clearml.scalar", "val", "map50", 0.625, 1, None) in events
        assert ("comet.metrics", ROWS[0], 0) in events
        assert ("comet.asset", "opt.yaml") in events
        aliases = [e[4] for e in events if e[:2] == ("wandb.artifact", "model")]
        assert set(aliases[0]) == {"latest", "last", "epoch 2", "best"}
        assert ("wandb.finish",) in events and ("comet.end",) in events


def test_sinks_are_inert_without_their_sdks(monkeypatch, tmp_path):
    for name in ("wandb", "clearml", "comet_ml"):
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.delenv("YOLOV5_TPU_LOGGERS", raising=False)
    lg = PL.Loggers(tmp_path / "exp", enable_tb=False)
    assert lg.cloud == []
    lg.log_model(tmp_path / "none.ckpt")
    lg.log_dataset({"train": "x"})
    lg.close()


def test_a_sink_that_fails_to_start_is_left_out(monkeypatch, tmp_path, capsys):
    """wandb installed without an API key raises in ``wandb.init``: the
    port's facade leaves that sink out with a warning and keeps the others,
    where the JAX package's stops the run (ROADMAP.md, section 3)."""
    events = []
    fake_sdks(monkeypatch, events)

    def no_key(**kw):
        raise RuntimeError("No API key configured")

    sys.modules["wandb"].init = no_key
    monkeypatch.delenv("YOLOV5_TPU_LOGGERS", raising=False)
    lg = PL.Loggers(tmp_path / "runs" / "exp", enable_tb=False)
    assert [type(c).__name__ for c in lg.cloud] == ["ClearmlLogger", "CometLogger"]
    assert "WandbLogger off: RuntimeError: No API key configured" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="API key"):
        JL.Loggers(tmp_path / "runs" / "jax", enable_tb=False)


@pytest.mark.parametrize("mod", [PL, JL], ids=["port", "jax"])
def test_check_comet_resume(monkeypatch, tmp_path, mod):
    """comet:// brings back the run's opt.yaml and its newest checkpoint;
    ``?name`` picks a named one, which must exist."""
    opt_saved = {"data": "shapes.yaml", "cfg": "yolov5n", "epochs": 7, "resume": "stale"}
    assets = {"a1": yaml.safe_dump(opt_saved).encode(), "m-new": b"CKPT-NEW",
              "m-old": b"CKPT-OLD", "m-best": b"BEST"}

    class _Exp:
        name = "exp9"

        def get_asset_list(self):
            return [{"fileName": "opt.yaml", "assetId": "a1"}]

        def get_model_asset_list(self, model_name):
            assert model_name == "yolov5_tpu"
            return [{"fileName": "last.ckpt", "assetId": "m-old", "step": 3},
                    {"fileName": "last.ckpt", "assetId": "m-new", "step": 9},
                    {"fileName": "best.ckpt", "assetId": "m-best", "step": 5}]

        def get_asset(self, asset_id, return_type="binary", stream=False):
            return assets[asset_id]

    class _API:
        def get(self, path):
            assert path == "ws/proj/exp9"
            return _Exp()

    comet = types.ModuleType("comet_ml")
    comet.API = _API
    monkeypatch.setitem(sys.modules, "comet_ml", comet)
    assert mod.check_comet_resume("runs/train/x", "runs/train") is None
    opt, ckpt = mod.check_comet_resume("comet://ws/proj/exp9", project=str(tmp_path / "runs"))
    assert opt == opt_saved
    assert Path(ckpt).read_bytes() == b"CKPT-NEW" and Path(ckpt).name == "last.ckpt"
    _, ckpt = mod.check_comet_resume("comet://ws/proj/exp9?best.ckpt",
                                     project=str(tmp_path / "runs"))
    assert Path(ckpt).read_bytes() == b"BEST"
    with pytest.raises(FileNotFoundError):
        mod.check_comet_resume("comet://ws/proj/exp9?epoch3.ckpt", project=str(tmp_path))


@pytest.mark.parametrize("mod", [PL, JL], ids=["port", "jax"])
def test_check_wandb_resume(monkeypatch, tmp_path, mod):
    dl = tmp_path / "dl"

    class _Artifact:
        def download(self, root=None):
            dl.mkdir(parents=True, exist_ok=True)
            (dl / "last.ckpt").write_bytes(b"W")
            return str(dl)

    class _Api:
        def artifact(self, path, type=None):
            assert path == "ent/proj/run_r1_model:latest" and type == "model"
            return _Artifact()

    wandb = types.ModuleType("wandb")
    wandb.Api = _Api
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    assert mod.check_wandb_resume("runs/train/x") is None
    p = mod.check_wandb_resume("wandb-artifact://ent/proj/run_r1_model:latest",
                               project=str(tmp_path / "runs"))
    assert Path(p).read_bytes() == b"W"


def test_clearml_dataset_through_check_dataset(monkeypatch, tmp_path):
    """``--data clearml://<id>``: the port's check_dataset resolves it as the
    JAX package's does, and two yamls in the dataset's root are refused."""
    from yolov5_tpu.utils.general import check_dataset as jax_check_dataset
    from yolov5_tpu_torch.utils.general import check_dataset

    root = tmp_path / "ds"
    (root / "images" / "train").mkdir(parents=True)
    (root / "images" / "val").mkdir(parents=True)
    (root / "def.yaml").write_text("train: images/train\nval: images/val\nnc: 2\n"
                                   "names: [a, b]\n")

    class _DS:
        @staticmethod
        def get(dataset_id):
            assert dataset_id == "abc123"
            return _DS()

        def get_local_copy(self):
            return str(root)

    clearml = types.ModuleType("clearml")
    clearml.Dataset = _DS
    monkeypatch.setitem(sys.modules, "clearml", clearml)
    d = check_dataset("clearml://abc123")
    assert d == jax_check_dataset("clearml://abc123")
    assert d["nc"] == 2 and d["names"] == {0: "a", 1: "b"}
    assert d["train"] == str((root / "images" / "train").resolve())
    (root / "other.yaml").write_text("x: 1\n")
    with pytest.raises(ValueError, match="exactly one"):
        check_dataset("clearml://abc123")


def test_train_run_resumes_from_comet(monkeypatch, tmp_path):
    """``train.run(resume="comet://...")``: the run's opt.yaml and last.ckpt
    come back through the Comet SDK and training continues from the next
    epoch with the saved options (the port raised here before the loggers
    were ported). The checkpoint's epoch is in its ``.json`` sidecar, which
    neither package logs to Comet: without it beside the download, the
    resume reads a finished checkpoint and refuses, in the JAX package too
    (ROADMAP.md, section 3)."""
    from tests.torch_port_helpers import write_shapes_dataset
    from yolov5_tpu_torch.train.run import run

    monkeypatch.setenv("YOLOV5_TPU_LOGGERS", "off")
    write_shapes_dataset(tmp_path / "data", [(64, 64)] * 4, ext=".bmp", split="train")
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"train": str(tmp_path / "data" / "images" / "train"),
                                    "nc": 3}))
    kw = dict(data=str(data), cfg="yolov5n", batch_size=2, imgsz=64, workers=1,
              dtype="float32", device="cpu", noval=True, noautoanchor=True, noplots=True,
              device_aug=True, project=str(tmp_path / "runs"))
    _, _, first = run(epochs=1, name="a", **kw)
    saved = yaml.safe_load((first / "opt.yaml").read_text())
    saved.update(epochs=2, name="b")
    assets = {"opt": yaml.safe_dump(saved).encode(), "last": (first / "last.ckpt").read_bytes()}

    class _Exp:
        name = "b"

        def get_asset_list(self):
            return [{"fileName": "opt.yaml", "assetId": "opt"}]

        def get_model_asset_list(self, model_name):
            return [{"fileName": "last.ckpt", "assetId": "last", "step": 0}]

        def get_asset(self, asset_id, return_type="binary", stream=False):
            return assets[asset_id]

    comet = types.ModuleType("comet_ml")
    comet.API = lambda: types.SimpleNamespace(get=lambda path: _Exp())
    monkeypatch.setitem(sys.modules, "comet_ml", comet)
    resume = dict(data="", resume="comet://ws/proj/b", project=str(tmp_path / "runs"),
                  device="cpu")
    with pytest.raises(ValueError, match="training is finished"):
        run(**resume)
    shutil.copy(first / "last.ckpt.json", tmp_path / "runs" / "b" / "last.ckpt.json")
    _, _, resumed = run(**resume)
    assert resumed == tmp_path / "runs" / "b"
    rows = (resumed / "results.csv").read_text().splitlines()
    assert len(rows) == 2 and rows[1].startswith("1,")  # the second epoch only
