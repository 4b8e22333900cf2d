"""Data-parallel training of the port (``yolov5_tpu_torch.parallel``) on the
CPU: two gloo ranks, spawned as processes on a free port with a timeout of
their own, against one process at the global batch, and against the JAX
package's step on a 2-device CPU mesh.

The cases are in tests/torch_parallel_cases.py (yolov5n, yolov5n-seg and the
yolov5n classifier at width 0.125, 64 px, a global batch of 4, float32).
Tolerances:
- ranks against each other: parameters, BN statistics and EMA bit for bit
  (every rank applies the same summed gradients);
- ranks against one process: every step's loss within 1e-5 relative,
  and after 4 steps the parameters, BN statistics and EMA within 5e-5 of
  each tensor's largest entry. The two runs differ only in the order of
  their float32 sums: the global batch's statistics, normalisers and
  gradients are sums over two halves, and batch norm takes its statistics
  from sums about the running mean (``_batch_norm_global``, with autograd's
  backward) where one process takes ``var_mean`` and ``F.batch_norm``'s
  fused backward. That reordering alone, in one process on the same
  batches (the detection case run through both batch-norm forms), moves the
  first layers' BN biases by 1.85e-5 of their largest entry after 4 steps:
  the warmup steps biases at lr 0.1 by gradients summed over every pixel.
  The ranks land 0.9e-5 .. 2.5e-5 from one process;
- ``batch_norm_train`` alone: outputs, gradients and running statistics
  within 1e-5 relative (float32 sums over 100-element halves);
- against the JAX mesh: the first step's global loss within 1e-5 relative,
  the next nine within 1e-4, as the one-process parity test
  (tests/test_torch_train_step.py) holds the port to one JAX device.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_cases as C
from yolov5_tpu.data.dataset import Loader as JaxLoader
from yolov5_tpu.data.dataset import YOLODataset as JaxDataset
from yolov5_tpu.models import DetectionModel as JaxModel
from yolov5_tpu.models.weights import import_torch_weights
from yolov5_tpu.parallel.distributed import init_distributed as jax_init_distributed
from yolov5_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from yolov5_tpu.train import loss as jax_loss
from yolov5_tpu.train import optim as jax_optim
from yolov5_tpu.train import trainer as jax_trainer
from tests.torch_port_helpers import write_shapes_dataset
from yolov5_tpu_torch.data.dataset import Loader, YOLODataset, create_loader
from yolov5_tpu_torch.parallel import distributed

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
RANK_TIMEOUT = 240


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank, world, port, **extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1", **extra)
    return env


def spawn_ranks(argv, cwd, world=WORLD, timeout=RANK_TIMEOUT, **extra):
    """Run ``python argv`` as ``world`` ranks of one gloo group; returns
    their CompletedProcess-like (returncode, output) pairs, raising with the
    logs' tails when a rank fails or outlives ``timeout``."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, *argv], cwd=cwd, env=rank_env(r, world, port,
                                                                                **extra),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of torch_parallel_cases, run once by two gloo ranks."""
    out = tmp_path_factory.mktemp("ranks")
    names = ",".join(C.CASES)
    spawn_ranks(["-c", "import sys; from tests.torch_parallel_cases import main; "
                       f"main({names!r}, sys.argv[1] + '/' + str(__import__('os')"
                       ".environ['RANK']) + '.npz')", str(out)], cwd=REPO)
    res = []
    for r in range(WORLD):
        with np.load(out / f"{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    return res


def case(res, name):
    return {k.split(":", 1)[1]: v for k, v in res.items() if k.startswith(name + ":")}


def assert_rel(got, ref, rel, what):
    for k, r in ref.items():
        scale = max(np.abs(r).max(), 1e-30)
        err = np.abs(got[k] - r).max() / scale
        assert err <= rel, f"{what} {k}: {err:.3g} > {rel}"


# ---------------------------------------------------------------------------
# the env contract and the shard
# ---------------------------------------------------------------------------

def test_init_distributed_is_a_no_op_at_world_one(monkeypatch):
    """As the JAX package's: WORLD_SIZE unset or 1 -> False, no group."""
    for v in (None, "1"):
        if v is None:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("WORLD_SIZE", v)
        assert distributed.init_distributed("cpu") is False
        assert jax_init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert (distributed.world(), distributed.rank(), distributed.is_main()) == (1, 0, True)
    assert distributed.rank_device("cuda:1") == torch.device("cuda:1")
    distributed.barrier()
    assert distributed.broadcast_object({"a": 1}) == {"a": 1}


def test_env_contract_and_rank_device(tmp_path):
    """Two ranks from RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT /
    LOCAL_RANK: gloo on the CPU, ``cuda`` means cuda:LOCAL_RANK, an explicit
    cuda:N raises, and rank 0's object reaches every rank."""
    code = (
        "import os, torch\n"
        "from yolov5_tpu_torch.parallel import distributed as d\n"
        "assert d.init_distributed('cpu') is True and d.init_distributed('cpu') is True\n"
        "assert torch.distributed.get_backend() == 'gloo'\n"
        "assert (d.world(), d.rank()) == (2, int(os.environ['RANK']))\n"
        "assert d.rank_device('cuda') == torch.device('cuda', 0)\n"
        "assert d.rank_device('cpu') == torch.device('cpu')\n"
        "try:\n"
        "    d.rank_device('cuda:1')\n"
        "    raise SystemExit('no raise')\n"
        "except ValueError:\n"
        "    pass\n"
        "assert d.broadcast_object(d.rank() * 10 + 7) == 7\n"
        "x = torch.tensor([float(d.rank() + 1)], requires_grad=True)\n"
        "y = d.all_reduce_sum_grad(x * 2)\n"
        "g, = torch.autograd.grad(y.sum() * (d.rank() + 1), x)\n"
        "assert y.item() == 6.0 and g.item() == 6.0, (y, g)\n"
        "d.barrier()\n")
    spawn_ranks(["-c", code], cwd=REPO, timeout=120)


def test_loader_shard_matches_jax_and_covers_the_epoch(tmp_path):
    """The port's shard = the JAX Loader's for the same seed and epoch;
    the ranks' shares are disjoint and cover the epoch's order, and every
    rank takes the one-process run's number of global batches."""
    write_shapes_dataset(tmp_path, [(64, 64)] * 11, ext=".bmp", split="train")
    src = str(tmp_path / "images" / "train")
    ds, jds = YOLODataset(src, img_size=64, augment=True), JaxDataset(src, img_size=64,
                                                                      augment=True)
    whole = Loader(ds, batch_size=4, workers=1, seed=3)
    for world in (2, 3):
        loaders = [Loader(ds, batch_size=4 // world or 1, workers=1, seed=3,
                          shard=(r, world)) for r in range(world)]
        for epoch in (0, 1):
            shares = []
            for r, ld in enumerate(loaders):
                jl = JaxLoader(jds, batch_size=ld.bs, shuffle=True, workers=1, seed=3,
                               shard=(r, world))
                np.testing.assert_array_equal(ld._indices(epoch), jl._indices(epoch))
                shares.append(ld._indices(epoch))
            got = np.concatenate(shares)
            assert len(set(got.tolist())) == len(got) == len(ds)
            np.testing.assert_array_equal(np.sort(got), np.arange(len(ds)))
            order = whole._order(epoch)
            for r in range(world):
                np.testing.assert_array_equal(shares[r], order[r::world])
    # 11 images at a global batch of 4: 2 batches on each rank, as one process
    two = [Loader(ds, batch_size=2, workers=1, seed=3, shard=(r, 2)) for r in range(2)]
    assert [len(ld) for ld in two] == [len(whole)] * 2 == [2, 2]
    with pytest.raises(ValueError, match="training loader"):
        Loader(YOLODataset(src, img_size=64), batch_size=2, shard=(0, 2))


@pytest.mark.parametrize("mode", ["rect", "quad"])
def test_rect_and_quad_ranks_take_the_one_process_rows(tmp_path, mode):
    """``--rect`` training (train.run: a host loader without shuffle or
    mosaic) and ``--quad`` at two ranks: rank r's batches are rows r, r + 2,
    ... of the one-process batches at the global batch, pixels and labels.
    A quad rank takes whole groups of 4 and their layout draws."""
    write_shapes_dataset(tmp_path, [(64, 48), (48, 64), (64, 64)] * 6, ext=".bmp",
                         split="train")
    src = str(tmp_path / "images" / "train")
    opts = dict(img_size=64, augment=True, workers=1, seed=5, quad=mode == "quad",
                rect=mode == "rect", shuffle=mode != "rect",
                hyp={"mosaic": 0.0} if mode == "rect" else None)
    whole = list(create_loader(src, batch_size=8, **opts)[1])
    for r in range(2):
        share = list(create_loader(src, batch_size=4, shard=(r, 2), **opts)[1])
        assert len(share) == len(whole) == 2
        for w, b in zip(whole, share):
            for k in ("images", "targets", "valid", "indices"):
                want = w[k][r::2] if k != "indices" or mode == "rect" else \
                    w[k].reshape(-1, 4)[r::2].ravel()
                np.testing.assert_array_equal(b[k], want, err_msg=f"rank {r} {k}")


def test_rank_batch_counts_agree_where_jax_ranks_disagree(tmp_path):
    """A gap of the JAX Loader (ROADMAP.md section 3): each rank counts its
    own shard's batches, so 11 images at 3 a rank give rank 0 two batches
    and rank 1 one (its collectives would then wait forever); the port's
    ranks all take the one-process run's count at the global batch."""
    write_shapes_dataset(tmp_path, [(64, 64)] * 11, ext=".bmp", split="train")
    src = str(tmp_path / "images" / "train")
    jds = JaxDataset(src, img_size=64, augment=True)
    jax_lens = [len(JaxLoader(jds, batch_size=4, shuffle=True, workers=1, shard=(r, 2)))
                for r in range(2)]
    assert jax_lens == [1, 1]
    jax_lens = [len(JaxLoader(jds, batch_size=3, shuffle=True, workers=1, shard=(r, 2)))
                for r in range(2)]
    assert jax_lens == [2, 1]
    ds = YOLODataset(src, img_size=64, augment=True)
    assert [len(Loader(ds, batch_size=3, workers=1, shard=(r, 2))) for r in range(2)] == [1, 1]


def test_index_batches_whole_interleaves_the_ranks(tmp_path):
    """The device cache's global index batch holds rank r's batch at rows
    r, r + world, ..."""
    from yolov5_tpu_torch.data.device_cache import index_batches

    write_shapes_dataset(tmp_path, [(64, 64)] * 9, ext=".bmp", split="train")
    ds = YOLODataset(str(tmp_path / "images" / "train"), img_size=64, augment=True)
    lds = [Loader(ds, batch_size=2, workers=1, seed=1, shard=(r, 2)) for r in range(2)]
    whole = [b["idx"] for b in index_batches(lds[0], whole=True)]
    for r, ld in enumerate(lds):
        local = [b["idx"] for b in index_batches(ld)]
        assert len(local) == len(whole) == 2
        for w, loc in zip(whole, local):
            np.testing.assert_array_equal(w[r::2], loc)


# ---------------------------------------------------------------------------
# two gloo ranks against one process at the global batch
# ---------------------------------------------------------------------------

def test_batch_norm_train_over_the_global_batch(ranks):
    ref = C.case_bn()
    got = [case(r, "bn") for r in ranks]
    y = np.stack([g["y"] for g in got], 1).reshape(ref["y"].shape)
    gx = np.stack([g["gx"] for g in got], 1).reshape(ref["gx"].shape)
    np.testing.assert_allclose(y, ref["y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx, ref["gx"], rtol=1e-5, atol=1e-5)
    # weight and bias: each rank's gradient is its share; the step sums them
    for k in ("gw", "gb"):
        np.testing.assert_allclose(got[0][k] + got[1][k], ref[k], rtol=1e-5, atol=1e-5)
    for g in got:
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(g[k], ref[k], rtol=1e-5, atol=1e-6)
            assert not np.allclose(g[k], [0.0, 0.0, 0.0, 0.0] if k == "running_mean" else 1.0)


@pytest.mark.parametrize("name", ["detect_host", "detect_cache", "detect_raw", "segment_host",
                                  "segment_cache", "classify_host", "classify_cache"])
def test_ranks_equal_one_process_at_the_global_batch(ranks, name):
    """4 steps (host batches, the device cache with device augmentation, or
    raw batches gathered for the device mosaic): parameters, BN statistics
    and EMA bit-identical across the ranks and within 5e-5 of one process;
    the ranks' loss shares sum to the one-process loss."""
    got = [case(r, name) for r in ranks]
    ref = C.CASES[name]()
    snap = [k for k in ref if k.startswith(f"step{C.STEPS}/")]
    assert len(snap) > 50
    for k in snap:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    assert_rel(got[0], {k: ref[k] for k in snap}, 5e-5, name)
    # the losses: each rank's metrics are its shares of the global batch's
    total = got[0]["losses"] + got[1]["losses"]
    np.testing.assert_allclose(total[:C.STEPS], ref["losses"][:C.STEPS], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# against the JAX package's step on a 2-device mesh
# ---------------------------------------------------------------------------

def test_detection_ranks_match_the_jax_mesh(ranks):
    """The JAX step on make_mesh(2) (batch sharded, BN and loss over the
    global batch) on the same weights and global batches: the ranks' summed
    loss within 1e-5 at the first step and 1e-4 over ten."""
    sd = C.detector_weights()
    jm = JaxModel(C.det_cfg(), packed_stem=False)
    jm.variables, missed = import_torch_weights(jm, sd)
    assert not missed
    hyp = C.hyp()
    tx = jax_optim.build_optimizer(jm.params, hyp, epochs=3, steps_per_epoch=5,
                                   batch_size=C.BATCH, nbs=C.BATCH)
    mesh = make_mesh(2)
    step = jax_trainer.make_train_step(jm, jax_loss.ComputeLoss(jm.anchors_per_stride, 3, hyp),
                                       tx, mesh=mesh)
    losses = []
    with mesh:
        state = replicate(jax_trainer.init_train_state(jm, tx), mesh)
        for i in range(C.JAX_STEPS):
            b = {k: v for k, v in C.global_batch(i).items() if k != "hw"}
            state, m = step(state, shard_batch({k: jnp.asarray(v) for k, v in b.items()}, mesh))
            losses.append([float(m[k]) for k in ("total", "box", "obj", "cls")])
    ref = np.array(losses)
    got = case(ranks[0], "detect_host")["losses"] + case(ranks[1], "detect_host")["losses"]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
