"""Several processes, one per GPU: ``torch.distributed`` from torchrun's
environment.

The port of ``yolov5_tpu/parallel/distributed.py``, with the same env
contract (torchrun's names):

  RANK          this process's index (0..WORLD_SIZE-1)
  WORLD_SIZE    number of processes
  MASTER_ADDR   the rendezvous host (default 127.0.0.1)
  MASTER_PORT   the rendezvous port (default 29500)
  LOCAL_RANK    this process's card on its host (``cuda:LOCAL_RANK``)

``init_distributed`` is a no-op that returns False when WORLD_SIZE is unset
or 1, so a one-card run (and ``torchrun --nproc_per_node 1``) keeps the
one-process path, which runs no collective. The backend is NCCL for a run
on the card and gloo on the CPU; ``YOLOV5_TPU_DIST_BACKEND`` overrides it
(gloo lets two ranks share one card, which NCCL refuses).

The other helpers read the initialised process group, so they also serve a
group that a caller set up itself; without one the world is 1 and each of
them does nothing.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_distributed(device="cuda") -> bool:
    """Join the process group that torchrun's environment describes. Returns
    True when several processes train, False for a one-process run. Safe to
    call more than once."""
    n = int(os.environ.get("WORLD_SIZE", 1))
    if n <= 1:
        return False
    if dist.is_initialized():
        return True
    backend = os.environ.get("YOLOV5_TPU_DIST_BACKEND") or (
        "nccl" if torch.device(device).type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    addr = (f"tcp://{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
            f"{os.environ.get('MASTER_PORT', '29500')}")
    dist.init_process_group(backend, init_method=addr, world_size=n,
                            rank=int(os.environ["RANK"]))
    return True


def world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if world() > 1 else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def is_main() -> bool:
    return rank() == 0


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda`` means ``cuda:LOCAL_RANK`` when
    several processes train; an explicit ``cuda:N`` then raises, since every
    rank would take the same card."""
    device = torch.device(device)
    if world() > 1 and device.type == "cuda":
        if device.index is not None:
            raise ValueError(f"--device {device} with WORLD_SIZE {world()}: each rank takes "
                             "cuda:LOCAL_RANK; pass --device cuda")
        return torch.device("cuda", local_rank())
    return device


def rank_batch(batch_size: int) -> int:
    """This rank's share of the global ``batch_size``, which must divide
    evenly over the ranks."""
    if batch_size % world():
        raise ValueError(f"--batch-size {batch_size} (the global batch) does not divide "
                         f"over {world()} ranks")
    return batch_size // world()


def barrier():
    if world() > 1:
        dist.barrier()


def broadcast_object(obj, src=0):
    """``obj`` of rank ``src`` on every rank (pickled)."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``t``, in place and outside autograd."""
    if world() > 1:
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the gradient of x is the sum over ranks of
    the gradients of y (every rank's loss depends on every rank's x)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``x``, through which gradients flow."""
    return _AllReduceSum.apply(x) if world() > 1 else x
