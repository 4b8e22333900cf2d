"""Replication, the gradient sum and the rank's rows of a global batch.

The counterpart of ``yolov5_tpu/parallel/mesh.py`` in torch terms. The JAX
package shards a batch over a device mesh and lets XLA insert the
collectives; here each rank is a process that holds the whole model and
``1/world`` of each global batch, and the collectives are explicit:

- ``replicate``: rank 0's parameters, buffers and EMA on every rank, at the
  start of a run and after a resume;
- ``all_reduce_grads``: each rank's gradients summed in one flat float32
  bucket, one collective a step. Each rank's loss is its share of the
  global batch's loss (``train.loss`` takes its normalisers over the global
  batch), so the sum is the gradient of the global loss;
- ``rank_rows`` and ``gather_rows``: the global batch of a step is the
  ranks' local batches interleaved (row j of the global batch is row
  ``j // world`` of rank ``j % world``), as ``data.dataset.Loader`` shards
  the epoch's order; these take a rank's rows out of a global batch and
  put the global batch together from the local ones.

``train/prefetch.py`` stands for ``prefetch_to_mesh``. The model is not
wrapped in ``DistributedDataParallel``: the step takes its gradients with
``torch.autograd.grad``, which DDP's hooks do not see.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from yolov5_tpu_torch.parallel.distributed import rank, world


def _broadcast_flat(tensors):
    """Rank 0's values of ``tensors`` on every rank: one broadcast per
    (dtype, device)."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=0)
        offset = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def replicate(state):
    """Rank 0's model (parameters and buffers) and EMA on every rank, in
    place; returns ``state``."""
    if world() == 1:
        return state
    tensors = list(state.model.state_dict().values())
    tensors += list(state.ema.params.values()) + list(state.ema.batch_stats.values())
    _broadcast_flat(tensors)
    return state


def all_reduce_grads(grads):
    """The sum over ranks of each gradient: one all-reduce of one float32
    bucket. Returns new tensors in the gradients' dtypes."""
    if world() == 1:
        return grads
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].view_as(g).to(g.dtype))
        offset += g.numel()
    return out


def rank_rows(x):
    """This rank's rows of a global batch (rows r, r + world, ...)."""
    return x[rank()::world()] if world() > 1 else x


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch from each rank's local batch ``x`` (equal shapes on
    every rank), interleaved as ``rank_rows`` reads it back."""
    if world() == 1:
        return x
    y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()  # gloo has no bool
    parts = [torch.empty_like(y) for _ in range(world())]
    dist.all_gather(parts, y)
    return torch.stack(parts, 1).reshape(-1, *x.shape[1:]).to(x.dtype)
