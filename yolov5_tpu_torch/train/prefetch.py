"""Host batches to the device ahead of the train step.

The port of ``yolov5_tpu.parallel.mesh.prefetch_to_mesh`` for one device: a
background thread pulls host batches, runs ``transform`` on them (host
prep), and copies their numpy arrays to the device ``depth`` batches ahead
of the step, so that augmentation and the host-to-device copy overlap the
step instead of following it (the reference gets this from its DataLoader
workers and pinned-memory copies, utils/dataloaders.py:106-164). On CUDA
the arrays are pinned and copied with ``non_blocking`` on a side stream;
the consumer's stream waits for that copy and records its use of the
tensors. An exception in the producer is raised on the consumer's side.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

_DONE = object()


def prefetch(iterator, device, depth=2, transform=None):
    """Yield the batches (dicts) of ``iterator``, ``transform``ed, with every
    numpy array a tensor on ``device``."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err = []

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def upload(batch):
        if not cuda:
            return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                    for k, v in batch.items()}, None
        out = {}
        with torch.cuda.device(device), torch.cuda.stream(copy_stream):
            for k, v in batch.items():
                if isinstance(v, np.ndarray):
                    v = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    v = v.to(device, non_blocking=True)
                out[k] = v
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def produce():
        try:
            for b in iterator:
                if stop.is_set():
                    return
                if transform is not None:
                    b = transform(b)
                if not put(upload(b)):
                    return
        except BaseException as e:  # raised on the consumer's side
            err.append(e)
        finally:
            put(_DONE)

    thread = threading.Thread(target=produce, daemon=True, name="prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                break
            batch, done = item
            if done is not None:
                step_stream = torch.cuda.current_stream(device)
                step_stream.wait_event(done)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(step_stream)
            yield batch
        thread.join()
        if err:
            raise err[0]
    finally:
        stop.set()
