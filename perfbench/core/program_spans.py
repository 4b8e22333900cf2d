"""The spans the program recorded while the profiler ran, which in a cell is
its traced stretch: ``yolov5_tpu_torch.utils.profile.store``. A program
without that store has recorded none, and the readers then return None.

Each span has ``name``, ``parent`` (the enclosing span's name),
``host_ms`` and ``device_ms`` (its events on the card).
"""

from __future__ import annotations


def recorded() -> list:
    """The stored spans, or [] where the program keeps none."""
    from yolov5_tpu_torch.utils import profile

    store = getattr(profile, "store", None)
    return store.spans() if store is not None else []


def mean_ms(name: str, clock: str, parent: str | None = None):
    """The mean ``clock`` ("host_ms" or "device_ms") of the spans ``name``
    (inside a span ``parent`` where given), or None where there are none."""
    got = [getattr(s, clock) for s in recorded()
           if s.name == name and (parent is None or s.parent == parent)]
    return sum(got) / len(got) if got else None


def per_batch_ms(names, batch: str, clock: str):
    """The summed ``clock`` of the spans in ``names`` over the count of the
    spans ``batch``, or None where there is no such batch."""
    spans = recorded()
    batches = sum(s.name == batch for s in spans)
    if not batches:
        return None
    return sum(getattr(s, clock) for s in spans if s.name in names) / batches
