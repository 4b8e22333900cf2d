"""Phase 23 of chip_smoke.py (the native JPEG decoder and the TF exports)
rehearsed on the CPU at a small size: 128 px, batch 4, 8 val and train
BMPs, 16 JPEGs, a 1-epoch f32 yolov5s ``train.run`` for the checkpoint.
CUDA events become a host timer, ``resolve_device`` gives the CPU, and K1
and K2 are routed to counting plain versions, so the phase's launch checks
read something. ``NATIVE_MAP_TOL`` is 1.0: weights trained for one epoch
score about 0. Exits non-zero where a check of the phase fails.

    JAX_PLATFORMS=cpu python -m tests.torch_chip_rehearsal
    JAX_PLATFORMS=cpu python -m tests.torch_chip_rehearsal --plant shift    # must fail
    JAX_PLATFORMS=cpu python -m tests.torch_chip_rehearsal --plant nobuild  # must fail

``--plant shift`` adds 8 levels to the decoder's pixels; ``--plant
nobuild`` reports the decoder unavailable where g++ finds ``jpeglib.h``.
"""

import argparse
import contextlib
import io
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
import yolov5_tpu_torch.infer as infer  # noqa: E402
import yolov5_tpu_torch.models.layers as layers_mod  # noqa: E402
import yolov5_tpu_torch.native as native_mod  # noqa: E402
import yolov5_tpu_torch.ops.nms as nms_mod  # noqa: E402
import yolov5_tpu_torch.ops.nms_kernel as nms_kernel  # noqa: E402
import yolov5_tpu_torch.ops.stem as stem_mod  # noqa: E402


def host_ms(fn, iters, warmup=2):
    """cs.cuda_ms on the host clock."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def counting(plain):
    def fn(*a, **k):
        fn.launches += 1
        return plain(*a, **k)

    fn.launches = 0
    return fn


def plant(fault):
    if fault == "shift":
        decode = native_mod.decode_letterbox_batch

        def shifted(*a, **k):
            images, *rest = decode(*a, **k)
            return (np.minimum(images.astype(np.int16) + 8, 255).astype(np.uint8), *rest)

        native_mod.decode_letterbox_batch = shifted
    elif fault == "nobuild":
        native_mod.available = lambda: False
        native_mod.unavailable_reason = lambda: "planted: the build failed"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plant", choices=("shift", "nobuild"))
    opt = parser.parse_args(argv)
    cs.IMGSZ, cs.BATCH, cs.VAL_IMAGES, cs.TRAIN_IMAGES = 128, 4, 8, 8
    cs.NATIVE_IMAGES, cs.SMOKE_SOURCES, cs.NATIVE_MAP_TOL = 16, 4, 1.0
    cs.VAL_SHAPES = ((96, 128), (128, 96), (128, 128), (72, 128))
    cs.cuda_ms = host_ms
    infer.resolve_device = lambda device, who: torch.device("cpu")
    nms_kernel.greedy_nms = nms_mod.greedy_nms = counting(nms_kernel.greedy_nms_plain)
    stem_mod.stem_conv = layers_mod.stem_conv = counting(stem_mod.stem_conv_plain)
    plant(opt.plant)

    from yolov5_tpu_torch.train.run import run

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_rehearsal_") as root:
        data = cs.phase_val_data(root)
        train_data = cs.phase_train_data(root)

        def trained():
            with contextlib.redirect_stdout(io.StringIO()):
                _, _, save_dir = run(data=str(train_data), cfg="yolov5s", hyp="scratch-low",
                                     epochs=1, batch_size=cs.BATCH, imgsz=cs.IMGSZ,
                                     dtype="float32", device=cpu, workers=0,
                                     project=str(Path(root) / "runs"), name="r", noplots=True)
            return save_dir / "best.ckpt"

        launches, _ = cs.phase_native_tf(cpu, root, data, trained, "CPU rehearsal, no card")
    print(f"rehearsal: phase 23 passed in {time.perf_counter() - t0:.1f} s; K1/K2 launches "
          f"{launches}")


if __name__ == "__main__":
    main()
