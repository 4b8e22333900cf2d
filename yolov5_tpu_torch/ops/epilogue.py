"""K3: the epilogue of a BN-folded convolution, act(y + b) (+ residual).

``conv_epilogue`` launches the CUDA kernel ``csrc/conv_epilogue.cu`` on a
CUDA tensor, in place on the convolution's fresh output, and takes the plain
PyTorch version ``conv_epilogue_plain`` on a CPU tensor; on a CUDA tensor it
launches or raises. No TPU kernel has this role: XLA fuses the bias, the
activation and the residual add into the convolution there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolov5_tpu_torch import _build

ACT_CODES = {"identity": 0, "silu": 1}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def conv_epilogue_plain(y: torch.Tensor, b: torch.Tensor, act: str,
                        residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: bias, activation and residual in float32, one rounding
    to y's dtype at the end. Returns a new tensor in y's memory format."""
    v = y.float() + b.float().view(1, -1, 1, 1)
    if act == "silu":
        v = F.silu(v)
    elif act != "identity":
        raise ValueError(f"conv_epilogue: act must be one of {tuple(ACT_CODES)}, got {act!r}")
    if residual is not None:
        v = v + residual.float()
    return v.to(y.dtype)


def conv_epilogue(y: torch.Tensor, b: torch.Tensor, act: str,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """y (B, C, H, W), channels_last or contiguous, float32 or bfloat16, the
    convolution's output without its bias; b (C,) and ``residual`` (y's
    shape and memory format, or None) of y's dtype; ``act`` "silu" or
    "identity". Returns act(y + b) (+ residual), computed in float32 and
    rounded once: y itself, updated in place, on a card.

    On the card this runs once per folded conv, so it checks only device,
    dtype, shape and contiguity, each by the cheapest query."""
    if y.is_cpu:
        return conv_epilogue_plain(y, b, act, residual)
    if not y.is_cuda:
        raise ValueError(f"conv_epilogue: no kernel for device {y.device}")
    act_code = ACT_CODES.get(act)
    dtype_code = _DTYPE_CODES.get(y.dtype)
    if act_code is None or dtype_code is None or b.dtype != y.dtype:
        raise ValueError(f"conv_epilogue: act in {tuple(ACT_CODES)}, y and b float32 or "
                         f"bfloat16 alike; got {act!r}, {y.dtype}, {b.dtype}")
    shape = y.shape
    if len(shape) != 4 or b.ndim != 1 or b.shape[0] != shape[1] or not b.is_contiguous():
        raise ValueError(f"conv_epilogue: y must be (B, C, H, W) and b (C,); got "
                         f"{tuple(shape)}, {tuple(b.shape)}")
    if y.is_contiguous(memory_format=torch.channels_last):
        fmt, inner = torch.channels_last, 1
    elif y.is_contiguous():
        fmt, inner = torch.contiguous_format, shape[2] * shape[3]
    else:
        raise ValueError("conv_epilogue: y must be channels_last or contiguous")
    dev = y.get_device()
    if b.get_device() != dev:
        raise ValueError("conv_epilogue: y and b must be on one device")
    r = None
    if residual is not None:
        if (residual.shape != shape or residual.dtype != y.dtype
                or residual.get_device() != dev
                or not residual.is_contiguous(memory_format=fmt)):
            raise ValueError("conv_epilogue: the residual must have y's shape, dtype, device "
                             "and memory format")
        r = residual.data_ptr()
    rc = _build.load().yolo_conv_epilogue(
        y.data_ptr(), b.data_ptr(), r, y.numel(), shape[1], inner, act_code, dtype_code, dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        _build.check(rc, "conv_epilogue")
    conv_epilogue.launches += 1
    return y


conv_epilogue.launches = 0
