"""K2: the fused inference stem, SiLU(conv6x6/s2/pad2(x, w) + b).

``stem_conv`` launches the CUDA kernel ``csrc/stem_conv.cu`` on a CUDA tensor
and takes the plain PyTorch version ``stem_conv_plain`` on a CPU tensor; on a
CUDA tensor it launches or raises. The JAX package's counterpart is
``yolov5_tpu/ops/stem_pallas.py`` (``stem_conv`` / ``stem_conv_mxuT``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolov5_tpu_torch import _build

# c2 of the yolov5 n, s, m, l, x stems: the widths the kernel is built for
STEM_WIDTHS = (16, 32, 48, 64, 80)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def stem_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 convolution, bias and SiLU, one rounding at the end."""
    y = F.conv2d(x.float(), w.float(), b.float(), stride=2, padding=2)
    y = y * torch.sigmoid(y)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def pack_stem_weights(w: torch.Tensor):
    """(c2, 3, 6, 6) OIHW stem weights -> the kernel's (9, 16, c2) bf16 layout.

    The 6x6/s2 conv is a 3x3/s1 conv over the 12 stride-phase channels of the
    space-to-depth input: tap dy*3 + dx, channel sy*6 + sx*3 + ci holds
    w[:, ci, 2*dy + sy, 2*dx + sx]; channels 12..15 are zero. Returns
    (w_hi, w_lo) with w_hi = bf16(w) and w_lo = bf16(w - w_hi), or w_lo None
    when w is bf16 already (then w_hi is exact)."""
    c2 = w.shape[0]
    w12 = w.reshape(c2, 3, 3, 2, 3, 2).permute(2, 4, 3, 5, 1, 0).reshape(9, 12, c2)
    if w.dtype == torch.bfloat16:
        w_hi = w.new_zeros((9, 16, c2))
        w_hi[:, :12] = w12
        return w_hi, None
    wf = w.new_zeros((9, 16, c2), dtype=torch.float32)
    wf[:, :12] = w12
    w_hi = wf.to(torch.bfloat16)
    return w_hi, (wf - w_hi.float()).to(torch.bfloat16)


def stem_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, 3, H, W) channels_last, f32 or bf16; w (c2, 3, 6, 6); b (c2,).

    Returns (B, c2, H/2, W/2) channels_last in x's dtype, with the fp32
    accumulator, bias and SiLU rounded once, as the TPU kernel does."""
    if x.device.type == "cpu":
        return stem_conv_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv: no kernel for device {x.device}")
    c2 = w.shape[0]
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"stem_conv: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] != 3 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"stem_conv: x must be (B, 3, H, W) with even H, W; got {tuple(x.shape)}")
    if tuple(w.shape) != (c2, 3, 6, 6) or c2 not in STEM_WIDTHS or tuple(b.shape) != (c2,):
        raise ValueError(f"stem_conv: w must be (c2, 3, 6, 6), b (c2,), c2 in {STEM_WIDTHS}; "
                         f"got {tuple(w.shape)}, {tuple(b.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("stem_conv: x must be channels_last (NHWC storage)")
    if w.device != x.device or b.device != x.device:
        raise ValueError("stem_conv: x, w and b must be on one device")
    B, _, H, W = x.shape
    w_hi, w_lo = pack_stem_weights(w)
    bk = b.float().contiguous()
    y = torch.empty((B, c2, H // 2, W // 2), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.yolo_stem_conv(x.data_ptr(), w_hi.data_ptr(),
                                None if w_lo is None else w_lo.data_ptr(), bk.data_ptr(),
                                y.data_ptr(), B, H, W, c2, _DTYPE_CODES[x.dtype], stream)
    _build.check(rc, "stem_conv")
    stem_conv.launches += 1
    return y


stem_conv.launches = 0
