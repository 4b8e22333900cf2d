"""Training augmentation on the device: mosaic, geometry, HSV and flips as
tensor math on the batch, for detection and for segmentation.

The port of the detection half of ``yolov5_tpu/data/device_aug.py``, with
the reference's semantics (utils/augmentations.py, dataloaders.py:798-855):
- HSV jitter bit-exact with cv2's uint8 path: RGB -> HSV in OpenCV's fixed
  point, per-image LUT gains, HSV -> RGB in float32 with a truncating cast;
- ``random_perspective``: the composed C·P·R·S·T matrix, inverse-map
  bilinear sampling with a 114 border, boxes through the four corners and
  the reference's ``box_candidates`` filter;
- flips left-right and up-down;
- the 4-tile mosaic: compose the 2s canvas from the image and three
  partners drawn from the whole device-resident dataset (or from explicit
  4-tile batches, ``mosaic_device``), then warp it to s with the training
  geometry. The canvas is read pixel by pixel (each
  canvas pixel comes from the quadrant tile that covers it, else it is
  114), so it is never written out.
The JAX package also has a separable banded-matmul mosaic (``mosaic_fused``)
that keeps a TPU off gathers; its own tests show it equals compose-then-warp,
which is the form ported here.

The segmentation side (``device_augment_seg``) carries each label's polygon
(V vertices) through the same mosaic and flips, re-derives the boxes from
the warped polygons (the reference's segment2box, clipped to the output as
the JAX package does) and fills the GT masks at the end
(``rasterize_batch_masks``: vertices floored, as the JAX package floors
them; the host loader truncates). Its mosaic takes the separable geometry
only (scale and translate), as the JAX package's does.

The classification side (``classify_device_augment``) is RandomResizedCrop
as an inverse-map bilinear sample of the cached (s, s) image, a horizontal
flip and brightness, contrast and saturation jitter in that fixed order.

Randomness comes from an explicit ``torch.Generator`` on the batch's device
(``aug_generator``: seeded from (seed, step)); the deterministic cores
(``hsv_jitter_lut``, ``affine_from_draws``, ``affine_sample``,
``warp_perspective``, ``mosaic_warp``, ``classify_augment_core``) take the
drawn values as arguments.
Images are (bs, h, w, 3) uint8 RGB, targets (bs, M, 5) [cls, x, y, w, h]
normalized, valid (bs, M) bool.
"""

from __future__ import annotations

import math

import torch

from yolov5_tpu_torch.ops.rasterize import rasterize, rasterize_overlap

FILL = 114.0


def aug_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step's augmentation: seeded from (seed,
    step), on ``device``, so that a resumed run draws what the uninterrupted
    one drew."""
    return torch.Generator(device=device).manual_seed(seed * 2 ** 32 + step)


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


# ---------------------------------------------------------------------------
# color
# ---------------------------------------------------------------------------

def _rne_div(num: int, den: torch.Tensor) -> torch.Tensor:
    """round-half-to-even(num / den) for a positive int and a positive int32
    tensor: OpenCV's cvRound of the exact quotient, as its HSV tables use."""
    q = num // den
    r2 = 2 * (num - q * den)
    return q + ((r2 > den) | ((r2 == den) & (q % 2 == 1))).int()


def rgb_to_hsv_u8(images: torch.Tensor):
    """cv2-exact uint8 RGB -> (H 0..179, S 0..255, V 0..255) int32: OpenCV's
    fixed-point RGB2HSV_b (hsv_shift 12; V == R wins over V == G)."""
    x = images.int()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    sdiv = torch.where(v > 0, _rne_div(255 << 12, v.clamp(min=1)), 0)
    s = (diff * sdiv + (1 << 11)) >> 12
    hdiv = torch.where(diff > 0, _rne_div(180 << 12, 6 * diff.clamp(min=1)), 0)
    h_raw = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = torch.div(h_raw * hdiv + (1 << 11), 1 << 12, rounding_mode="floor")
    h = h + torch.where(h < 0, 180, 0)
    return h, s, v


def hsv_jitter_lut(images: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """cv2-exact HSV jitter with per-image gains r (bs, 3): cv2's uint8 HSV,
    the gains ``(h*r0) % 180``, ``clip(s*r1)``, ``clip(v*r2)`` truncated to
    integers, then OpenCV's float HSV2RGB with a truncating cast (the
    reference's augment_hsv, augmentations.py:69-82)."""
    f32 = torch.float32
    c = lambda v: torch.tensor(v, dtype=f32, device=images.device)
    h8, s8, v8 = rgb_to_hsv_u8(images)
    r = r.to(f32)
    r0, r1, r2 = (r[:, j, None, None] for j in range(3))
    h8 = torch.floor(torch.remainder(h8.to(f32) * r0, 180.0))
    s8 = torch.floor((s8.to(f32) * r1).clamp(0.0, 255.0))
    v8 = torch.floor((v8.to(f32) * r2).clamp(0.0, 255.0))
    h6 = h8 * c(6.0 / 180.0)
    s = s8 * c(1.0 / 255.0)
    v = v8 * c(1.0 / 255.0)
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.int()  # h8 <= 179, so h6 < 6

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    out = torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                       select(p, p, t, v, v, q)], -1)
    return torch.floor(out * c(255.0)).clamp(0, 255).to(torch.uint8)


def augment_hsv(images, gen, hgain=0.015, sgain=0.7, vgain=0.4):
    """Per-image HSV jitter of (bs, h, w, 3) uint8 RGB."""
    bs = images.shape[0]
    r = _uniform(gen, (bs, 3), -1.0, 1.0, images.device)
    r = r * torch.tensor([hgain, sgain, vgain], device=images.device) + 1.0
    return hsv_jitter_lut(images, r)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def draw_affine(gen, bs, degrees, translate, scale, shear, perspective, device):
    """The random draws of one batch's warp, per image: perspective (bs, 2),
    angle in degrees (bs,), scale (bs,), shear in degrees (bs, 2), translation
    fraction (bs, 2)."""
    u = lambda shape, lo, hi: _uniform(gen, shape, lo, hi, device)
    return {"perspective": u((bs, 2), -perspective, perspective),
            "angle": u((bs,), -degrees, degrees),
            "scale": u((bs,), 1 - scale, 1 + scale),
            "shear": u((bs, 2), -shear, shear),
            "translate": u((bs, 2), 0.5 - translate, 0.5 + translate)}


def affine_from_draws(draws, height, width, out_height=None, out_width=None):
    """Per-image 3x3 matrices M = T·S·R·P·C and their scales (the JAX
    package's ``_affine_matrices``, data/augment.py random_perspective).
    Centering uses the input size, translation the output size: with a
    smaller output this is the reference's mosaic border crop."""
    out_height = height if out_height is None else out_height
    out_width = width if out_width is None else out_width
    s = draws["scale"]
    bs, dev = s.shape[0], s.device
    eye = lambda: torch.eye(3, device=dev).repeat(bs, 1, 1)
    C = eye()
    C[:, 0, 2], C[:, 1, 2] = -width / 2, -height / 2
    P = eye()
    P[:, 2, 0], P[:, 2, 1] = draws["perspective"][:, 0], draws["perspective"][:, 1]
    a = draws["angle"] * math.pi / 180.0
    cos, sin = torch.cos(a) * s, torch.sin(a) * s
    R = eye()
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = cos, sin, -sin, cos
    S = eye()
    sh = draws["shear"] * math.pi / 180.0
    S[:, 0, 1], S[:, 1, 0] = torch.tan(sh[:, 0]), torch.tan(sh[:, 1])
    T = eye()
    t = draws["translate"]
    T[:, 0, 2], T[:, 1, 2] = t[:, 0] * out_width, t[:, 1] * out_height
    return T @ S @ R @ P @ C, s


def _bilinear(read, M_inv, out_h, out_w, fill=FILL):
    """Inverse-map bilinear sampling: out[b, y, x] = src_b(M_inv[b] @ (x, y, 1)).
    ``read(yi, xi)`` (bs, P) int64 source pixel indices -> ((bs, P, C) float
    values, (bs, P) bool inside); a tap that is not inside reads ``fill``."""
    dev = M_inv.device
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones_like(xs).reshape(-1)])
    src = torch.einsum("bij,jp->bip", M_inv.float(), grid)  # (bs, 3, P)
    w = src[:, 2].clamp(min=1e-8)
    sx, sy = src[:, 0] / w, src[:, 1] / w
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        v, inside = read(yi, xi)
        return torch.where(inside[..., None], v, fill)

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1 - fx) + tap(y0i + 1, x0i + 1) * fx
    out = top * (1 - fy) + bot * fy
    return out.reshape(M_inv.shape[0], out_h, out_w, -1)


def affine_sample(images, M_inv, out_h, out_w, fill=FILL):
    """Inverse-map bilinear sampling of (bs, h, w, c) float images with
    per-image M_inv (bs, 3, 3); out-of-bounds taps read ``fill``."""
    bs, h, w, _ = images.shape
    b = torch.arange(bs, device=images.device)[:, None]

    def read(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return images[b, yi.clamp(0, h - 1), xi.clamp(0, w - 1)].float(), inside

    return _bilinear(read, M_inv, out_h, out_w, fill)


def _to_u8(x):
    return (x + 0.5).clamp(0, 255).to(torch.uint8)


def _box_candidates(nx1, ny1, nx2, ny2, pre_w, pre_h):
    """The reference's box_candidates: > 2 px, area ratio > 0.1, aspect < 100."""
    nw, nh = nx2 - nx1, ny2 - ny1
    ar = torch.maximum(nw / (nh + 1e-16), nh / (nw + 1e-16))
    return (nw > 2) & (nh > 2) & (nw * nh / (pre_w * pre_h + 1e-16) > 0.1) & (ar < 100)


def _warp_boxes(x1, y1, x2, y2, M, s, ow, oh):
    """Pixel boxes (bs, N) through M by their four corners, clipped to the
    output -> (xyxy list, keep (bs, N))."""
    cx = torch.stack([x1, x2, x1, x2], -1)  # (bs, N, 4) corners
    cy = torch.stack([y1, y2, y2, y1], -1)
    m = lambda i, j: M[:, i, j, None, None]
    w = (m(2, 0) * cx + m(2, 1) * cy + m(2, 2)).clamp(min=1e-8)
    wx = (m(0, 0) * cx + m(0, 1) * cy + m(0, 2)) / w
    wy = (m(1, 0) * cx + m(1, 1) * cy + m(1, 2)) / w
    nx1, nx2 = wx.amin(-1).clamp(0, ow), wx.amax(-1).clamp(0, ow)
    ny1, ny2 = wy.amin(-1).clamp(0, oh), wy.amax(-1).clamp(0, oh)
    keep = _box_candidates(nx1, ny1, nx2, ny2, (x2 - x1) * s[:, None], (y2 - y1) * s[:, None])
    return (nx1, ny1, nx2, ny2), keep


def _normalized(cls, xyxy, ow, oh):
    nx1, ny1, nx2, ny2 = xyxy
    return torch.stack([cls, (nx1 + nx2) / 2 / ow, (ny1 + ny2) / 2 / oh,
                        (nx2 - nx1) / ow, (ny2 - ny1) / oh], -1)


def warp_perspective(images, targets, valid, M, s, out_hw=None):
    """The deterministic core of ``random_perspective``: warp uint8 images by
    M (bs, 3, 3) with scales s (bs,), boxes by their corners, and mask the
    boxes ``box_candidates`` rejects."""
    bs, h, w, _ = images.shape
    oh, ow = out_hw if out_hw is not None else (h, w)
    out = _to_u8(affine_sample(images, torch.linalg.inv(M), oh, ow))
    px, py = targets[..., 1] * w, targets[..., 2] * h
    pw, ph = targets[..., 3] * w, targets[..., 4] * h
    xyxy, keep = _warp_boxes(px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2, M, s, ow, oh)
    return out, _normalized(targets[..., 0], xyxy, ow, oh), valid & keep


def random_perspective(images, targets, valid, gen, degrees=0.0, translate=0.1, scale=0.5,
                       shear=0.0, perspective=0.0, out_hw=None):
    """Batched random warp (reference random_perspective)."""
    bs, h, w, _ = images.shape
    oh, ow = out_hw if out_hw is not None else (h, w)
    draws = draw_affine(gen, bs, degrees, translate, scale, shear, perspective, images.device)
    M, s = affine_from_draws(draws, h, w, oh, ow)
    return warp_perspective(images, targets, valid, M, s, (oh, ow))


def random_flip_lr(images, targets, gen, p=0.5):
    """Left-right flip with probability p per image."""
    do = torch.rand(images.shape[0], generator=gen, device=images.device) < p
    images = torch.where(do[:, None, None, None], images.flip(2), images)
    x = torch.where(do[:, None], 1.0 - targets[..., 1], targets[..., 1])
    return images, torch.cat([targets[..., :1], x[..., None], targets[..., 2:]], -1)


def random_flip_ud(images, targets, gen, p=0.0):
    """Up-down flip with probability p per image."""
    do = torch.rand(images.shape[0], generator=gen, device=images.device) < p
    images = torch.where(do[:, None, None, None], images.flip(1), images)
    y = torch.where(do[:, None], 1.0 - targets[..., 2], targets[..., 2])
    return images, torch.cat([targets[..., :2], y[..., None], targets[..., 3:]], -1)


# ---------------------------------------------------------------------------
# mosaic
# ---------------------------------------------------------------------------

def _tile_origins(k, xc, yc, h, w):
    """Content corner of quadrant k's tile (reference x1a/y1a math): the
    top-left tile has its bottom-right corner at (xc, yc), and so on."""
    return (xc - w if k in (0, 2) else xc), (yc - h if k in (0, 1) else yc)


def mosaic_warp(pool, targets4, valid4, idx, hw4, xc, yc, M, scale, out_size=None):
    """The deterministic mosaic core: the 2s canvas of tiles pool[idx[:, k]]
    (content hw4[:, k] in the top-left of each s x s buffer, bottom-right
    corner of the top-left tile at (xc, yc), integer px), warped to s x s
    by M (bs, 3, 3), then labels: tile -> canvas px, clipped to the canvas,
    through M, clipped to the output, filtered by ``box_candidates``.
    ``out_size``: the image comes out at out_size x out_size instead (the
    per-batch multi-scale resize folded into the warp, the JAX package's
    ``mosaic_fused(out_size=...)``); labels are normalized, so they are
    computed at s, ``box_candidates`` included.

    pool (N, s, s, 3) uint8; hw4 (bs, 4, 2) float content sizes (0 for a
    tile left out); targets4 (bs, 4, M, 5), valid4 (bs, 4, M). Returns
    (images (bs, out, out, 3) uint8, targets (bs, 4M, 5), valid (bs, 4M))."""
    bs, s = idx.shape[0], pool.shape[1]
    out_s = int(out_size) if out_size else s
    xc, yc = xc.long(), yc.long()
    hw4i = hw4.long()

    def read(yi, xi):
        # which quadrant's tile covers canvas pixel (yi, xi), and where in it
        right, below = (xi >= xc[:, None]), (yi >= yc[:, None])
        k = below.long() * 2 + right.long()
        th = hw4i[:, :, 0].gather(1, k)
        tw = hw4i[:, :, 1].gather(1, k)
        ly = yi - torch.where(below, yc[:, None], yc[:, None] - th)
        lx = xi - torch.where(right, xc[:, None], xc[:, None] - tw)
        inside = ((lx >= 0) & (lx < tw) & (ly >= 0) & (ly < th)
                  & (xi >= 0) & (xi < 2 * s) & (yi >= 0) & (yi < 2 * s))
        tile = idx.gather(1, k)
        return pool[tile, ly.clamp(0, s - 1), lx.clamp(0, s - 1)].float(), inside

    q = torch.diag(torch.tensor([out_s / s, out_s / s, 1.0], device=M.device))
    out = _to_u8(_bilinear(read, torch.linalg.inv(q @ M), out_s, out_s))

    labels, valids = [], []
    xcf, ycf = xc.float()[:, None], yc.float()[:, None]
    for k in range(4):
        h_k, w_k = hw4[:, k, 0][:, None], hw4[:, k, 1][:, None]
        ox, oy = _tile_origins(k, xcf, ycf, h_k, w_k)
        tk = targets4[:, k]
        x_c, y_c = tk[..., 1] * w_k + ox, tk[..., 2] * h_k + oy
        bw, bh = tk[..., 3] * w_k, tk[..., 4] * h_k
        # canvas clip (the reference clips mosaic labels to [0, 2s] before the warp)
        x1, x2 = (x_c - bw / 2).clamp(0, 2 * s), (x_c + bw / 2).clamp(0, 2 * s)
        y1, y2 = (y_c - bh / 2).clamp(0, 2 * s), (y_c + bh / 2).clamp(0, 2 * s)
        xyxy, keep = _warp_boxes(x1, y1, x2, y2, M, scale, s, s)
        labels.append(_normalized(tk[..., 0], xyxy, s, s))
        valids.append(valid4[:, k] & keep)
    return out, torch.cat(labels, 1), torch.cat(valids, 1)


def _apply_mosaic_prob(do, hw4, valid4, xc, yc, s):
    """Images that draw no mosaic (do False) keep only their own tile,
    centered on the canvas, so that the same warp becomes the reference's
    letterbox + random_perspective branch."""
    first = torch.tensor([True, False, False, False], device=hw4.device)
    keep = do[:, None] | first[None, :]
    hw4 = hw4 * keep[..., None]
    valid4 = valid4 & keep[..., None]
    xc = torch.where(do, xc, torch.floor(s + hw4[:, 0, 1] / 2))
    yc = torch.where(do, yc, torch.floor(s + hw4[:, 0, 0] / 2))
    return hw4, valid4, xc, yc


def _mosaic_draws(hw, targets, valid, gen, hyp, s, pool, self_idx):
    """The draws of one batch's mosaic, in the order ``mosaic_in_batch``
    takes them: the three partners of each image (from ``pool`` when given,
    else from the batch), the centre, whether the image is a mosaic, and the
    warp. Returns (idx (bs, 4), hw4, targets4, valid4, xc, yc, draws, M,
    scale)."""
    bs, dev = hw.shape[0], hw.device
    if pool is not None:
        n = pool["images"].shape[0]
        idx = torch.cat([self_idx.long()[:, None],
                         torch.randint(0, n, (bs, 3), generator=gen, device=dev)], 1)
        hw, targets, valid = pool["hw"], pool["targets"], pool["valid"]
    else:
        idx = torch.cat([torch.arange(bs, device=dev)[:, None],
                         torch.randint(0, bs, (bs, 3), generator=gen, device=dev)], 1)
    hw4 = hw[idx].float()  # (bs, 4, 2)
    targets4, valid4 = targets[idx], valid[idx]
    # mosaic center on the 2s canvas, uniform over [s/2, 3s/2), in whole px
    c = torch.floor(_uniform(gen, (bs, 2), 0.5 * s, 1.5 * s, dev))
    xc, yc = c[:, 0], c[:, 1]
    do = torch.rand(bs, generator=gen, device=dev) < hyp.get("mosaic", 1.0)
    hw4, valid4, xc, yc = _apply_mosaic_prob(do, hw4, valid4, xc, yc, s)
    draws = draw_affine(gen, bs, hyp.get("degrees", 0.0), hyp.get("translate", 0.1),
                        hyp.get("scale", 0.5), hyp.get("shear", 0.0),
                        hyp.get("perspective", 0.0), dev)
    M, scale = affine_from_draws(draws, 2 * s, 2 * s, s, s)
    return idx, hw4, targets4, valid4, xc, yc, draws, M, scale


def mosaic_in_batch(images, hw, targets, valid, gen, hyp, pool=None, self_idx=None,
                    out_size=None):
    """On-device 4-tile mosaic of raw batches (the JAX package's
    ``mosaic_in_batch``; reference dataloaders.py:798-855).

    images (bs, s, s, 3) uint8, each image resized long side = s into the
    top-left of its buffer; hw (bs, 2) content sizes; targets normalized to
    the content. With ``pool`` (the device cache: images, hw, targets,
    valid) and ``self_idx`` (this batch's indices into it), the three
    partners are drawn from the whole dataset; without, from the batch.
    Each image is a mosaic with probability hyp['mosaic']. The geometry
    (degrees, translate, scale, shear, perspective) warps the 2s canvas to s,
    or to ``out_size`` (``mosaic_warp``)."""
    s = images.shape[1]
    idx, hw4, targets4, valid4, xc, yc, _, M, scale = _mosaic_draws(
        hw, targets, valid, gen, hyp, s, pool, self_idx)
    pool_images = images if pool is None else pool["images"]
    return mosaic_warp(pool_images, targets4, valid4, idx, hw4, xc, yc, M, scale, out_size)


def mosaic_device(tiles, tile_hw, targets4, valid4, gen, hyp, out_size=None):
    """The mosaic of explicit 4-tile batches (the JAX package's
    ``mosaic_device``): tiles (bs, 4, s, s, 3) uint8, each content in the
    top-left of its buffer; tile_hw (bs, 4, 2); targets4 (bs, 4, M, 5),
    valid4 (bs, 4, M). Every image is a mosaic; the geometry warps the 2s
    canvas to s as in ``mosaic_in_batch``."""
    bs, _, s = tiles.shape[:3]
    dev = tiles.device
    idx = torch.arange(bs * 4, device=dev).reshape(bs, 4)
    c = torch.floor(_uniform(gen, (bs, 2), 0.5 * s, 1.5 * s, dev))
    draws = draw_affine(gen, bs, hyp.get("degrees", 0.0), hyp.get("translate", 0.1),
                        hyp.get("scale", 0.5), hyp.get("shear", 0.0),
                        hyp.get("perspective", 0.0), dev)
    M, scale = affine_from_draws(draws, 2 * s, 2 * s, s, s)
    return mosaic_warp(tiles.reshape(bs * 4, s, s, 3), targets4, valid4, idx,
                       tile_hw.float(), c[:, 0], c[:, 1], M, scale, out_size)


def device_augment(batch, gen, hyp):
    """Perspective -> HSV -> flips on a batch dict of uint8 images, targets
    and valid; returns the same structure."""
    images, targets, valid = batch["images"], batch["targets"], batch["valid"]
    if any(hyp.get(k, 0) for k in ("degrees", "translate", "scale", "shear", "perspective")):
        images, targets, valid = random_perspective(
            images, targets, valid, gen, degrees=hyp.get("degrees", 0.0),
            translate=hyp.get("translate", 0.1), scale=hyp.get("scale", 0.5),
            shear=hyp.get("shear", 0.0), perspective=hyp.get("perspective", 0.0))
    if any(hyp.get(k, 0) for k in ("hsv_h", "hsv_s", "hsv_v")):
        images = augment_hsv(images, gen, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7),
                             hyp.get("hsv_v", 0.4))
    if hyp.get("fliplr", 0):
        images, targets = random_flip_lr(images, targets, gen, hyp["fliplr"])
    if hyp.get("flipud", 0):
        images, targets = random_flip_ud(images, targets, gen, hyp["flipud"])
    return dict(batch, images=images, targets=targets, valid=valid)


# ---------------------------------------------------------------------------
# segmentation: polygons ride the mosaic and the flips, masks filled last
# ---------------------------------------------------------------------------

def _segment_boxes(seg_px, ow, oh):
    """Boxes of warped polygons (..., V, 2) in output pixels: the extent of
    the vertices clipped to the output, which is the reference's segment2box
    over its 1000 resampled points in the dense limit. Returns (xyxy (...,
    4), any vertex inside (...)); a polygon with none inside gets a zero
    box."""
    x, y = seg_px[..., 0], seg_px[..., 1]
    inside = (x >= 0) & (x <= ow) & (y >= 0) & (y <= oh)
    xc, yc = x.clamp(0, ow), y.clamp(0, oh)
    boxes = torch.stack([xc.amin(-1), yc.amin(-1), xc.amax(-1), yc.amax(-1)], -1)
    any_in = inside.any(-1)
    return torch.where(any_in[..., None], boxes, 0.0), any_in


def _seg_mosaic_labels(seg4, hw4, targets4, valid4, xc, yc, r, t, s):
    """The deterministic core of the segmentation mosaic's labels: each
    tile's polygons (bs, 4, M, V, 2), normalised to their content, to canvas
    pixels, through the separable warp X = r·x + (t - r·s) (t in pixels) to
    the output, then boxes from the polygons, kept by the reference's
    box_candidates for segments (> 2 px, area ratio against the pre-warp
    box at the drawn scale > 0.01, aspect < 100) and by any vertex inside.
    Returns (targets (bs, 4M, 5), segments (bs, 4M, V, 2) normalised to the
    output, valid (bs, 4M))."""
    A = r[:, None, None]
    Bx = (t[:, 0] - r * s)[:, None, None]
    By = (t[:, 1] - r * s)[:, None, None]
    segs_out, labels, valids = [], [], []
    for k in range(4):
        h_k = hw4[:, k, 0][:, None, None]
        w_k = hw4[:, k, 1][:, None, None]
        ox, oy = _tile_origins(k, xc[:, None, None], yc[:, None, None], h_k, w_k)
        sk = seg4[:, k]
        X = A * (sk[..., 0] * w_k + ox) + Bx
        Y = A * (sk[..., 1] * h_k + oy) + By
        seg_px = torch.stack([X, Y], -1)
        boxes, any_in = _segment_boxes(seg_px, s, s)
        nw = boxes[..., 2] - boxes[..., 0]
        nh = boxes[..., 3] - boxes[..., 1]
        tk = targets4[:, k]
        pre_w = tk[..., 3] * w_k[..., 0] * r[:, None]
        pre_h = tk[..., 4] * h_k[..., 0] * r[:, None]
        ar = torch.maximum(nw / (nh + 1e-16), nh / (nw + 1e-16))
        keep = (nw > 2) & (nh > 2) & (nw * nh / (pre_w * pre_h + 1e-16) > 0.01) & (ar < 100)
        labels.append(torch.stack([tk[..., 0], (boxes[..., 0] + boxes[..., 2]) / 2 / s,
                                   (boxes[..., 1] + boxes[..., 3]) / 2 / s, nw / s, nh / s], -1))
        segs_out.append(seg_px / s)
        valids.append(valid4[:, k] & keep & any_in)
    return torch.cat(labels, 1), torch.cat(segs_out, 1), torch.cat(valids, 1)


def mosaic_in_batch_seg(images, hw, targets, segments, valid, gen, hyp, pool=None,
                        self_idx=None, out_size=None):
    """The segmentation mosaic of raw batches: the detection mosaic's draws
    and image (``mosaic_in_batch``), and the labels re-derived from the
    polygons (``_seg_mosaic_labels``). segments (bs, M, V, 2) are normalised
    to each image's content (with ``pool``, the cache's ``segments``).
    Only the separable geometry: degrees, shear or perspective raise.
    Returns (images, targets (bs, 4M, 5), segments (bs, 4M, V, 2) normalised
    to the output, valid (bs, 4M))."""
    if any(hyp.get(k, 0) for k in ("degrees", "shear", "perspective")):
        raise ValueError("the device segmentation mosaic takes the separable scale + "
                         "translate geometry; rotation, shear and perspective need the "
                         "host pipeline (drop --device-aug)")
    s = images.shape[1]
    idx, hw4, targets4, valid4, xc, yc, draws, M, scale = _mosaic_draws(
        hw, targets, valid, gen, hyp, s, pool, self_idx)
    pool_images = images if pool is None else pool["images"]
    seg4 = (segments if pool is None else pool["segments"])[idx].float()
    out, _, _ = mosaic_warp(pool_images, targets4, valid4, idx, hw4, xc, yc, M, scale,
                            out_size)
    labels, segs, valids = _seg_mosaic_labels(seg4, hw4, targets4, valid4, xc, yc,
                                              draws["scale"], draws["translate"] * s, s)
    return out, labels, segs, valids


def random_flip_lr_seg(images, targets, segments, gen, p=0.5):
    """Left-right flip with probability p per image, polygons too."""
    do = torch.rand(images.shape[0], generator=gen, device=images.device) < p
    images = torch.where(do[:, None, None, None], images.flip(2), images)
    x = torch.where(do[:, None], 1.0 - targets[..., 1], targets[..., 1])
    sx = torch.where(do[:, None, None], 1.0 - segments[..., 0], segments[..., 0])
    return (images, torch.cat([targets[..., :1], x[..., None], targets[..., 2:]], -1),
            torch.stack([sx, segments[..., 1]], -1))


def random_flip_ud_seg(images, targets, segments, gen, p=0.0):
    """Up-down flip with probability p per image, polygons too."""
    do = torch.rand(images.shape[0], generator=gen, device=images.device) < p
    images = torch.where(do[:, None, None, None], images.flip(1), images)
    y = torch.where(do[:, None], 1.0 - targets[..., 2], targets[..., 2])
    sy = torch.where(do[:, None, None], 1.0 - segments[..., 1], segments[..., 1])
    return (images, torch.cat([targets[..., :2], y[..., None], targets[..., 3:]], -1),
            torch.stack([segments[..., 0], sy], -1))


def rasterize_batch_masks(segments, valid, hm, wm, overlap=True):
    """(bs, M, V, 2) output-normalised polygons -> GT masks at (hm, wm):
    (bs, hm, wm) int32 index maps with ``overlap`` (label row i as i + 1),
    else (bs, M, hm, wm) bool. Vertices are floored in mask pixels, as the
    JAX package floors them (device_aug.py:783): the host loader's int32
    cast, which truncates, differs only for negative coordinates."""
    v = segments.shape[2]
    nv = torch.where(valid, v, 0)
    poly = torch.floor(segments * torch.tensor([wm, hm], dtype=segments.dtype,
                                               device=segments.device))
    if overlap:
        return rasterize_overlap(poly, nv, hm, wm)
    return rasterize(poly, nv, hm, wm)


def device_augment_seg(batch, gen, hyp, mask_shape, overlap=True, pool=None, self_idx=None,
                       out_size=None):
    """Segmentation's device augmentation: the mosaic (raw batches, when
    hyp['mosaic'] > 0) -> HSV -> flips -> GT masks at ``mask_shape``.
    batch: images, targets, segments, valid (+ hw for raw batches).
    Returns {images, targets, valid, masks, segments}."""
    images, targets = batch["images"], batch["targets"]
    segments, valid = batch["segments"], batch["valid"]
    if "hw" in batch and hyp.get("mosaic", 0) > 0:
        images, targets, segments, valid = mosaic_in_batch_seg(
            images, batch["hw"], targets, segments, valid, gen, hyp, pool=pool,
            self_idx=self_idx, out_size=out_size)
    if any(hyp.get(k, 0) for k in ("hsv_h", "hsv_s", "hsv_v")):
        images = augment_hsv(images, gen, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7),
                             hyp.get("hsv_v", 0.4))
    if hyp.get("fliplr", 0):
        images, targets, segments = random_flip_lr_seg(images, targets, segments, gen,
                                                       hyp["fliplr"])
    if hyp.get("flipud", 0):
        images, targets, segments = random_flip_ud_seg(images, targets, segments, gen,
                                                       hyp["flipud"])
    masks = rasterize_batch_masks(segments, valid, *mask_shape, overlap=overlap)
    return {"images": images, "targets": targets, "valid": valid, "masks": masks,
            "segments": segments}


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def classify_aug_draws(gen, bs, device, scale=(0.08, 1.0), ratio=(0.75, 4.0 / 3.0), hflip=0.5,
                       jitter=0.4):
    """The random values of one classification batch, in the JAX package's
    order: the crop's area fraction and log aspect ratio, its (x, y) offset
    in [0, 1), the flip, and (with ``jitter``) the brightness, contrast and
    saturation factors (3, bs) in 1 ± jitter."""
    area = _uniform(gen, (bs,), scale[0], scale[1], device)
    logr = _uniform(gen, (bs,), math.log(ratio[0]), math.log(ratio[1]), device)
    off = torch.rand((bs, 2), generator=gen, device=device)
    flip = torch.rand((bs,), generator=gen, device=device) < hflip
    factors = _uniform(gen, (3, bs), 1.0 - jitter, 1.0 + jitter, device) if jitter else None
    return {"area": area, "logr": logr, "off": off, "flip": flip, "jitter": factors}


def classify_augment_core(images, area, logr, off, flip, jitter=None):
    """The deterministic classification transform of (bs, s, s, 3) uint8 RGB
    images on given draws (``classify_aug_draws``): RandomResizedCrop as the
    inverse map in = off + out · scale with per-axis side scales
    min(sqrt(area · r), 1) and min(sqrt(area / r), 1), sampled bilinearly
    (``affine_sample``, fill 114); the flip of the width axis where ``flip``;
    then out·b, (out - mean)·c + mean over each image, (out - gray)·t + gray
    with gray = 0.299 R + 0.587 G + 0.114 B; clip(out + 0.5) to uint8."""
    bs, s = images.shape[0], images.shape[1]
    rho = torch.exp(logr)
    sw = torch.sqrt(area * rho).clamp(max=1.0)
    sh = torch.sqrt(area / rho).clamp(max=1.0)
    zeros, ones = torch.zeros_like(sw), torch.ones_like(sw)
    M = torch.stack([torch.stack([sw, zeros, off[:, 0] * (1 - sw) * s], -1),
                     torch.stack([zeros, sh, off[:, 1] * (1 - sh) * s], -1),
                     torch.stack([zeros, zeros, ones], -1)], 1)
    out = affine_sample(images, M, s, s)
    out = torch.where(flip[:, None, None, None], out.flip(2), out)
    if jitter is not None:
        jb, jc, js = (f[:, None, None, None] for f in jitter)
        out = out * jb  # brightness
        mean = out.mean((1, 2, 3), keepdim=True)
        out = (out - mean) * jc + mean  # contrast
        gray = (out * out.new_tensor([0.299, 0.587, 0.114])).sum(-1, keepdim=True)
        out = (out - gray) * js + gray  # saturation
    return _to_u8(out)


def classify_device_augment(images, gen, scale=(0.08, 1.0), ratio=(0.75, 4.0 / 3.0), hflip=0.5,
                            jitter=0.4):
    """The classify train transform of the reference's recipe
    (classify_albumentations: RandomResizedCrop, HorizontalFlip, ColorJitter
    without hue) on a device-resident (bs, s, s, 3) uint8 batch, drawn from
    ``gen``. Like the JAX package's, it crops the cached s x s image rather
    than the file, and its jitters run in a fixed order."""
    draws = classify_aug_draws(gen, images.shape[0], images.device, scale, ratio, hflip, jitter)
    return classify_augment_core(images, **draws)
