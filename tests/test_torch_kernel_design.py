"""The designs of the CUDA kernels K1 (greedy NMS) and K2 (fused stem),
emulated in torch on the CPU against their plain versions.

K2 runs the 6x6/s2 stem as a 3x3/s1 convolution over the 12 stride-phase
channels of a space-to-depth input (padded to 16), with the weights packed
by ``ops.stem.pack_stem_weights`` into bf16 high and low parts. K1 walks the
candidates in chunks: dead bits against the kept list, an upper-triangle
suppression bitmask per chunk, and a word-wise resolve. The emulations here
follow the kernels' index arithmetic, so a wrong channel order, tap order or
bit order fails on the CPU; tests/test_torch_cuda.py holds the kernels
themselves against the plain versions on a card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolov5_tpu_torch.ops.nms_kernel import _iou, greedy_nms_plain
from yolov5_tpu_torch.ops.stem import STEM_WIDTHS, pack_stem_weights, stem_conv_plain

# --- K2 -------------------------------------------------------------------


def _space_to_depth(x):
    """(B, 3, H, W) -> (B, 16, H/2 + 2, W/2 + 2): the conv's 2-pixel padding,
    then channel sy*6 + sx*3 + ci = padded pixel (2Y + sy, 2X + sx), channel
    ci, as the kernel's copy lays one raw pixel pair of one row (6 values) at
    channels sy*6 .. sy*6 + 5; channels 12..15 are zero."""
    B, _, H, W = x.shape
    xp = F.pad(x, (2, 2, 2, 2))
    x12 = xp.reshape(B, 3, H // 2 + 2, 2, W // 2 + 2, 2).permute(0, 3, 5, 1, 2, 4)
    return F.pad(x12.reshape(B, 12, H // 2 + 2, W // 2 + 2), (0, 0, 0, 0, 0, 4))


def _packed_conv(x16, wp, b):
    """The kernel's 3x3/s1 product with packed (9, 16, c2) weights, tap dy*3 + dx."""
    c2 = wp.shape[-1]
    return F.conv2d(x16, wp.reshape(3, 3, 16, c2).permute(3, 2, 0, 1), b)


def _stem_inputs(rng, B, H, W, c2):
    x = torch.from_numpy(rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.2, 0.2, (c2, 3, 6, 6)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.5, 0.5, (c2,)).astype(np.float32))
    return x.contiguous(memory_format=torch.channels_last), w, b


def _packed_slots(w):
    """The packed layout written out slot by slot, as the kernel reads it:
    tap dy*3 + dx, channel sy*6 + sx*3 + ci holds w[:, ci, 2*dy + sy, 2*dx + sx]."""
    out = torch.zeros((9, 16, w.shape[0]))
    for dy in range(3):
        for dx in range(3):
            for sy in range(2):
                for sx in range(2):
                    for ci in range(3):
                        out[dy * 3 + dx, sy * 6 + sx * 3 + ci] = w[:, ci, 2 * dy + sy, 2 * dx + sx]
    return out


def test_pack_stem_weights_splits_f32_exactly(rng):
    """w_hi + w_lo gives back the f32 weights slot for slot within 2^-16
    relative (channels 12..15 zero); bf16 weights need no low part."""
    w = torch.from_numpy(rng.normal(0, 0.3, (32, 3, 6, 6)).astype(np.float32))
    w_hi, w_lo = pack_stem_weights(w)
    assert w_hi.shape == (9, 16, 32) and w_hi.dtype == w_lo.dtype == torch.bfloat16
    want = _packed_slots(w)
    assert ((w_hi.float() + w_lo.float() - want).abs() <= 2.0 ** -16 * want.abs()).all()
    hi_b, lo_b = pack_stem_weights(w.to(torch.bfloat16))
    assert lo_b is None and hi_b.dtype == torch.bfloat16
    assert torch.equal(hi_b.float(), _packed_slots(w.to(torch.bfloat16).float()))


@pytest.mark.parametrize("c2", STEM_WIDTHS)
@pytest.mark.parametrize("hw", [(6, 10), (14, 2), (18, 34)])
def test_space_to_depth_conv_equals_plain(rng, c2, hw):
    """The 3x3 space-to-depth conv with the packed weights (w_hi + w_lo) is
    the stem: within atol 1e-5 of stem_conv_plain, odd output widths (5, 1,
    17) included."""
    x, w, b = _stem_inputs(rng, 2, *hw, c2)
    w_hi, w_lo = pack_stem_weights(w)
    z = _packed_conv(_space_to_depth(x), w_hi.float() + w_lo.float(), b)
    got = z * torch.sigmoid(z)
    ref = stem_conv_plain(x, w, b)
    assert got.shape == ref.shape == (2, c2, hw[0] // 2, hw[1] // 2)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def test_f32_input_split_keeps_the_f32_tolerance(rng):
    """f32 x on the kernel is x_hi + x_lo in bf16 with three products
    (x_hi*w_hi + x_lo*w_hi + x_hi*w_lo): every product is exact in f32, and
    the sum stays within the f32 tolerance (atol 1e-5, rtol 1e-4)."""
    x, w, b = _stem_inputs(rng, 2, 40, 64, 32)
    w_hi, w_lo = (t.float() for t in pack_stem_weights(w))
    x16 = _space_to_depth(x)
    x_hi = x16.to(torch.bfloat16).float()
    x_lo = (x16 - x_hi).to(torch.bfloat16).float()
    z = (_packed_conv(x_hi, w_hi, b) + _packed_conv(x_lo, w_hi, None)
         + _packed_conv(x_hi, w_lo, None))
    torch.testing.assert_close(z * torch.sigmoid(z), stem_conv_plain(x, w, b), atol=1e-5,
                               rtol=1e-4)


# --- K1 -------------------------------------------------------------------


def _early_reject(thres):
    """The kernel rejects pairs whose ranges do not overlap (IoU exactly 0)
    before the division only when that cannot change `IoU > thres`."""
    return thres >= 0


def _suppress(a, b, thres, reject):
    """(n, m) bool: IoU(a_i, b_j) > thres in f32, with the kernel's early
    reject applied where `reject`."""
    sup = _iou(a, b) > thres
    if reject:
        apart = ((torch.minimum(a[:, None, 2], b[None, :, 2])
                  - torch.maximum(a[:, None, 0], b[None, :, 0]) <= 0)
                 | (torch.minimum(a[:, None, 3], b[None, :, 3])
                    - torch.maximum(a[:, None, 1], b[None, :, 1]) <= 0))
        sup &= ~apart
    return sup.numpy()


def chunked_walk(boxes, scores, iou_thres, max_det, chunk=512, reject=None):
    """K1's walk for one image: (K, 4) f32 boxes, (K,) scores -> (K,) keep."""
    k = len(boxes)
    thres = float(np.float32(iou_thres))
    reject = _early_reject(thres) if reject is None else reject
    n_words = chunk // 32
    keep = np.zeros(k, bool)
    kept = boxes[:0]
    n_kept = 0
    for start in range(0, k, chunk):
        n = min(chunk, k - start)
        cb, cs = boxes[start:start + n], scores[start:start + n].numpy()
        bad = np.flatnonzero(~(cs > 0))
        lim = int(bad[0]) if len(bad) else n
        # 1a. dead bits against the kept list
        dead = np.zeros(chunk, bool)
        if n_kept and lim:
            dead[:lim] = _suppress(kept, cb[:lim], thres, reject).any(0)
        removed = [int(sum(1 << b for b in range(32) if dead[32 * w + b])) for w in range(n_words)]
        # 1b. the upper-triangle bitmask: bit j % 32 of word j // 32 of row i
        sup = np.triu(_suppress(cb[:lim], cb[:lim], thres, reject), 1)
        tri = np.zeros((chunk, n_words), np.int64)
        for i, j in zip(*np.nonzero(sup)):
            tri[i, j // 32] |= 1 << (j % 32)
        # 2. the resolving warp: lane l holds removed word l
        keep_words = [0] * n_words
        full = False
        for w in range(n_words):
            if 32 * w >= lim:
                break
            valid = (1 << min(32, lim - 32 * w)) - 1
            cand = ~removed[w] & valid
            while cand:
                bit = (cand & -cand).bit_length() - 1
                i = 32 * w + bit
                keep_words[w] |= 1 << bit
                removed = [r | int(t) for r, t in zip(removed, tri[i])]
                cand &= ~int(tri[i, w]) & ~((2 << bit) - 1)
                n_kept += 1
                if n_kept == max_det:
                    full = True
                    break
            if full:
                break
        # 3. append the keeps in order
        alive = np.array([(keep_words[t // 32] >> (t % 32)) & 1 for t in range(n)], bool)
        keep[start:start + n] = alive
        kept = torch.cat([kept, cb[torch.from_numpy(alive)]])
        if full or lim < n:
            break
    return keep


def _walk(boxes, scores, thres, max_det, **kw):
    return np.stack([chunked_walk(b, s, thres, max_det, **kw) for b, s in zip(boxes, scores)])


def _candidates(rng, k, span=200.0, pad_from=None):
    xy = rng.uniform(0, span, (k, 2))
    wh = rng.uniform(5, 60, (k, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = np.sort(rng.uniform(0.01, 1.0, k).astype(np.float32))[::-1].copy()
    if pad_from is not None:
        scores[pad_from:] = 0.0
    return torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None]


@pytest.mark.parametrize("chunk", [64, 512])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 255, 256, 257, 1023, 1025, 2049])
def test_chunked_walk_equals_plain(rng, k, chunk):
    """Chunk edges on both sides of each K; max_det far away, so the walk
    crosses every chunk boundary."""
    boxes, scores = _candidates(rng, k, span=30.0 * np.sqrt(k) + 60, pad_from=int(0.95 * k))
    want = greedy_nms_plain(boxes, scores, 0.45, max_det=4096).numpy()
    np.testing.assert_array_equal(_walk(boxes, scores, 0.45, 4096, chunk=chunk), want)


@pytest.mark.parametrize("max_det", [1, 37, 64, 100, 129])
def test_chunked_walk_max_det_mid_chunk(rng, max_det):
    """The max_det-th keep falls inside a chunk: everything after it False."""
    boxes, scores = _candidates(rng, 400, span=600.0)
    want = greedy_nms_plain(boxes, scores, 0.5, max_det).numpy()
    got = _walk(boxes, scores, 0.5, max_det, chunk=64)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == max_det


@pytest.mark.parametrize("pad_from", [0, 1, 40, 64, 100])
def test_chunked_walk_stops_at_the_first_padding_score(rng, pad_from):
    """A score <= 0 inside a chunk ends the walk there, even where later
    scores are positive again."""
    boxes, scores = _candidates(rng, 200, span=600.0, pad_from=pad_from)
    scores[0, pad_from + 5:] = 0.5  # positive again after the padding
    want = greedy_nms_plain(boxes, scores, 0.45, 300).numpy()
    got = _walk(boxes, scores, 0.45, 300, chunk=64)
    np.testing.assert_array_equal(got, want)
    assert not got[0, pad_from:].any()


def test_chunked_walk_identical_boxes():
    """All boxes identical: only the first is kept, in every chunk."""
    boxes = torch.tensor([[10.0, 20.0, 50.0, 80.0]]).repeat(300, 1)[None]
    scores = torch.linspace(1.0, 0.1, 300)[None]
    want = greedy_nms_plain(boxes, scores, 0.45, 300).numpy()
    got = _walk(boxes, scores, 0.45, 300, chunk=64)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 1


def test_chunked_walk_iou_exactly_at_the_threshold():
    """IoU exactly at the threshold keeps both (strict >), one ulp below
    suppresses; the pairs straddle a chunk boundary."""
    pair = torch.tensor([[200.0, 0.0, 210.0, 10.0], [205.0, 0.0, 215.0, 10.0]])
    far = torch.tensor([[1000.0 * i, 5000.0, 1000.0 * i + 3, 5003.0] for i in range(63)])
    boxes = torch.cat([far, pair])[None]  # the pair is candidates 63 and 64
    scores = torch.linspace(1.0, 0.5, 65)[None]
    f = np.float32
    tie = f(50) / (f(f(100) + f(100)) - f(50) + f(1e-7))
    for thres, kept in ((float(tie), True), (float(np.nextafter(tie, f(0))), False)):
        want = greedy_nms_plain(boxes, scores, thres, 100).numpy()
        got = _walk(boxes, scores, thres, 100, chunk=64)
        np.testing.assert_array_equal(got, want)
        assert got[0, 64] == kept


@pytest.mark.parametrize("thres", [-0.5, -1e-6, 0.0, 0.3])
def test_early_reject_only_for_nonnegative_thresholds(rng, thres):
    """Non-overlapping pairs have IoU 0: for thres < 0 that suppresses, so the
    reject must stay off; for thres >= 0 it cannot change the result. A walk
    that rejected regardless would differ at thres < 0."""
    assert _early_reject(thres) == (thres >= 0)
    boxes, scores = _candidates(rng, 150, span=800.0)
    want = greedy_nms_plain(boxes, scores, thres, 300).numpy()
    np.testing.assert_array_equal(_walk(boxes, scores, thres, 300, chunk=64), want)
    forced = _walk(boxes, scores, thres, 300, chunk=64, reject=True)
    assert np.array_equal(forced, want) == (thres >= 0)
