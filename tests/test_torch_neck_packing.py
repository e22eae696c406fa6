"""The neck level-0 kernel's weight packing (``adascale_torch/kernels/fpn_neck.py``
``pack_neck``) and its arithmetic, on the CPU: the packed TF32 hi + lo parts
unpack to W1 (as C0 x Cm) and to the 3x3's nine taps (tap 3 ky + kx as
Cm x Co), with hi exact TF32 and zero past the real widths; a numpy
emulation of the kernel's 3xTF32 products, read from the packed operands in
the kernel's order with its split of A (the dropped lo.lo product, each
32-deep chunk summed in a fresh tile), matches ``fused_neck_l0_plain``
within 1e-5 relative (the kernel's bar on the card), at the micro widths on
a ragged 13x19 map and at the flagship's (K = 96 and 9 x 384). The wide
necks (the base and large widths): the routes ``plan`` gives, each slice
of the packs index by index, and an emulation of the cluster kernels' walk
(each slice's LayerNorm statistics combined in rank order) against the
plain twin in f32, TF32 and bf16. The pack cache is tested with the heads'
(``test_torch_heads_packing.py``)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adascale_torch.kernels import fpn_neck as K
from adascale_torch.kernels.packing import KC, KSLOT, tf32_round

REL_TOL = 1e-5
# (H, W, C0, Cm, Co): the micro widths on a ragged map; the flagship's.
SHAPES = [(13, 19, 8, 32, 8), (5, 7, 96, 384, 96)]


def _params(c0, cm, co, seed=0):
    """Level-0 parameters from numpy, at the scales of a trained neck."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32))

    return {
        "step1_0.conv.weight": r(cm, c0, scale=c0 ** -0.5),
        "step1_0.conv.bias": r(cm, scale=0.1),
        "step1_0.ln.weight": r(cm, scale=0.1, shift=1.0),
        "step1_0.ln.bias": r(cm, scale=0.1),
        "step2_0.conv.weight": r(co, cm, 3, 3, scale=(9 * cm) ** -0.5),
        "step2_0.conv.bias": r(co, scale=0.1),
        "step2_0.ln.weight": r(co, scale=0.1, shift=1.0),
        "step2_0.ln.bias": r(co, scale=0.1),
    }


def _unpack(w):
    """(taps, chunks, 2, n/8, 8, 8, 4) -> hi, lo each (taps, chunks * 32, n),
    undoing the K slot order."""
    taps, chunks, _, nb = w.shape[:4]
    t = w.permute(2, 0, 1, 4, 6, 3, 5)  # (2, taps, chunk, kb, e, nb, r)
    t = t.reshape(2, taps, chunks, 4, 8, nb * 8)  # (.., k8 step, slot, n)
    slots = torch.empty_like(t)
    slots[..., list(KSLOT), :] = t
    return slots.reshape(2, taps, chunks * KC, nb * 8).unbind(0)


@pytest.mark.parametrize("shape", SHAPES, ids=["micro", "flagship"])
def test_packed_weights_unpack_to_w1_and_taps_and_hi_is_tf32(shape):
    _, _, c0, cm, co = shape
    p = _params(c0, cm, co)
    packed = K.pack_neck(p)
    taps2 = p["step2_0.conv.weight"].permute(2, 3, 1, 0).reshape(9, cm, co)
    for key, want, width in (
        ("w1", p["step1_0.conv.weight"].t()[None], cm),
        ("w2", taps2, co),
    ):
        hi, lo = _unpack(packed[key])
        k = want.shape[1]
        got = hi[:, :k, :width].double() + lo[:, :k, :width].double()
        # hi + lo keeps 22 of the 24 mantissa bits: 2^-21 relative at most.
        torch.testing.assert_close(got, want.double(), rtol=2.0 ** -21, atol=0)
        assert torch.equal(hi[:, :k, :width], tf32_round(want))
        for part in (hi, lo):
            assert not part[:, k:].any() and not part[:, :, width:].any()
            assert not (part.contiguous().view(torch.int32) & 0x1FFF).any()
    for key, step, width in (("vec1", "step1_0", cm), ("vec2", "step2_0", co)):
        want = torch.stack([p[f"{step}.conv.bias"], p[f"{step}.ln.weight"], p[f"{step}.ln.bias"]])
        assert torch.equal(packed[key][:, :width], want)
        assert not packed[key][:, width:].any()


def test_pack_refuses_widths_above_the_layout():
    """Past one tile the layout takes slices (the base and large widths), up
    to MAX_MID and MAX_OUT features; wider raises, in every kind."""
    for dtype, tf32 in ((torch.float32, False), (torch.float32, True), (torch.bfloat16, False)):
        with pytest.raises(ValueError, match="widths"):
            K.pack_neck(_params(8, K.MAX_MID + 8, 8), dtype, tf32)
        with pytest.raises(ValueError, match="widths"):
            K.pack_neck(_params(8, 32, K.MAX_OUT + 8), dtype, tf32)
        K.pack_neck(_params(8, K.MAX_MID, K.MAX_OUT), dtype, tf32)


def _split_a(a):
    """The kernel's split of A (conv_gemm.cuh ``split_tf32``): hi rounded to
    TF32; lo = a - hi passed with 0x1000 added and read by the tensor core
    as its top 19 bits."""
    hi = tf32_round(a)
    lo_bits = (a - hi).view(torch.int32) + 0x1000
    return hi.numpy(), (lo_bits & -0x2000).view(torch.float32).numpy()


def _gemm(rows, w):
    """sum over taps and 32-channel chunks, as the kernel computes it: rows
    (taps, P, chunks * 32) the A rows each tap reads; w the packed B. Per
    chunk, A in K slot order, split; per 8-deep step a_lo.b_hi, a_hi.b_lo,
    a_hi.b_hi summed into a fresh f32 tile, added to the running sum."""
    taps, chunks, _, nb = w.shape[:4]
    acc = np.zeros((rows.shape[1], nb * 8), np.float32)
    for t in range(taps):
        for c in range(chunks):
            a = rows[t, :, c * KC : (c + 1) * KC].reshape(-1, 4, 8)[:, :, list(KSLOT)]
            ah, al = _split_a(torch.from_numpy(a.reshape(-1, KC).copy()))
            # (2, nb, kb, r, e) -> (2, n, 32): row 8 nb + r, K slot 4 kb + e.
            bh, bl = w[t, c].transpose(0, 1, 3, 2, 4).reshape(2, nb * 8, KC)
            part = np.zeros_like(acc)
            for s in range(0, KC, 8):
                for lhs, rhs in ((al, bh), (ah, bl), (ah, bh)):
                    part += lhs[:, s : s + 8] @ rhs[:, s : s + 8].T
            acc += part
    return acc


def _ln_gelu(y, width, step, p):
    y = torch.from_numpy(y[:, :width]) + p[f"{step}.conv.bias"]
    y = F.layer_norm(y, (width,), p[f"{step}.ln.weight"], p[f"{step}.ln.bias"], eps=1e-6)
    return F.gelu(y).numpy()


def _emulate(f0, u, p):
    """The kernel's two launches from the packed operands: step1 (one tap,
    K = C0) + LN + GELU + u -> t; the 3x3 over t zero-padded (nine taps,
    K = 9 Cm) + LN + GELU."""
    packed = {k: v.numpy() for k, v in K.pack_neck(p).items()}
    b, h, w, c0 = f0.shape
    cm, co = u.shape[-1], p["step2_0.conv.weight"].shape[0]
    rows = np.zeros((1, b * h * w, packed["w1"].shape[1] * KC), np.float32)
    rows[0, :, :c0] = f0.reshape(-1, c0)
    t = _ln_gelu(_gemm(rows, packed["w1"]), cm, "step1_0", p) + u.reshape(-1, cm)
    tp = np.zeros((b, h + 2, w + 2, packed["w2"].shape[1] * KC), np.float32)
    tp[:, 1:-1, 1:-1, :cm] = t.reshape(b, h, w, cm)
    rows = np.stack([
        tp[:, ky : ky + h, kx : kx + w].reshape(b * h * w, -1) for ky in range(3) for kx in range(3)
    ])
    return _ln_gelu(_gemm(rows, packed["w2"]), co, "step2_0", p).reshape(b, h, w, co)


@pytest.mark.parametrize("shape", SHAPES, ids=["micro", "flagship"])
def test_emulated_3xtf32_matches_plain(shape):
    h, w, c0, cm, co = shape
    p = _params(c0, cm, co, seed=1)
    rng = np.random.default_rng(2)
    f0 = rng.standard_normal((1, h, w, c0)).astype(np.float32)
    u = rng.standard_normal((1, h, w, cm)).astype(np.float32)
    with torch.no_grad():
        want = K.fused_neck_l0_plain(torch.from_numpy(f0), torch.from_numpy(u), p).numpy()
        got = _emulate(f0, u, p)
    assert got.shape == want.shape == (1, h, w, co)
    rel = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert rel <= REL_TOL, rel


# The bf16 one-pass kernels (csrc/conv_tma.cuh, fpn_neck_l0.cu): W1 and the
# 3x3's taps in 64-channel chunks of 128-byte swizzled rows (W1 held whole
# by each block); A as one TMA box a chunk of 16 columns by 4 rows (step1)
# or a halo of 18 by 10 (step2, each tap reading its shifted 16 x 8 rows),
# zero past the map's edges.
BF16_SHAPES = [(2, 11, 21, 72, 384, 96), (1, 13, 19, 8, 32, 8)]


def _unswizzle(w):
    """(..., chunks, n/8, 8 rows, 8 pieces, 8) in the 128-byte swizzle ->
    (..., chunks * 64, n) f32: piece j of row r holds K group j ^ r."""
    *lead, chunks, nb = w.shape[:-3]
    rows = torch.arange(8)
    t = w[..., rows[:, None], rows[:, None] ^ rows[None, :], :]
    nl = len(lead)
    t = t.permute(*range(nl), nl, nl + 3, nl + 4, nl + 1, nl + 2)
    return t.reshape(*lead, chunks * 64, nb * 8).float()


def _box(x, b, y0, x0, c0, rows, cols):
    """The TMA box of 64 channels by ``cols`` columns by ``rows`` rows of
    image b of x (B, H, W, C) at (c0, x0, y0), zero past the map's edges."""
    _, h, w, c = x.shape
    out = torch.zeros(rows, cols, 64)
    ys, xs = slice(max(y0, 0), min(y0 + rows, h)), slice(max(x0, 0), min(x0 + cols, w))
    if ys.start < ys.stop and xs.start < xs.stop and c0 < c:
        part = x[b, ys, xs, c0 : min(c0 + 64, c)]
        out[ys.start - y0 : ys.stop - y0, xs.start - x0 : xs.stop - x0, : part.shape[-1]] = part
    return out


def _tiles(b, h, w, rows):
    """The kernels' tiles in walk order: image, then tile row, then column."""
    return [(bb, y, x) for bb in range(b) for y in range(0, h, rows) for x in range(0, w, 16)]


def _ln_gelu_rows(z, width, vec):
    z = z[:, :width] + vec[0, :width]
    return F.gelu(F.layer_norm(z, (width,), vec[1, :width], vec[2, :width], eps=1e-6))


def _emulate_bf16(f0, u, p):
    """The bf16 kernels' two launches from the packed operands: step1 over
    64-pixel tiles (4 x 16), K = ceil(C0 / 64) chunks of W1, + LN + GELU + u
    -> t rounded to bf16; step2 over 128-pixel tiles (8 x 16), per chunk
    one 18 x 10 halo box of t whose shifted rows feed the nine taps, + LN +
    GELU -> bf16."""
    packed = K.pack_neck(p, torch.bfloat16)
    w1, w2 = _unswizzle(packed["w1"])[0], _unswizzle(packed["w2"])
    b, h, w, _ = f0.shape
    cm, co = u.shape[-1], p["step2_0.conv.weight"].shape[0]
    t = torch.zeros(b, h, w, cm)
    for bb, y0, x0 in _tiles(b, h, w, 4):
        acc = torch.zeros(64, w1.shape[1])
        for ch in range(packed["w1"].shape[1]):
            acc += _box(f0.float(), bb, y0, x0, 64 * ch, 4, 16).reshape(64, 64) @ w1[64 * ch : 64 * ch + 64]
        y = _ln_gelu_rows(acc, cm, packed["vec1"])
        for r in range(64):
            i, j = y0 + r // 16, x0 + r % 16
            if i < h and j < w:
                t[bb, i, j] = y[r] + u[bb, i, j].float()
    t = t.to(torch.bfloat16).float()
    out = torch.zeros(b, h, w, co)
    chunks = packed["w2"].shape[1]
    for bb, y0, x0 in _tiles(b, h, w, 8):
        acc = torch.zeros(128, w2.shape[-1])
        for ch in range(chunks):
            box = _box(t, bb, y0 - 1, x0 - 1, 64 * ch, 10, 18)
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                acc += box[ky : ky + 8, kx : kx + 16].reshape(128, 64) @ w2[tap, 64 * ch : 64 * ch + 64]
        y = _ln_gelu_rows(acc, co, packed["vec2"])
        for r in range(128):
            i, j = y0 + r // 16, x0 + r % 16
            if i < h and j < w:
                out[bb, i, j] = y[r]
    return out.to(torch.bfloat16)


def test_bf16_pack_unswizzles_to_w1_and_taps():
    """The bf16 one-pass pack: W1 (one tap) as ceil(C0 / 64) chunks of 384 rows and the
    3x3's nine taps as ceil(Cm / 64) chunks of 96 rows, each in the 128-byte
    swizzle, unswizzling to the bf16 weights, zero past C0, Cm and Co."""
    c0, cm, co = 72, 32, 8
    p = _params(c0, cm, co, seed=3)
    packed = K.pack_neck(p, torch.bfloat16)
    assert packed["w1"].shape == (1, 2, K.MID_WIDTH // 8, 8, 8, 8)
    assert packed["w2"].shape == (9, 1, K.OUT_WIDTH // 8, 8, 8, 8)
    w1 = _unswizzle(packed["w1"])[0]
    w2 = _unswizzle(packed["w2"])
    assert torch.equal(w1[:c0, :cm], p["step1_0.conv.weight"].t().to(torch.bfloat16).float())
    assert not w1[c0:].any() and not w1[:, cm:].any()
    taps = p["step2_0.conv.weight"].permute(2, 3, 1, 0).reshape(9, cm, co)
    assert torch.equal(w2[:, :cm, :co], taps.to(torch.bfloat16).float())
    assert not w2[:, cm:].any() and not w2[:, :, co:].any()


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=["flagship_widths", "micro"])
def test_emulated_bf16_tile_walk_matches_plain(shape):
    """The bf16 kernels' walk over 2-D tiles of a ragged batch (tiles past the
    right and bottom edges), their boxes with TMA's zero fill (the 3x3's
    padding, channels past C0 in a partial chunk) and the swizzled weights
    reproduce ``fused_neck_l0_plain`` on bf16 inputs: within one bf16
    rounding of the output (8e-3 of the largest value; the f32 sums run in
    another order, which can flip a rounding of t or of the output), and
    equal on at least 99 % of the values."""
    b, h, w, c0, cm, co = shape
    p = _params(c0, cm, co, seed=4)
    rng = np.random.default_rng(5)
    f0 = torch.from_numpy(rng.standard_normal((b, h, w, c0)).astype(np.float32)).to(torch.bfloat16)
    u = torch.from_numpy(rng.standard_normal((b, h, w, cm)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        want = K.fused_neck_l0_plain(f0, u, p).float()
        got = _emulate_bf16(f0, u, p).float()
    assert got.shape == want.shape == (b, h, w, co)
    rel = float((got - want).abs().max()) / float(want.abs().max())
    assert rel <= 8e-3, rel
    assert float((got == want).float().mean()) >= 0.99


# The wide necks: (C0, Cm, Co) of the base and large backbones, on a small
# ragged map (B, H, W).
WIDE = {"base": (128, 512, 128), "large": (192, 768, 192)}
WIDE_MAP = (2, 5, 7)
KINDS = {"f32": (torch.float32, False), "tf32": (torch.float32, True), "bf16": (torch.bfloat16, False)}


def test_plan_routes_of_the_wide_and_ragged_widths():
    """``plan``: the base widths in two slices of 256 for step1 and one CTA
    of 128 for step2 in every kind; large in two slices of 384 (bf16,
    3xTF32) or four of 192 (TF32: a 384-wide W1 slice does not fit); past
    the resident W1 (C0 = 384) bf16 streams slices of 256 and TF32 takes
    conv_gemm.cuh's slices at one pass; Co > 192 two slices of 192; the
    flagship's widths one slice a step."""
    gemm, tma, streamed = K.GEMM, K.TMA, K.TMA_STREAMED
    assert K.plan("f32", 128, 512, 128) == ((gemm, 256, 2), (gemm, 128, 1))
    assert K.plan("tf32", 128, 512, 128) == ((tma, 256, 2), (tma, 128, 1))
    assert K.plan("bf16", 128, 512, 128) == ((tma, 256, 2), (tma, 128, 1))
    assert K.plan("f32", 192, 768, 192) == ((gemm, 384, 2), (gemm, 192, 1))
    assert K.plan("tf32", 192, 768, 192) == ((tma, 192, 4), (tma, 192, 1))
    assert K.plan("bf16", 192, 768, 192) == ((tma, 384, 2), (tma, 192, 1))
    assert K.plan("bf16", 384, 520, 264) == ((streamed, 256, 3), (tma, 192, 2))
    assert K.plan("tf32", 384, 520, 264) == ((gemm, 384, 2), (tma, 192, 2))
    assert K.plan("f32", 96, 384, 96) == ((gemm, 384, 1), (gemm, 96, 1))
    assert K.plan("bf16", 96, 384, 96) == ((tma, 384, 1), (tma, 96, 1))
    assert K.plan("tf32", 104, 64, 8) == ((gemm, 384, 1), (tma, 96, 1))
    with pytest.raises(ValueError, match="C0"):
        K.plan("bf16", 200, 384, 96)


def _dense_slices(w, route, taps):
    """A packed operand of ``slices`` slices -> (slices, taps, K, n) f32,
    undoing the layout index by index: the 128-byte swizzle's chunks (piece
    j of row r holds K group j ^ r, 64 bf16 or 32 f32 channels a chunk) or
    conv_gemm.cuh's TF32 hi + lo core matrices (K slot s of 8 holds channel
    KSLOT[s])."""
    if w.dim() == (7 if route == K.GEMM else 6):  # one slice: its axis dropped
        w = w.unsqueeze(0)
    w = w.float()
    if route == K.GEMM:
        parts = [torch.stack(_unpack(w[s])) for s in range(w.shape[0])]
        return torch.stack([hi + lo for hi, lo in parts])
    slices, _, chunks, nb, _, _, e = w.shape
    rows = torch.arange(8)
    t = w[..., rows[:, None], rows[:, None] ^ rows[None, :], :]  # (.., row group, row, K group, K)
    t = t.permute(0, 1, 2, 5, 6, 3, 4)  # (slice, tap, chunk, K group, K, row group, row)
    return t.reshape(slices, taps, chunks * 8 * e, nb * 8)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("size", list(WIDE))
def test_wide_slice_packs_unpack_index_by_index_to_w1_and_the_taps(size, kind):
    """Each slice of the wide packs is W1's (C0 x its features) and the nine
    taps' (Cm x its features) in the route's layout, element by element:
    bf16 rounded, TF32 rounded to TF32 where the route is TMA-fed (the
    3xTF32 layout's hi + lo within 2^-21), zero past C0, Cm and Co and past
    the last slice's real features; the vectors (3, slices x width)."""
    c0, cm, co = WIDE[size]
    dtype, tf32 = KINDS[kind]
    p = _params(c0, cm, co, seed=21)
    packed = K.pack_neck(p, dtype, tf32)
    steps = K.plan(kind, c0, cm, co)
    taps1 = p["step1_0.conv.weight"].t()[None]
    taps2 = p["step2_0.conv.weight"].permute(2, 3, 1, 0).reshape(9, cm, co)
    for key, vec, (route, n, slices), taps, step in (
        ("w1", "vec1", steps[0], taps1, "step1_0"), ("w2", "vec2", steps[1], taps2, "step2_0"),
    ):
        got = _dense_slices(packed[key], route, taps.shape[0])
        assert got.shape[0] == slices and got.shape[-1] == n
        k, f = taps.shape[1:]
        want = torch.zeros(slices, taps.shape[0], got.shape[2], n)
        for s in range(slices):
            part = taps[:, :, s * n : min(f, (s + 1) * n)]
            want[s, :, :k, : part.shape[-1]] = part
        if kind == "bf16":
            want = want.to(torch.bfloat16).float()
            assert torch.equal(got, want)
        elif route == K.TMA:
            assert torch.equal(got, tf32_round(want))
        else:
            torch.testing.assert_close(got.double(), want.double(), rtol=2.0 ** -21, atol=0)
        rows = torch.stack([p[f"{step}.conv.bias"], p[f"{step}.ln.weight"], p[f"{step}.ln.bias"]])
        assert packed[vec].shape == (3, slices * n)
        assert torch.equal(packed[vec][:, :f], rows) and not packed[vec][:, f:].any()


def _slice_ln_gelu(zs, f, n, vec):
    """The cluster kernels' epilogue over one step's slices z_s = acc + bias
    (rows by n features, zero past f): each slice's row sum and squared
    deviations from its own mean over its real features, combined in rank
    order (Chan, Golub and LeVeque's update) into the mean and rstd over f,
    then each slice's GELU(LN(z)), concatenated and cut to f."""
    stats = []
    for s, z in enumerate(zs):
        nr = min(max(f - s * n, 0), n)
        real = (torch.arange(s * n, (s + 1) * n) < f).float()
        total = z.sum(-1)
        mine = total / nr if nr else torch.zeros_like(total)
        stats.append((total, (((z - mine[..., None]) * real) ** 2).sum(-1), nr, mine))
    total = torch.zeros_like(stats[0][0])
    for t_s, _, _, _ in stats:
        total = total + t_s
    mean = total / f
    m2 = torch.zeros_like(total)
    for _, q, nr, mine in stats:
        m2 = m2 + q + nr * (mine - mean) ** 2
    rstd = torch.rsqrt(m2 / f + K.EPS)
    ys = [F.gelu((z - mean[..., None]) * rstd[..., None] * vec[1, s * n : (s + 1) * n] + vec[2, s * n : (s + 1) * n])
          for s, z in enumerate(zs)]
    return torch.cat(ys, -1)[..., :f]


def _emulate_neck_cluster(f0, u, p, kind, t_in=None):
    """(t, out) of the wide neck as its cluster kernels compute it, from the
    packs of ``kind``: step1 per slice of Cm its products (f0 rounded to
    TF32 where the route is TMA-fed TF32) plus the slice's bias, the
    slices' statistics combined in rank order, GELU, + u -> t (bf16:
    rounded); step2 per slice of Co the 3x3 over ``t_in`` (the twin's t, so
    that a flipped rounding of t does not spread; else the emulated t; TF32
    rounded) plus its bias, the same epilogue -> out."""
    dtype, tf32 = KINDS[kind]
    c0, cm, co = f0.shape[-1], u.shape[-1], p["step2_0.conv.weight"].shape[0]
    packed = K.pack_neck(p, dtype, tf32)
    (r1, n1, s1), (r2, n2, s2) = K.plan(kind, c0, cm, co)
    rnd = (lambda v: tf32_round(v)) if kind == "tf32" else (lambda v: v)
    w1 = _dense_slices(packed["w1"], r1, 1)[:, 0, :c0]  # (slices, C0, n1)
    zs = [rnd(f0.float()) @ w1[s] + packed["vec1"][0, s * n1 : (s + 1) * n1] for s in range(s1)]
    t = _slice_ln_gelu(zs, cm, n1, packed["vec1"]) + u.float()
    if kind == "bf16":
        t = t.to(torch.bfloat16).float()
    src = (t if t_in is None else t_in.float()).permute(0, 3, 1, 2)
    w2 = _dense_slices(packed["w2"], r2, 9)[:, :, :cm]  # (slices, 9, Cm, n2)
    zs = []
    for s in range(s2):
        weight = w2[s].reshape(3, 3, cm, n2).permute(3, 2, 0, 1)
        z = F.conv2d(rnd(src), weight, padding=1).permute(0, 2, 3, 1)
        zs.append(z + packed["vec2"][0, s * n2 : (s + 1) * n2])
    out = _slice_ln_gelu(zs, co, n2, packed["vec2"])
    return t, (out.to(torch.bfloat16).float() if kind == "bf16" else out)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("size", list(WIDE))
def test_emulated_neck_cluster_matches_plain(size, kind):
    """The wide neck's cluster walk (``_emulate_neck_cluster``) against
    ``fused_neck_l0_plain`` on a ragged batch: f32 within REL_TOL of the
    twin end to end; TF32 against the TF32 twin, step1 against its t and
    step2 run on that t against its output, each within REL_TOL (the f32
    sums run in another order, which can flip a TF32 rounding of t); bf16
    the same stage by stage within one bf16 rounding (8e-3 of the largest
    value) and equal on at least 99 % of the values."""
    c0, cm, co = WIDE[size]
    dtype, tf32 = KINDS[kind]
    p = _params(c0, cm, co, seed=22)
    rng = np.random.default_rng(23)
    f0 = torch.from_numpy(rng.standard_normal((*WIDE_MAP, c0)).astype(np.float32)).to(dtype)
    u = torch.from_numpy(rng.standard_normal((*WIDE_MAP, cm)).astype(np.float32)).to(dtype)
    with torch.no_grad():
        want = K.fused_neck_l0_plain(f0, u, p, tf32=tf32).float()
        if kind == "f32":
            _, got = _emulate_neck_cluster(f0, u, p, kind)
            rel = float((got - want).abs().max()) / float(want.abs().max())
            assert rel <= REL_TOL, rel
            return
        rnd = tf32_round if tf32 else (lambda v: v)
        w1 = p["step1_0.conv.weight"] if tf32 else p["step1_0.conv.weight"].to(torch.bfloat16).float()
        a = F.layer_norm(F.linear(rnd(f0.float()), rnd(w1), p["step1_0.conv.bias"]), (cm,),
                         p["step1_0.ln.weight"], p["step1_0.ln.bias"], eps=K.EPS)
        t_twin = F.gelu(a) + u.float()
        if kind == "bf16":
            t_twin = t_twin.to(torch.bfloat16).float()
        t, got = _emulate_neck_cluster(f0, u, p, kind, t_in=t_twin)
    for g, w in ((t, t_twin), (got, want)):
        assert g.shape == w.shape
        rel = float((g - w).abs().max()) / float(w.abs().max())
        if kind == "tf32":
            assert rel <= REL_TOL, rel
        else:
            assert rel <= 8e-3, rel
            assert float((g == w).float().mean()) >= 0.99
