"""The neck level-0 kernel's weight packing (``adascale_torch/kernels/fpn_neck.py``
``pack_neck``) and its arithmetic, on the CPU: the packed TF32 hi + lo parts
unpack to W1 (as C0 x Cm) and to the 3x3's nine taps (tap 3 ky + kx as
Cm x Co), with hi exact TF32 and zero past the real widths; a numpy
emulation of the kernel's 3xTF32 products, read from the packed operands in
the kernel's order with its split of A (the dropped lo.lo product, each
32-deep chunk summed in a fresh tile), matches ``fused_neck_l0_plain``
within 1e-5 relative (the kernel's bar on the card), at the micro widths on
a ragged 13x19 map and at the flagship's (K = 96 and 9 x 384). The pack
cache is tested with the heads' (``test_torch_heads_packing.py``)."""
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
    """Past one tile the layout takes slices of it (the base and large
    widths), up to MAX_SLICES; wider raises."""
    with pytest.raises(ValueError, match="widths"):
        K.pack_neck(_params(8, K.MAX_SLICES * K.MID_WIDTH + 8, 8))
    with pytest.raises(ValueError, match="widths"):
        K.pack_neck(_params(8, 32, K.MAX_SLICES * K.OUT_WIDTH + 8))


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
