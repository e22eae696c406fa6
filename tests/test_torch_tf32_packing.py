"""The single-pass TF32 entries' weight packing on the CPU (no kernel runs
here): the ConvNeXt block's (``adascale_torch/kernels/packing.py``
``pack_core_kmajor_tf32``, ``pack_tiles_sw128_tf32``, ``pack_block_tf32``,
the layouts ``csrc/block_tf32.cuh`` reads), the rough and precise heads'
(``pack_sw128_tf32`` through ``fpn_heads.pack_heads(..., tf32_sw128=True)``,
the layout ``fpn_head.cuh::heads_tma_kernel`` reads in f32) and the neck
level 0's (``fpn_neck.pack_neck(..., tf32_sw128=True)``, the layouts
``fpn_neck_l0.cu``'s one-pass steps read in f32). Each layout element by
element against an index-by-index reimplementation, zero past the real
widths, with a round trip back to nn.Linear's and the conv's weights; every
packed value equal bit for bit to ``utils.precision.round_tf32`` of its
source (``wgmma`` drops an f32 operand's low 13 bits, so the packs hold
rounded values); W2's K order against the accumulator-to-A fragment map of
the fused form, written out here; emulations of the fused form's chunk
walk and of the heads' and the neck's TMA tile walks from the packs
against the TF32 twins; and the wrappers' reuse of a parameter set's pack,
each layout kept apart."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adascale_torch.kernels import convnext_block as K
from adascale_torch.kernels import fpn_heads, fpn_neck, packing
from adascale_torch.kernels.packing import (
    BLOCK_FUSED_MAX_C, BLOCK_TF32_HIDDEN, BLOCK_TF32_TILE, KSLOT, block_fused_width, kslot_columns,
    pack_block_tf32, pack_core_kmajor_tf32, pack_sw128_tf32, pack_tiles_sw128_tf32,
)
from adascale_torch.ops.fused_upsample import heads_phase_form, phase_tap_weights
from adascale_torch.utils.precision import round_tf32

PRECISE_OUTS = (1, 2, 4, 4)
PRECISE_WIDTH = 200  # csrc/precise_heads.cu's tile
ROUGH_WIDTH = 192  # csrc/fpn_heads.cu's tile


def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _bits(t):
    return t.detach().float().contiguous().view(torch.int32)


def _weights(c, seed=0):
    """W1 (4C, C) and W2 (C, 4C) from numpy."""
    rng = np.random.default_rng(seed)
    return _randn(rng, 4 * c, c), _randn(rng, c, 4 * c)


def _expected_core_kmajor_tf32(w, rows, depth):
    """pack_core_kmajor_tf32's layout for the numpy (n, k) ``w``, element
    by element: tile (i, j), row group rg, K group kg, row r, K e holds
    w[rows i + 8 rg + r, depth j + 4 kg + e], zero past w."""
    n, k = w.shape
    nt, kt = -(-n // rows), -(-k // depth)
    out = np.zeros((nt, kt, rows // 8, depth // 4, 8, 4), np.float32)
    for i in range(nt):
        for j in range(kt):
            for rg in range(rows // 8):
                for r in range(8):
                    for kg in range(depth // 4):
                        for e in range(4):
                            row, col = rows * i + 8 * rg + r, depth * j + 4 * kg + e
                            if row < n and col < k:
                                out[i, j, rg, kg, r, e] = w[row, col]
    return out


def _expected_sw128_tf32(t):
    """pack_sw128_tf32's layout for the numpy (k, n) ``t``: element (kk, nn)
    at [kk // 32, nn // 8, nn % 8, ((kk % 32) // 4) ^ (nn % 8), kk % 4]."""
    k, n = t.shape
    out = np.zeros((k // 32, n // 8, 8, 8, 4), np.float32)
    for kk in range(k):
        for nn in range(n):
            out[kk // 32, nn // 8, nn % 8, ((kk % 32) // 4) ^ (nn % 8), kk % 4] = t[kk, nn]
    return out


@pytest.mark.parametrize("n,k,rows,depth", [(40, 24, 16, 16), (64, 96, 64, 96), (24, 200, 8, 32)])
def test_core_kmajor_tf32_matches_the_layout_index_by_index(n, k, rows, depth):
    w = _randn(np.random.default_rng(1), n, k)
    got = pack_core_kmajor_tf32(w, rows, depth)
    assert got.dtype == torch.float32 and got.is_contiguous()
    want = _expected_core_kmajor_tf32(round_tf32(w).numpy(), rows, depth)
    assert np.array_equal(got.view(torch.int32).numpy(), want.view(np.int32))


@pytest.mark.parametrize("k,n", [(32, 8), (96, 24), (64, 200)])
def test_sw128_tf32_matches_the_layout_index_by_index(k, n):
    t = _randn(np.random.default_rng(2), k, n)
    got = pack_sw128_tf32(t)
    assert got.shape == (k // 32, n // 8, 8, 8, 4) and got.dtype == torch.float32
    want = _expected_sw128_tf32(round_tf32(t).numpy())
    assert np.array_equal(got.view(torch.int32).numpy(), want.view(np.int32))


def _fused_layout(c):
    cp = block_fused_width(c)
    nh = BLOCK_TF32_HIDDEN[cp]
    return cp, nh, -(-4 * c // nh)


@pytest.mark.parametrize("c", [96, 128, 192, 40])
def test_fused_pack_index_by_index_and_round_trip(c):
    """The fused form's buffer: per chunk of NH hidden units the W1 rows as
    an NH x CP core-matrix tile, then the W2 columns as a CP x NH tile with
    K slot s of each 8 holding unit KSLOT[s]; every value round_tf32 of its
    source, zero past C and 4C; unpacked, the rounded weights."""
    w1, w2 = _weights(c)
    cp, nh, chunks = _fused_layout(c)
    p = pack_block_tf32(w1, w2)
    assert p["w2"].numel() == 0 and p["w1"].numel() == chunks * 2 * nh * cp
    t = p["w1"].reshape(chunks, 2, nh * cp)
    w1r, w2r = round_tf32(w1).numpy(), round_tf32(w2).numpy()
    up = _expected_core_kmajor_tf32(w1r, nh, cp).reshape(chunks, nh * cp)
    assert np.array_equal(t[:, 0].contiguous().view(torch.int32).numpy(), up.view(np.int32))
    down = np.zeros((chunks, cp // 8, nh // 4, 8, 4), np.float32)
    for j in range(chunks):
        for rg in range(cp // 8):
            for r in range(8):
                for kg in range(nh // 4):
                    for e in range(4):
                        slot = 4 * kg + e
                        unit = j * nh + 8 * (slot // 8) + KSLOT[slot % 8]
                        out_c = 8 * rg + r
                        if out_c < c and unit < 4 * c:
                            down[j, rg, kg, r, e] = w2r[out_c, unit]
    assert np.array_equal(t[:, 1].contiguous().view(torch.int32).numpy(), down.reshape(chunks, -1).view(np.int32))
    # Round trip: W1 (4C, C) and W2 (C, 4C) back from the tiles.
    back1 = t[:, 0].reshape(chunks, nh // 8, cp // 4, 8, 4).permute(0, 1, 3, 2, 4).reshape(chunks * nh, cp)
    back2 = t[:, 1].reshape(chunks, cp // 8, nh // 4, 8, 4).permute(1, 3, 0, 2, 4).reshape(cp, chunks * nh)
    back2 = back2[:, torch.argsort(kslot_columns(chunks * nh))]
    assert torch.equal(_bits(back1[: 4 * c, :c]), _bits(round_tf32(w1)))
    assert torch.equal(_bits(back2[:c, : 4 * c]), _bits(round_tf32(w2)))
    assert not back1[4 * c :].any() and not back1[:, c:].any()
    assert not back2[c:].any() and not back2[:, 4 * c :].any()


def _unpack_tiles(flat, n, k):
    """A two-GEMM pack back to its padded (N, K) operand, by the swizzle:
    element (nn, kk) of tile nn // 128, chunk kk // 32 sits at row group
    (nn % 128) // 8, row nn % 8, piece ((kk % 32) // 4) ^ (nn % 8), kk % 4."""
    bn, bk = BLOCK_TF32_TILE
    nt, kt = -(-n // bn), -(-k // bk)
    t = flat.reshape(nt, kt, bn // 8, 8, 8, 4)
    nn = torch.arange(nt * bn)[:, None]
    kk = torch.arange(kt * bk)[None, :]
    return t[nn // bn, kk // bk, (nn % bn) // 8, nn % 8, ((kk % bk) // 4) ^ (nn % 8), kk % 4]


@pytest.mark.parametrize("c", [384, 260])
def test_two_gemm_pack_index_by_index_and_round_trip(c):
    """The two-GEMM form: W1 (4C, C) and W2 (C, 4C) each in 128-row tiles of
    32-deep chunks in the 128-byte swizzle (pack_sw128_tf32's element map),
    round_tf32 of the source, zero past N and K."""
    w1, w2 = _weights(c, 3)
    p = pack_block_tf32(w1, w2)
    bn, bk = BLOCK_TF32_TILE
    for w, got in ((w1, p["w1"]), (w2, p["w2"])):
        n, k = w.shape
        np_, kp = -(-n // bn) * bn, -(-k // bk) * bk
        assert got.numel() == np_ * kp
        want = torch.zeros(np_, kp)
        want[:n, :k] = round_tf32(w)
        assert torch.equal(_bits(_unpack_tiles(got, n, k)), _bits(want))
        # One tile index by index against pack_sw128_tf32's map.
        tile = got.reshape(np_ // bn, kp // bk, -1)[-1, -1].reshape(bn // 8, 8, 8, 4)
        expect = _expected_sw128_tf32(want[np_ - bn :, kp - bk :].t().contiguous().numpy())[0]
        assert np.array_equal(tile.contiguous().view(torch.int32).numpy(), expect.view(np.int32))


def test_form_and_hidden_chunk_by_channels():
    """C <= 192 takes the fused form at bf16's widths with 64 hidden units a
    chunk (32 at width 192); wider C the two-GEMM form, 128 x 32 tiles."""
    assert BLOCK_FUSED_MAX_C == 192 and BLOCK_TF32_HIDDEN == {96: 64, 128: 64, 192: 32}
    assert BLOCK_TF32_TILE == (128, 32)
    for c in (8, 96, 100, 128, 132, 192, 196, 384, 768, 1536):
        w1, w2 = torch.zeros(4 * c, c), torch.zeros(c, 4 * c)
        p = pack_block_tf32(w1, w2)
        if c <= 192:
            cp, nh, chunks = _fused_layout(c)
            assert cp >= c and p["w1"].numel() == chunks * 2 * nh * cp and p["w2"].numel() == 0
        else:
            assert block_fused_width(c) == 0 and p["w2"].numel() == -(-c // 128) * 128 * -(-4 * c // 32) * 32


@pytest.mark.parametrize("nh", [64, 32])
def test_w2_k_order_matches_the_accumulator_to_a_fragment_map(nh):
    """The fused form hands GEMM 1's sums to GEMM 2 in registers. Written out:
    register i of thread t's m64nNk8 accumulator holds row half (i % 4) // 2
    (rows g, g + 8) and hidden unit 8 (i // 4) + 2 t + i % 2; register r of
    its TF32 A fragment for k8 step s holds row half r % 2 and K slot t + 4
    (r // 2) of that step; the kernel puts accumulator 4 s + (0, 2, 1, 3)[r]
    in fragment register 4 s + r. So slot t holds unit 2 t and slot t + 4
    unit 2 t + 1 of each 8, and W2's packed K slot 8 s + slot must hold that
    unit: kslot_columns. Then a product through the fragments with the
    packed W2 tile is u . W2^T."""
    order = kslot_columns(nh).tolist()
    for t in range(4):
        for s in range(nh // 8):
            for r in range(4):
                i = 4 * s + (0, 2, 1, 3)[r]
                half, unit = (i % 4) // 2, 8 * (i // 4) + 2 * t + i % 2
                assert half == r % 2
                assert order[8 * s + t + 4 * (r // 2)] == unit
    # GEMM 2 of one chunk from the packed tile, A in the fragments' K order.
    c = 96 if nh == 64 else 192
    cp = block_fused_width(c)
    rng = np.random.default_rng(4)
    w1, w2 = _randn(rng, 4 * c, c), _randn(rng, c, 4 * c)
    u = round_tf32(_randn(rng, 64, nh))
    down = pack_block_tf32(w1, w2)["w1"].reshape(-1, 2, nh * cp)[1, 1]  # chunk 1's W2 tile
    b = down.reshape(cp // 8, nh // 4, 8, 4).permute(0, 2, 1, 3).reshape(cp, nh)  # (out, K slot)
    got = u[:, kslot_columns(nh)].double() @ b.double().T
    want = u.double() @ round_tf32(w2[:, nh : 2 * nh]).double().T
    torch.testing.assert_close(got[:, :c], want, rtol=0, atol=1e-9)


def _block_params(c, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "dwconv.weight": _randn(rng, c, 1, 7, 7, scale=0.2), "dwconv.bias": _randn(rng, c, scale=0.1),
        "ln.weight": 1 + _randn(rng, c, scale=0.1), "ln.bias": _randn(rng, c, scale=0.1),
        "mlp_up.weight": _randn(rng, 4 * c, c, scale=c ** -0.5), "mlp_up.bias": _randn(rng, 4 * c, scale=0.1),
        "mlp_down.weight": _randn(rng, c, 4 * c, scale=(4 * c) ** -0.5),
        "mlp_down.bias": _randn(rng, c, scale=0.1), "block_scale": _randn(rng, c),
    }


@pytest.mark.parametrize("c", [96, 192, 40])
def test_emulated_fused_form_matches_the_tf32_twin(c):
    """The fused form's MLP as the kernel walks it, from the pack: h rounded
    to TF32 into the block's tile (zero past C), per chunk GEMM 1 on the W1
    tile, b1 and the GELU, u rounded into the fragments' K order, GEMM 2 on
    the W2 tile accumulated over the chunks, then the residual; against the
    TF32 twin's MLP (``convnext_block_plain(..., tf32=True)``'s operands).
    Sums in f64 on both sides, so that only the layout can part them."""
    rng = np.random.default_rng(5)
    p = _block_params(c)
    m = 37
    h, x = _randn(rng, m, c), _randn(rng, m, c)
    cp, nh, chunks = _fused_layout(c)
    t = pack_block_tf32(p["mlp_up.weight"], p["mlp_down.weight"])["w1"].reshape(chunks, 2, nh * cp)
    hs = torch.zeros(m, cp)
    hs[:, :c] = round_tf32(h)
    b1 = F.pad(p["mlp_up.bias"], (0, chunks * nh - 4 * c))
    acc2 = torch.zeros(m, cp, dtype=torch.float64)
    for j in range(chunks):
        w1t = t[j, 0].reshape(nh // 8, cp // 4, 8, 4).permute(0, 2, 1, 3).reshape(nh, cp)
        w2t = t[j, 1].reshape(cp // 8, nh // 4, 8, 4).permute(0, 2, 1, 3).reshape(cp, nh)
        acc1 = hs.double() @ w1t.double().T
        u = F.gelu((acc1 + b1[j * nh : (j + 1) * nh].double()).float())
        acc2 += round_tf32(u)[:, kslot_columns(nh)].double() @ w2t.double().T
    got = x + (acc2[:, :c].float() + p["mlp_down.bias"]) * p["block_scale"]
    u = F.gelu((round_tf32(h).double() @ round_tf32(p["mlp_up.weight"]).double().T + p["mlp_up.bias"].double()).float())
    y = round_tf32(u).double() @ round_tf32(p["mlp_down.weight"]).double().T
    want = x + (y.float() + p["mlp_down.bias"]) * p["block_scale"]
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def _precise_heads(c, seed=6):
    rng = np.random.default_rng(seed)
    heads = []
    for m in PRECISE_OUTS:
        f = (c + m) // 2
        heads.append({
            "step1.conv.weight": _randn(rng, f, c, 3, 3, scale=(9 * c) ** -0.5),
            "step1.conv.bias": _randn(rng, f, scale=0.1), "step1.ln.weight": 1 + _randn(rng, f, scale=0.1),
            "step1.ln.bias": _randn(rng, f, scale=0.1), "step2.weight": _randn(rng, m, f, scale=f ** -0.5),
            "step2.bias": _randn(rng, m, scale=0.1),
        })
    return heads


def _unswizzle_tf32(w):
    """(..., chunks, n/8, 8 rows, 8 pieces, 4) in the 128-byte swizzle ->
    (..., chunks * 32, n): piece j of row r holds K group j ^ r."""
    *lead, chunks, nb = w.shape[:-3]
    rows = torch.arange(8)
    t = w[..., rows[:, None], rows[:, None] ^ rows[None, :], :]  # (.., row, K group, K)
    nl = len(lead)
    t = t.permute(*range(nl), nl, nl + 3, nl + 4, nl + 1, nl + 2)
    return t.reshape(*lead, chunks * 32, nb * 8)


def _rough_heads(c, seed=10):
    """The two rough heads (char mask, char height): F = 192 at C = 384,
    here (C + 1) // 2, one output each."""
    rng = np.random.default_rng(seed)
    f = (c + 1) // 2
    return [{
        "step1.conv.weight": _randn(rng, f, c, 3, 3, scale=(9 * c) ** -0.5),
        "step1.conv.bias": _randn(rng, f, scale=0.1), "step1.ln.weight": 1 + _randn(rng, f, scale=0.1),
        "step1.ln.bias": _randn(rng, f, scale=0.1), "step2.weight": _randn(rng, 1, f, scale=f ** -0.5),
        "step2.bias": _randn(rng, 1, scale=0.1),
    } for _ in range(2)]


# The heads libraries' TF32 one-pass packs: (heads, tile width).
HEADS_LIBRARIES = {"precise": (_precise_heads, PRECISE_WIDTH), "rough": (_rough_heads, ROUGH_WIDTH)}


@pytest.mark.parametrize("library", list(HEADS_LIBRARIES))
@pytest.mark.parametrize("c", [32, 40])
def test_heads_tf32_pack_unpacks_to_rounded_phase_taps(c, library):
    """Each heads library's TF32 one-pass pack (the precise heads' 200-wide
    tile, the rough heads' 192): per (head, phase, tap) ceil(C / 32) chunks
    of N rows in the 128-byte swizzle, unswizzling to round_tf32 of the
    collapsed taps bit for bit, zero past C and past each head's F; the
    other packed parts as the f32 entry's."""
    make, width = HEADS_LIBRARIES[library]
    heads = make(c)
    packed = fpn_heads.pack_heads(heads, width, tf32_sw128=True)
    w = packed["w"]
    chunks = -(-c // 32)
    assert w.dtype == torch.float32 and w.shape == (len(heads), 4, 4, chunks, width // 8, 8, 8, 4)
    got = _unswizzle_tf32(w)
    for k, p in enumerate(heads):
        f = p["step1.conv.weight"].shape[0]
        want = round_tf32(phase_tap_weights(p["step1.conv.weight"]))
        assert torch.equal(_bits(got[k, :, :, :c, :f]), _bits(want))
        assert not got[k, :, :, c:].any() and not got[k, :, :, :, f:].any()
    f32 = fpn_heads.pack_heads(heads, width)
    for name in ("vec", "w2", "b2"):
        assert torch.equal(packed[name], f32[name])


def _box(x, b, y0, x0, c0, rows, cols):
    """A TMA box of 32 f32 channels by ``cols`` columns by ``rows`` rows of
    image b of x (B, H, W, C) at (c0, x0, y0), zero past the map's edges."""
    _, h, w, c = x.shape
    out = torch.zeros(rows, cols, 32)
    ys, xs = slice(max(y0, 0), min(y0 + rows, h)), slice(max(x0, 0), min(x0 + cols, w))
    if b < x.shape[0] and ys.start < ys.stop and xs.start < xs.stop and c0 < c:
        part = x[b, ys, xs, c0 : min(c0 + 32, c)]
        out[ys.start - y0 : ys.stop - y0, xs.start - x0 : xs.stop - x0, : part.shape[-1]] = part
    return out


@pytest.mark.parametrize("shape", [(2, 11, 21), (1, 8, 16)])
def test_emulated_tf32_tma_tile_walk_matches_the_tf32_twin(shape):
    """The precise heads' TF32 entry as heads_tma_kernel walks it in f32: unit
    u is (head, phase) u % 16 of tile u // 16 (8 x 16 pixels); per 32-channel
    chunk one halo box (9 x 17, TMA's zero fill past the edges and past C =
    40), each tap's shifted rows rounded to TF32 times that tap's unswizzled
    B; then bias, LN, GELU, the projection and the interleaved write. Against
    ``heads_phase_form(..., tf32=True)`` within 1e-5 of the largest value
    (the f32 sums run in another order)."""
    c = 40
    heads = _precise_heads(c, 7)
    rng = np.random.default_rng(8)
    x = _randn(rng, *shape, c)
    packed = fpn_heads.pack_heads(heads, PRECISE_WIDTH, tf32_sw128=True)
    bt = _unswizzle_tf32(packed["w"])
    b, h, wd, _ = x.shape
    sets, chunks = 16, packed["w"].shape[3]
    tiles_h, tiles_w = -(-h // 8), -(-wd // 16)
    outs = [p["step2.weight"].shape[0] for p in heads]
    out = torch.zeros(b, 2 * h, 2 * wd, sum(outs))
    for un in range(b * tiles_h * tiles_w * sets):
        s, tile = un % sets, un // sets
        bb, rem = divmod(tile, tiles_h * tiles_w)
        h0, w0 = 8 * (rem // tiles_w), 16 * (rem % tiles_w)
        head, phase = divmod(s, 4)
        pa, pb = divmod(phase, 2)
        acc = torch.zeros(128, PRECISE_WIDTH)
        for ch in range(chunks):
            box = _box(x, bb, h0 + pa - 1, w0 + pb - 1, 32 * ch, 9, 17)
            for tap in range(4):
                dy, dx = divmod(tap, 2)
                a = round_tf32(box[dy : dy + 8, dx : dx + 16].reshape(128, 32))
                acc += a @ bt[head, phase, tap, 32 * ch : 32 * ch + 32]
        m, f = heads[head]["step2.weight"].shape
        vec, w2 = packed["vec"][head], packed["w2"][head]
        z = F.layer_norm(acc[:, :f] + vec[0, :f], (f,), vec[1, :f], vec[2, :f], eps=1e-6)
        proj = F.gelu(z) @ w2[:m, :f].T + packed["b2"][head, :m]
        moff = sum(outs[:head])
        for r in range(128):
            i, j = h0 + r // 16, w0 + r % 16
            if i < h and j < wd:
                out[bb, 2 * i + pa, 2 * j + pb, moff : moff + m] = proj[r]
    want = heads_phase_form(x, heads, tf32=True)
    for g, wt in zip(out.split(outs, dim=-1), want):
        assert g.shape == tuple(wt.shape)
        assert float((g - wt).abs().max()) <= 1e-5 * float(wt.abs().max())


def test_tf32_launch_arguments_are_reused_per_parameter_set_and_rebuilt_on_change():
    """The TF32 block launch checks and packs a parameter set once: the same
    tensors at the same versions give the same arguments without a new
    pack; an in-place update rebuilds them; a tensor of the wrong shape is
    refused. The bf16 launch's pack of the same set is a pack of its own."""
    p = _block_params(96)
    dev = torch.device("cpu")
    packs = packing.PACKS
    args = K.tf32_weights(p, 96, dev)
    assert list(args) == list(K.BF16_ARGS) and packing.PACKS == packs + 1
    assert K.tf32_weights(p, 96, dev) is args and packing.PACKS == packs + 1
    assert torch.equal(args["w1"], pack_block_tf32(p["mlp_up.weight"], p["mlp_down.weight"])["w1"])
    with torch.no_grad():
        p["mlp_down.weight"].mul_(2.0)
    changed = K.tf32_weights(p, 96, dev)
    assert packing.PACKS == packs + 2 and changed["w1"].data_ptr() != args["w1"].data_ptr()
    torch.testing.assert_close(changed["w1"], pack_block_tf32(p["mlp_up.weight"], p["mlp_down.weight"])["w1"])
    bf16 = K.bf16_weights(p, 96, dev)
    assert packing.PACKS == packs + 3 and bf16["w1"].dtype == torch.bfloat16
    assert K.tf32_weights(p, 96, dev) is not changed and packing.PACKS == packs + 4
    with pytest.raises(ValueError, match="ln.bias"):
        K.tf32_weights(dict(p, **{"ln.bias": torch.zeros(95)}), 96, dev)


def test_heads_pack_cache_keys_the_tf32_layout():
    """packed_heads keeps the TF32 one-pass layout and the f32 entry's apart:
    each is built once for a parameter set and reused."""
    heads = _precise_heads(32, 9)
    packs = packing.PACKS
    sw = fpn_heads.packed_heads(heads, PRECISE_WIDTH, tf32_sw128=True)
    assert fpn_heads.packed_heads(heads, PRECISE_WIDTH, tf32_sw128=True) is sw
    assert packing.PACKS == packs + 1
    km = fpn_heads.packed_heads(heads, PRECISE_WIDTH)
    assert km["w"].shape != sw["w"].shape and packing.PACKS == packs + 2


def _neck_params(c0, cm, co, seed=11):
    """Level-0 parameters from numpy, at the scales of a trained neck."""
    rng = np.random.default_rng(seed)
    return {
        "step1_0.conv.weight": _randn(rng, cm, c0, scale=c0 ** -0.5),
        "step1_0.conv.bias": _randn(rng, cm, scale=0.1),
        "step1_0.ln.weight": 1 + _randn(rng, cm, scale=0.1), "step1_0.ln.bias": _randn(rng, cm, scale=0.1),
        "step2_0.conv.weight": _randn(rng, co, cm, 3, 3, scale=(9 * cm) ** -0.5),
        "step2_0.conv.bias": _randn(rng, co, scale=0.1),
        "step2_0.ln.weight": 1 + _randn(rng, co, scale=0.1), "step2_0.ln.bias": _randn(rng, co, scale=0.1),
    }


def _neck_taps(p):
    """W1 as (1 tap, C0, Cm) and the 3x3 as (9 taps, Cm, Co), tap 3 ky + kx."""
    w1, w2 = p["step1_0.conv.weight"], p["step2_0.conv.weight"]
    co, cm = w2.shape[:2]
    return w1.t()[None], w2.permute(2, 3, 1, 0).reshape(9, cm, co)


# (C0, Cm, Co): the micro widths, a ragged chunk and width, the flagship's.
NECK_TF32_SHAPES = [(8, 32, 8), (40, 72, 12), (96, 384, 96)]


@pytest.mark.parametrize("widths", NECK_TF32_SHAPES, ids=["micro", "ragged", "flagship"])
def test_neck_tf32_pack_index_by_index_and_round_trip(widths):
    """The neck's TF32 one-pass packs: W1 as ceil(C0 / 32) chunks of
    MID_WIDTH rows and the 3x3's nine taps as ceil(Cm / 32) chunks of
    OUT_WIDTH rows, each chunk pack_sw128_tf32's element map of the padded
    taps (written out here), round_tf32 of the source bit for bit, zero past
    C0, Cm and Co; unswizzled, the rounded conv weights; the vectors as the
    3xTF32 entry's."""
    c0, cm, co = widths
    p = _neck_params(c0, cm, co)
    packed = fpn_neck.pack_neck(p, tf32_sw128=True)
    mid, out = fpn_neck.MID_WIDTH, fpn_neck.OUT_WIDTH
    k1, k2 = -(-c0 // 32), -(-cm // 32)
    assert packed["w1"].shape == (1, k1, mid // 8, 8, 8, 4) and packed["w2"].shape == (9, k2, out // 8, 8, 8, 4)
    taps1, taps2 = _neck_taps(p)
    for key, taps, k, n in (("w1", taps1, 32 * k1, mid), ("w2", taps2, 32 * k2, out)):
        got = packed[key]
        assert got.dtype == torch.float32 and got.is_contiguous()
        for tap in range(taps.shape[0]):
            padded = np.zeros((k, n), np.float32)
            padded[: taps.shape[1], : taps.shape[2]] = round_tf32(taps[tap]).numpy()
            want = _expected_sw128_tf32(padded)
            assert np.array_equal(got[tap].contiguous().view(torch.int32).numpy(), want.view(np.int32))
    # Round trip to the conv weights.
    w1 = _unswizzle_tf32(packed["w1"])[0]
    assert torch.equal(_bits(w1[:c0, :cm]), _bits(round_tf32(p["step1_0.conv.weight"].t())))
    assert not w1[c0:].any() and not w1[:, cm:].any()
    w2 = _unswizzle_tf32(packed["w2"])
    assert not w2[:, cm:].any() and not w2[:, :, co:].any()
    back = w2[:, :cm, :co].reshape(3, 3, cm, co).permute(3, 2, 0, 1)
    assert torch.equal(_bits(back), _bits(round_tf32(p["step2_0.conv.weight"])))
    f32 = fpn_neck.pack_neck(p)
    for key in ("vec1", "vec2"):
        assert torch.equal(packed[key], f32[key])


@pytest.mark.parametrize("widths", [(104, 64, 8), (8, 512, 8), (8, 64, 128), (232, 512, 8)],
                         ids=["wide_c0", "wide_mid", "wide_out", "wide_mid_and_c0"])
def test_neck_tf32_pack_keeps_the_split_layouts_by_shape(widths):
    """A step on conv_gemm.cuh's loop keeps the 3xTF32 entry's layout in the
    TF32 pack (its kernels read only the hi part): step1 where C0 >
    TF32_MAX_C0 and Cm <= MID_WIDTH, or where Cm is wider and C0 past every
    resident W1 slice (232 > 224); every other step takes the swizzled TF32
    layout, a wide step1 in slices (``plan``), each slice the rounded
    weights of its features."""
    c0, cm, co = widths
    p = _neck_params(c0, cm, co, 12)
    packed, f32 = fpn_neck.pack_neck(p, tf32_sw128=True), fpn_neck.pack_neck(p)
    (route1, n1, s1), (route2, n2, s2) = fpn_neck.plan("tf32", c0, cm, co)
    assert fpn_neck.TF32_MAX_C0 == 96
    assert route2 == fpn_neck.TMA and (route1 == fpn_neck.GEMM) == (c0 > {64: 96, 512: 224}[cm])
    if route1 == fpn_neck.GEMM:
        assert torch.equal(packed["w1"], f32["w1"]) == (fpn_neck.plan("f32", c0, cm, co)[0] == (route1, n1, s1))
    taps1, taps2 = _neck_taps(p)
    if route1 == fpn_neck.TMA:
        w1 = packed["w1"] if s1 > 1 else packed["w1"][None]
        for s in range(s1):
            got = _unswizzle_tf32(w1[s])[0, :c0]
            part = round_tf32(taps1[0, :, s * n1 : (s + 1) * n1])
            assert torch.equal(_bits(got[:, : part.shape[1]]), _bits(part)) and not got[:, part.shape[1]:].any()
    assert torch.equal(_bits(_unswizzle_tf32(packed["w2"])[:, :cm, :co]), _bits(round_tf32(taps2)))


@pytest.mark.parametrize("shape", [(2, 11, 21, 40, 72, 12), (1, 4, 16, 8, 32, 8)], ids=["ragged", "one_tile"])
def test_emulated_neck_tf32_tma_tile_walk_matches_the_tf32_twin(shape):
    """The neck's TF32 entry as its one-pass kernels walk it in f32. step1:
    units of 4 x 16 pixels, per 32-channel chunk one f0 box (TMA's zero fill
    past the edges and past C0) rounded to TF32 times W1's resident chunk,
    then bias, LN, GELU and + u -> t, unrounded. step2: units of 8 x 16
    pixels, per 32-channel chunk of t one 10 x 18 halo box at (-1, -1), each
    of the 9 taps' shifted rows rounded to TF32 times that tap's chunk of
    W2; then bias, LN and GELU. Against ``fused_neck_l0_plain(...,
    tf32=True)``: step1 against the twin's t, and step2, run on the twin's
    t, against the twin's output, each within 1e-5 of the largest value
    (the f32 sums run in another order)."""
    b, h, wd, c0, cm, co = shape
    p = _neck_params(c0, cm, co, 13)
    rng = np.random.default_rng(14)
    f0, u = _randn(rng, b, h, wd, c0), _randn(rng, b, h, wd, cm)
    packed = fpn_neck.pack_neck(p, tf32_sw128=True)
    w1 = _unswizzle_tf32(packed["w1"])[0]  # (chunks * 32, MID_WIDTH)
    w2 = _unswizzle_tf32(packed["w2"])  # (9, chunks * 32, OUT_WIDTH)
    vec1, vec2 = packed["vec1"], packed["vec2"]

    def ln_gelu(z, vec, n):
        return F.gelu(F.layer_norm(z[:, :n] + vec[0, :n], (n,), vec[1, :n], vec[2, :n], eps=fpn_neck.EPS))

    t = torch.zeros(b, h, wd, cm)
    for bb in range(b):
        for y0 in range(0, h, 4):
            for x0 in range(0, wd, 16):
                acc = torch.zeros(64, fpn_neck.MID_WIDTH)
                for ch in range(w1.shape[0] // 32):
                    a = round_tf32(_box(f0, bb, y0, x0, 32 * ch, 4, 16).reshape(64, 32))
                    acc += a @ w1[32 * ch : 32 * ch + 32]
                y = ln_gelu(acc, vec1, cm)
                for r in range(64):
                    i, j = y0 + r // 16, x0 + r % 16
                    if i < h and j < wd:
                        t[bb, i, j] = y[r] + u[bb, i, j]
    with torch.no_grad():
        want = fpn_neck.fused_neck_l0_plain(f0, u, p, tf32=True)
        a = F.gelu(F.layer_norm(
            F.linear(round_tf32(f0), round_tf32(p["step1_0.conv.weight"]), p["step1_0.conv.bias"]),
            (cm,), p["step1_0.ln.weight"], p["step1_0.ln.bias"], eps=fpn_neck.EPS))
        t_twin = a + u
    assert float((t - t_twin).abs().max()) <= 1e-5 * float(t_twin.abs().max())
    out = torch.zeros(b, h, wd, co)
    for bb in range(b):
        for y0 in range(0, h, 8):
            for x0 in range(0, wd, 16):
                acc = torch.zeros(128, fpn_neck.OUT_WIDTH)
                for ch in range(w2.shape[1] // 32):
                    box = _box(t_twin, bb, y0 - 1, x0 - 1, 32 * ch, 10, 18)
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        a = round_tf32(box[dy : dy + 8, dx : dx + 16].reshape(128, 32))
                        acc += a @ w2[tap, 32 * ch : 32 * ch + 32]
                y = ln_gelu(acc, vec2, co)
                for r in range(128):
                    i, j = y0 + r // 16, x0 + r % 16
                    if i < h and j < wd:
                        out[bb, i, j] = y[r]
    assert out.shape == want.shape
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_neck_pack_cache_keys_the_tf32_layout():
    """packed_neck keeps the TF32 one-pass layout and the 3xTF32 entry's
    apart: each is built once for a parameter set and reused, and an f32
    model served at "highest" and then at "default" reads each its own."""
    p = _neck_params(96, 384, 96, 15)
    packs = packing.PACKS
    sw = fpn_neck.packed_neck(p, tf32_sw128=True)
    assert fpn_neck.packed_neck(p, tf32_sw128=True) is sw
    assert packing.PACKS == packs + 1
    km = fpn_neck.packed_neck(p)
    assert km["w1"].shape != sw["w1"].shape and km["w2"].shape != sw["w2"].shape
    assert packing.PACKS == packs + 2
    assert torch.equal(fpn_neck.packed_neck(p, tf32_sw128=True)["w2"], fpn_neck.pack_neck(p, tf32_sw128=True)["w2"])
    assert torch.equal(fpn_neck.packed_neck(p)["w2"], fpn_neck.pack_neck(p)["w2"])
