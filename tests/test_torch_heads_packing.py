"""The heads kernels' weight packing (``adascale_torch/kernels/fpn_heads.py``
``pack_heads``, ``packed_heads``) and its arithmetic, on the CPU: the packed
TF32 hi + lo taps unpack to the collapsed taps (which
``test_torch_fpn_heads.py::test_phase_tap_weights_match_jax`` pins to JAX's
``_phase_tap_weights``); a numpy emulation of the kernel's 3xTF32 products,
read from the packed operands in the kernel's order with its split of A,
matches the plain version within 1e-5 relative (the kernel's bar on the
card); the packing cache repacks after an in-place update or a ``.data``
swap and not otherwise, and lets a pack go with its model, for the heads
and for the neck level 0 (``fpn_neck.packed_neck``), which share the cache.
Micro shape: 13x19 pixels, C = 32, head widths 16..18."""
import gc
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from adascale_torch.kernels import fpn_heads as K
from adascale_torch.kernels import fpn_neck
from adascale_torch.kernels import packing
from adascale_torch.kernels.packing import KC, KSLOT, tf32_round
from adascale_torch.models.fpn import FpnHead, FpnNeck
from adascale_torch.ops.fused_upsample import heads_phase_form, phase_tap_weights

C = 32
OUTS = (1, 2, 4, 4)  # head widths (C + M) // 2 = 16, 17, 18, 18
WIDTH = 200  # the precise heads kernel's N (csrc/precise_heads.cu)
REL_TOL = 1e-5


def _heads(seed=0):
    """Four FpnHeads with every parameter moved off its init."""
    torch.manual_seed(seed)
    heads = []
    for m in OUTS:
        p = K.head_params(FpnHead(C, m))
        with torch.no_grad():
            for t in p.values():
                t.add_(0.1 * torch.randn_like(t))
        heads.append(p)
    return heads


def _unpack(w):
    """(heads, 4, 4, chunks, 2, n/8, 8, 8, 4) -> hi, lo each (heads, 4
    phases, 4 taps, chunks * 32 channels, n), undoing the K slot order."""
    nh, _, _, chunks, _, nb = w.shape[:6]
    t = w.permute(4, 0, 1, 2, 3, 6, 8, 5, 7)  # (2, heads, 4, 4, chunk, kb, e, nb, r)
    t = t.reshape(2, nh, 4, 4, chunks, 4, 8, nb * 8)  # (.., k8 step, slot, n)
    slots = torch.empty_like(t)
    slots[..., list(KSLOT), :] = t
    return slots.reshape(2, nh, 4, 4, chunks * KC, nb * 8).unbind(0)


def test_packed_taps_unpack_to_phase_taps_and_hi_is_tf32():
    heads = _heads()
    w = K.pack_heads(heads, WIDTH)["w"]
    hi, lo = _unpack(w)
    for k, p in enumerate(heads):
        f = p["step1.conv.weight"].shape[0]
        want = phase_tap_weights(p["step1.conv.weight"])
        got = (hi[k, :, :, :C, :f].double() + lo[k, :, :, :C, :f].double())
        # hi + lo keeps 22 of the 24 mantissa bits: 2^-21 relative at most.
        torch.testing.assert_close(got, want.double(), rtol=2.0 ** -21, atol=0)
        assert torch.equal(hi[k, :, :, :C, :f], tf32_round(want))
        assert not hi[k, :, :, :, f:].any() and not lo[k, :, :, :, f:].any()
    for part in (hi, lo):
        assert not (part.contiguous().view(torch.int32) & 0x1FFF).any()


def _split_a(a):
    """The kernel's split of A (fpn_head.cuh ``split_tf32``): hi rounded to
    TF32; lo = a - hi passed with 0x1000 added and read by the tensor core
    as its top 19 bits."""
    hi = tf32_round(a)
    lo_bits = (a - hi).view(torch.int32) + 0x1000
    return hi, (lo_bits & -0x2000).view(torch.float32)


def _emulate(x, heads, n):
    """Each head's (B, 2H, 2W, M) output from the packed operands, as the
    kernel computes it: per phase and 32-channel chunk of each tap, the
    shifted A rows in K slot order, split; per 8-deep step a_lo.b_hi,
    a_hi.b_lo, a_hi.b_hi summed into a fresh tile (f32), added to the
    running sum; then bias, LN, GELU and the projection."""
    packed = K.pack_heads(heads, n)
    w = packed["w"].numpy()
    b, h, wd, c = x.shape
    chunks = w.shape[3]
    xp = np.zeros((b, h + 2, wd + 2, chunks * KC), np.float32)
    xp[:, 1:-1, 1:-1, :c] = x
    outs = []
    for k, p in enumerate(heads):
        m, f = p["step2.weight"].shape
        out = np.zeros((b, 2 * h, 2 * wd, m), np.float32)
        for phase in range(4):
            pa, pb = divmod(phase, 2)
            acc = np.zeros((b * h * wd, n), np.float32)
            for tap in range(4):
                dy, dx = divmod(tap, 2)
                rows = xp[:, pa + dy : pa + dy + h, pb + dx : pb + dx + wd].reshape(b * h * wd, -1)
                for chunk in range(chunks):
                    a = rows[:, chunk * KC : (chunk + 1) * KC].reshape(-1, 4, 8)[:, :, list(KSLOT)]
                    ah, al = (t.numpy().reshape(-1, KC) for t in _split_a(torch.from_numpy(a.copy())))
                    # (2, nb, kb, r, e) -> (2, n, 32): row 8 nb + r, K slot 4 kb + e.
                    bh, bl = w[k, phase, tap, chunk].transpose(0, 1, 3, 2, 4).reshape(2, n, KC)
                    part = np.zeros_like(acc)
                    for s in range(0, KC, 8):
                        for lhs, rhs in ((al, bh), (ah, bl), (ah, bh)):
                            part += lhs[:, s : s + 8] @ rhs[:, s : s + 8].T
                    acc += part
            z = torch.from_numpy(acc[:, :f]) + p["step1.conv.bias"]
            z = torch.nn.functional.layer_norm(z, (f,), p["step1.ln.weight"], p["step1.ln.bias"], eps=1e-6)
            y = torch.nn.functional.linear(torch.nn.functional.gelu(z), p["step2.weight"], p["step2.bias"])
            out[:, pa::2, pb::2] = y.numpy().reshape(b, h, wd, m)
        outs.append(out)
    return outs


@pytest.mark.parametrize("n", [WIDTH, 24])
def test_emulated_3xtf32_matches_plain(n):
    heads = _heads(1)
    x = np.random.default_rng(2).standard_normal((1, 13, 19, C)).astype(np.float32)
    with torch.no_grad():
        want = heads_phase_form(torch.from_numpy(x), heads)
        got = _emulate(x, heads, n)
    for g, wt in zip(got, want):
        assert g.shape == tuple(wt.shape)
        rel = float(np.abs(g - wt.numpy()).max()) / float(wt.abs().max())
        assert rel <= REL_TOL, rel


def _neck(seed=0):
    """A micro FpnNeck's level-0 parameters, every one moved off its init."""
    torch.manual_seed(seed)
    p = fpn_neck.level0_params(FpnNeck((8, 16, 32, 64), 32))
    with torch.no_grad():
        for t in p.values():
            t.add_(0.1 * torch.randn_like(t))
    return p


# Each pack cache case: a parameter set, another container of the same
# tensors, the cached and the fresh pack, two tensors updated in place with
# the packed entry each changes, and a tensor swapped by ``.data`` with its
# entry.
def _heads_case(seed):
    heads = _heads(seed)
    return SimpleNamespace(
        params=heads,
        same=[dict(p) for p in heads],
        cached=lambda ps: K.packed_heads(ps, WIDTH),
        fresh=lambda ps: K.pack_heads(ps, WIDTH),
        updated=[(heads[2]["step1.ln.weight"], "vec"), (heads[3]["step1.conv.weight"], "w")],
        swapped=(heads[1]["step2.weight"], "w2"),
    )


def _neck_case(seed):
    p = _neck(seed)
    return SimpleNamespace(
        params=p,
        same=dict(p),
        cached=fpn_neck.packed_neck,
        fresh=fpn_neck.pack_neck,
        updated=[(p["step1_0.ln.weight"], "vec1"), (p["step2_0.conv.weight"], "w2")],
        swapped=(p["step1_0.conv.weight"], "w1"),
    )


PACK_CASES = {"heads": _heads_case, "neck": _neck_case}


@pytest.mark.parametrize("which", list(PACK_CASES))
def test_pack_cache_repacks_only_after_an_update(which):
    case = PACK_CASES[which](3)
    first = case.cached(case.params)
    assert case.cached(case.params) is first
    assert case.cached(case.same) is first  # same tensors
    (t1, k1), (t2, k2) = case.updated
    with torch.no_grad():
        t1.mul_(2.0)
        t2.add_(1.0)
    second = case.cached(case.params)
    assert second is not first
    for name, t in case.fresh(case.params).items():
        assert torch.equal(second[name], t), name
    assert not torch.equal(second[k1], first[k1]) and not torch.equal(second[k2], first[k2])
    assert case.cached(case.params) is second
    # A swap by ``.data`` keeps the tensor's identity, version and shape.
    t, k = case.swapped
    with torch.no_grad():
        t.data = t * 3.0
    third = case.cached(case.params)
    assert third is not second
    assert torch.equal(third[k], case.fresh(case.params)[k])
    assert not torch.equal(third[k], second[k])
    assert case.cached(case.params) is third


@pytest.mark.parametrize("which", list(PACK_CASES))
def test_pack_cache_lets_the_pack_go_with_the_model(which):
    case = PACK_CASES[which](4)
    refs = [weakref.ref(t) for t in case.cached(case.params).values()]
    assert all(r() is not None for r in refs)
    del case
    gc.collect()
    assert all(r() is None for r in refs)


# The bf16 one-pass kernel (csrc/conv_tma.cuh, fpn_head.cuh heads_tma_kernel):
# B in 64-channel chunks of 128-byte swizzled rows; A as one TMA halo box
# of 17 columns by 9 rows of one image a chunk at the phase's window origin,
# zero past the map's edges, each of the 4 taps reading its shifted 16 x 8
# rows of it; units walked (head, phase) fastest, then tiles.
BF16_C = 72  # two 64-channel chunks, the second one partly past C


def _unswizzle(w):
    """(..., chunks, n/8, 8 rows, 8 pieces, 8) in the 128-byte swizzle ->
    (..., chunks * 64, n) f32: piece j of row r holds K group j ^ r."""
    *lead, chunks, nb = w.shape[:-3]
    rows = torch.arange(8)
    t = w[..., rows[:, None], rows[:, None] ^ rows[None, :], :]  # (.., row, K group, K)
    nl = len(lead)
    t = t.permute(*range(nl), nl, nl + 3, nl + 4, nl + 1, nl + 2)
    return t.reshape(*lead, chunks * 64, nb * 8).float()


def _box(x, b, y0, x0, c0, rows, cols):
    """The TMA box of 64 channels by ``cols`` columns by ``rows`` rows of
    image b of x (B, H, W, C) at (c0, x0, y0), zero past the map's edges."""
    _, h, w, c = x.shape
    out = torch.zeros(rows, cols, 64)
    ys, xs = slice(max(y0, 0), min(y0 + rows, h)), slice(max(x0, 0), min(x0 + cols, w))
    if b < x.shape[0] and ys.start < ys.stop and xs.start < xs.stop and c0 < c:
        part = x[b, ys, xs, c0 : min(c0 + 64, c)]
        out[ys.start - y0 : ys.stop - y0, xs.start - x0 : xs.stop - x0, : part.shape[-1]] = part
    return out


def _emulate_tma(x, heads, n, round_y):
    """Each head's (B, 2H, 2W, M) output from the bf16 one-pass packing, as
    the kernel walks it: unit u is (head, phase) u % sets of tile u // sets
    (8 x 16 pixels, image by image, row by row); per 64-channel chunk one
    halo box, each tap's rows of it times that tap's unswizzled B, f32
    sums; then bias, LN, GELU (rounded to bf16 where round_y), the
    projection, the interleaved write."""
    packed = K.pack_heads(heads, n, dtype=torch.bfloat16, round_w2=round_y)
    bt = _unswizzle(packed["w"])
    b, h, wd, c = x.shape
    sets, chunks = 4 * len(heads), packed["w"].shape[3]
    tiles_h, tiles_w = -(-h // 8), -(-wd // 16)
    outs = [p["step2.weight"].shape[0] for p in heads]
    out = torch.zeros(b, 2 * h, 2 * wd, sum(outs))
    xf = x.float()
    for un in range(b * tiles_h * tiles_w * sets):
        s, tile = un % sets, un // sets
        bb, rem = divmod(tile, tiles_h * tiles_w)
        h0, w0 = 8 * (rem // tiles_w), 16 * (rem % tiles_w)
        head, phase = divmod(s, 4)
        pa, pb = divmod(phase, 2)
        acc = torch.zeros(128, n)
        for ch in range(chunks):
            box = _box(xf, bb, h0 + pa - 1, w0 + pb - 1, 64 * ch, 9, 17)
            for tap in range(4):
                dy, dx = divmod(tap, 2)
                acc += box[dy : dy + 8, dx : dx + 16].reshape(128, 64) @ bt[head, phase, tap, 64 * ch : 64 * ch + 64]
        m, f = heads[head]["step2.weight"].shape
        vec, w2 = packed["vec"][head], packed["w2"][head]
        z = acc[:, :f] + vec[0, :f]
        z = torch.nn.functional.layer_norm(z, (f,), vec[1, :f], vec[2, :f], eps=1e-6)
        y = torch.nn.functional.gelu(z)
        if round_y:
            y = y.to(torch.bfloat16).float()
        proj = y @ w2[:m, :f].T + packed["b2"][head, :m]
        moff = sum(outs[:head])
        for r in range(128):
            i, j = h0 + r // 16, w0 + r % 16
            if i < h and j < wd:
                out[bb, 2 * i + pa, 2 * j + pb, moff : moff + m] = proj[r]
    return list(out.split(outs, dim=-1))


def test_sw128_pack_unpacks_to_phase_taps():
    """The bf16 one-pass pack: per (head, phase, tap) ceil(C / 64) chunks of
    n rows in the 128-byte swizzle, unswizzling to the bf16 collapsed taps,
    zero past C and past each head's F."""
    heads = _heads(5)
    c = heads[0]["step1.conv.weight"].shape[1]
    w = K.pack_heads(heads, WIDTH, dtype=torch.bfloat16)["w"]
    assert w.dtype == torch.bfloat16 and w.shape == (4, 4, 4, 1, WIDTH // 8, 8, 8, 8)
    got = _unswizzle(w)
    for k, p in enumerate(heads):
        f = p["step1.conv.weight"].shape[0]
        want = phase_tap_weights(p["step1.conv.weight"]).to(torch.bfloat16).float()
        assert torch.equal(got[k, :, :, :c, :f], want)
        assert not got[k, :, :, c:].any() and not got[k, :, :, :, f:].any()
    # Element (k, n) of a chunk: row group n // 8, row n % 8, piece (k // 8) ^ (n % 8).
    taps = torch.arange(128 * 16, dtype=torch.float32).reshape(128, 16)
    packed = packing.pack_sw128(taps)
    for k, n in [(0, 0), (9, 3), (63, 15), (64, 8), (127, 7), (77, 13)]:
        assert packed[k // 64, n // 8, n % 8, ((k % 64) // 8) ^ (n % 8), k % 8] == taps[k, n].to(torch.bfloat16)


@pytest.mark.parametrize(
    "which,shape", [("precise", (2, 11, 21)), ("precise", (1, 8, 16)), ("rough", (2, 11, 21)), ("rough", (1, 9, 33))]
)
def test_emulated_tma_tile_walk_matches_plain(which, shape):
    """The kernel's walk over 2-D tiles (ragged maps: tiles past the right and
    bottom edges; one exact tile; C = 72: a partial second chunk), its halo
    boxes with TMA's zero fill and each tap's shifted rows, and its swizzled
    B reproduce the plain bf16 phase form (``heads_phase_form(...,
    kernel=True)``) within 1e-5 of the largest value (the f32 sums run in
    another order), 2e-3 in the precise heads (where that can flip a bf16
    rounding of the GELU output)."""
    rng = np.random.default_rng(9)
    outs = OUTS if which == "precise" else (1, 1)
    n = WIDTH if which == "precise" else 192
    heads = []
    for m in outs:
        f = (BF16_C + m) // 2
        heads.append({
            "step1.conv.weight": torch.from_numpy(rng.standard_normal((f, BF16_C, 3, 3)).astype(np.float32) / 25),
            "step1.conv.bias": torch.from_numpy(rng.standard_normal(f).astype(np.float32) * 0.1),
            "step1.ln.weight": torch.from_numpy(1 + rng.standard_normal(f).astype(np.float32) * 0.1),
            "step1.ln.bias": torch.from_numpy(rng.standard_normal(f).astype(np.float32) * 0.1),
            "step2.weight": torch.from_numpy(rng.standard_normal((m, f)).astype(np.float32) / f ** 0.5),
            "step2.bias": torch.from_numpy(rng.standard_normal(m).astype(np.float32) * 0.1),
        })
    x = torch.from_numpy(rng.standard_normal((*shape, BF16_C)).astype(np.float32)).to(torch.bfloat16)
    round_y = which == "precise"
    with torch.no_grad():
        got = _emulate_tma(x, heads, n, round_y)
        want = heads_phase_form(x, heads, kernel=True, round_y=round_y)
    for g, wt in zip(got, want):
        assert g.shape == tuple(wt.shape)
        rel = float((g - wt).abs().max()) / float(wt.abs().max())
        assert rel <= (2e-3 if round_y else 1e-5), rel


# The wide heads (csrc/fpn_head.cuh heads_cluster_tma_kernel and
# heads_cluster_kernel): heads wider than one tile in `slices` slices of NS
# features, packed slice by slice (slice-major) in the one-tile layout of
# the entry; the CTAs of one thread-block cluster a (head, phase, pixel
# tile), CTA r computing slice r, their LayerNorm statistics and partial
# dots combined in rank order. Widths: F = (Cm + M) // 2 of the
# base (Cm 512) and large (Cm 768) backbones; slice widths the libraries'
# (fpn_heads.cu 128 / 192, precise_heads.cu 136 / 200).
WIDE_CM = {"base": 512, "large": 768}
WIDE_SLICE = {("rough", "base"): 128, ("rough", "large"): 192,
              ("precise", "base"): 136, ("precise", "large"): 200}
WIDE_C = 72  # input channels: a partial last chunk in bf16 (64) and TF32 (32)


def _wide_heads(which, size, seed):
    """The rough (1, 1) or precise (1, 2, 4, 4) heads at a backbone's
    widths over WIDE_C input channels, every parameter off its init."""
    rng = np.random.default_rng(seed)
    heads = []
    for m in ((1, 1) if which == "rough" else OUTS):
        f = (WIDE_CM[size] + m) // 2
        heads.append({
            "step1.conv.weight": torch.from_numpy(rng.standard_normal((f, WIDE_C, 3, 3)).astype(np.float32) / 25),
            "step1.conv.bias": torch.from_numpy(rng.standard_normal(f).astype(np.float32) * 0.1),
            "step1.ln.weight": torch.from_numpy(1 + rng.standard_normal(f).astype(np.float32) * 0.1),
            "step1.ln.bias": torch.from_numpy(rng.standard_normal(f).astype(np.float32) * 0.1),
            "step2.weight": torch.from_numpy(rng.standard_normal((m, f)).astype(np.float32) / f ** 0.5),
            "step2.bias": torch.from_numpy(rng.standard_normal(m).astype(np.float32) * 0.1),
        })
    return heads


def _unswizzle_any(w):
    """(..., chunks, n/8, 8 rows, 8 pieces, e) in the 128-byte swizzle (e = 8
    bf16 or 4 f32 a 16-byte piece) -> (..., chunks * 8 e, n) f32: piece j of
    row r holds K group j ^ r."""
    *lead, chunks, nb, _, _, e = w.shape
    rows = torch.arange(8)
    t = w[..., rows[:, None], rows[:, None] ^ rows[None, :], :]  # (.., row, K group, K)
    nl = len(lead)
    t = t.permute(*range(nl), nl, nl + 3, nl + 4, nl + 1, nl + 2)
    return t.reshape(*lead, chunks * 8 * e, nb * 8).float()


def _box_of(x, b, y0, x0, c0, kc):
    """The TMA halo box (9 rows by 17 columns by kc channels) of image b of x
    at (c0, x0, y0), zero past the map's edges and past C."""
    _, h, w, c = x.shape
    out = torch.zeros(9, 17, kc)
    ys, xs = slice(max(y0, 0), min(y0 + 9, h)), slice(max(x0, 0), min(x0 + 17, w))
    if ys.start < ys.stop and xs.start < xs.stop and c0 < c:
        part = x[b, ys, xs, c0 : min(c0 + kc, c)]
        out[ys.start - y0 : ys.stop - y0, xs.start - x0 : xs.stop - x0, : part.shape[-1]] = part
    return out


def _emulate_cluster(x, heads, ns, tf32, round_y):
    """Each head's (B, 2H, 2W, M) output from the wide heads' packing, as the
    cluster kernel walks it: every CTA of a cluster the same units (head,
    phase) u % sets of tile u // sets; CTA r per chunk (64 bf16 or 32 TF32
    channels) one halo box, each tap's rows (rounded to TF32 in TF32) times
    its slice's unswizzled B, f32 sums; then z = acc + bias of its slice;
    each slice's row sum and squared deviations from its own mean over its
    features below F (r ns + n < F), combined in rank order into the mean
    and variance over F; each slice's GELU (rounded to bf16 where round_y)
    and partial projection, added in rank order, plus b2."""
    fmax = max(p["step1.conv.weight"].shape[0] for p in heads)
    slices = -(-fmax // ns)
    dtype = torch.float32 if tf32 else torch.bfloat16
    packed = K.pack_heads(heads, ns, slices, dtype, round_w2=round_y, tf32_sw128=tf32)
    assert packed["w"].shape[:2] == (slices, len(heads))
    kc = 32 if tf32 else 64
    bt = _unswizzle_any(packed["w"])  # (slices, heads, 4, 4, K, ns)
    b, h, wd, _ = x.shape
    sets, chunks = 4 * len(heads), packed["w"].shape[4]
    tiles_h, tiles_w = -(-h // 8), -(-wd // 16)
    outs = [p["step2.weight"].shape[0] for p in heads]
    out = torch.zeros(b, 2 * h, 2 * wd, sum(outs))
    xf = x.float()
    for un in range(b * tiles_h * tiles_w * sets):
        s, tile = un % sets, un // sets
        bb, rem = divmod(tile, tiles_h * tiles_w)
        h0, w0 = 8 * (rem // tiles_w), 16 * (rem % tiles_w)
        head, phase = divmod(s, 4)
        pa, pb = divmod(phase, 2)
        m, f = heads[head]["step2.weight"].shape
        vec, w2 = packed["vec"][head], packed["w2"][head]
        zs = []
        for r in range(slices):
            acc = torch.zeros(128, ns)
            for ch in range(chunks):
                box = _box_of(xf, bb, h0 + pa - 1, w0 + pb - 1, kc * ch, kc)
                for tap in range(4):
                    dy, dx = divmod(tap, 2)
                    a = box[dy : dy + 8, dx : dx + 16].reshape(128, kc)
                    acc += (tf32_round(a) if tf32 else a) @ bt[r, head, phase, tap, kc * ch : kc * ch + kc]
            zs.append(acc + vec[0, r * ns : (r + 1) * ns])
        # Each slice's (sum, squared deviations from its own mean over its n
        # real features), combined in rank order (Chan et al.'s update).
        stats = []
        for r, z in enumerate(zs):
            n = min(max(f - r * ns, 0), ns)
            real = (torch.arange(r * ns, (r + 1) * ns) < f).float()
            s_r = z.sum(1)
            m_r = s_r / n if n else torch.zeros(128)
            stats.append((s_r, (((z - m_r[:, None]) * real) ** 2).sum(1), n, m_r))
        total = torch.zeros(128)
        for s_r, _, _, _ in stats:
            total = total + s_r
        mean = total / f
        m2 = torch.zeros(128)
        for _, q_r, n, m_r in stats:
            m2 = m2 + q_r + n * (m_r - mean) ** 2
        rstd = torch.rsqrt(m2 / f + 1e-6)
        dot = torch.zeros(128, m)
        for r, z in enumerate(zs):
            cols = slice(r * ns, (r + 1) * ns)
            y = torch.nn.functional.gelu((z - mean[:, None]) * rstd[:, None] * vec[1, cols] + vec[2, cols])
            if round_y:
                y = y.to(torch.bfloat16).float()
            dot = dot + y @ w2[:m, cols].T
        proj = dot + packed["b2"][head, :m]
        moff = sum(outs[:head])
        for row in range(128):
            i, j = h0 + row // 16, w0 + row % 16
            if i < h and j < wd:
                out[bb, 2 * i + pa, 2 * j + pb, moff : moff + m] = proj[row]
    return list(out.split(outs, dim=-1))


@pytest.mark.parametrize("precision", ["bf16", "tf32"])
@pytest.mark.parametrize("size", list(WIDE_CM))
@pytest.mark.parametrize("which", ["rough", "precise"])
def test_emulated_cluster_walk_matches_plain(which, size, precision):
    """The wide heads' cluster walk (``_emulate_cluster``) at the base and
    large widths, on a ragged map (tiles past the right and bottom edges,
    a partial last chunk of C), reproduces the plain phase form of its
    precision (bf16: ``heads_phase_form(..., kernel=True)``; TF32:
    ``heads_phase_form(..., tf32=True)``) within 1e-5 of the largest value
    (the f32 sums run in another order), 2e-3 in the bf16 precise heads
    (where that can flip a bf16 rounding of the GELU output), as the
    one-tile walk is held."""
    heads = _wide_heads(which, size, 11)
    ns = WIDE_SLICE[(which, size)]
    assert max(p["step1.conv.weight"].shape[0] for p in heads) > ns  # two slices
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((1, 11, 21, WIDE_C)).astype(np.float32))
    tf32 = precision == "tf32"
    round_y = which == "precise" and not tf32
    if not tf32:
        x = x.to(torch.bfloat16)
    with torch.no_grad():
        got = _emulate_cluster(x, heads, ns, tf32, round_y)
        want = heads_phase_form(x, heads, kernel=not tf32, round_y=round_y, tf32=tf32)
    for g, wt in zip(got, want):
        assert g.shape == tuple(wt.shape)
        rel = float((g - wt).abs().max()) / float(wt.abs().max())
        assert rel <= (2e-3 if round_y else 1e-5), rel


@pytest.mark.parametrize("precision", ["f32", "tf32", "bf16"])
@pytest.mark.parametrize("which", ["rough", "precise"])
def test_wide_slice_packs_unpack_to_phase_taps(which, precision):
    """The base widths' packs at the narrower slice widths (128 rough, 136
    precise), slice-major: slice r unpacks to the collapsed taps of features
    r ns .. r ns + ns - 1 (f32: TF32 hi + lo; TF32: rounded; bf16: in bf16),
    zero past C and past each head's F; vec and w2 hold slices ns features."""
    heads = _wide_heads(which, "base", 13)
    ns = WIDE_SLICE[(which, "base")]
    slices = 2
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    packed = K.pack_heads(heads, ns, slices, dtype, tf32_sw128=precision == "tf32")
    w = packed["w"]
    if precision == "f32":
        hi, lo = (torch.stack(t) for t in zip(*(_unpack(w[r]) for r in range(slices))))
        got = hi.double() + lo.double()
    else:
        got = _unswizzle_any(w)
    assert got.shape[:4] == (slices, len(heads), 4, 4) and got.shape[-1] == ns
    for k, p in enumerate(heads):
        f = p["step1.conv.weight"].shape[0]
        taps = phase_tap_weights(p["step1.conv.weight"])
        for r in range(slices):
            lo_f, hi_f = r * ns, min(f, (r + 1) * ns)
            part = got[r, k, :, :, :WIDE_C, : hi_f - lo_f]
            want = taps[..., lo_f:hi_f]
            if precision == "f32":
                torch.testing.assert_close(part, want.double(), rtol=2.0 ** -21, atol=0)
            elif precision == "tf32":
                assert torch.equal(part, tf32_round(want))
            else:
                assert torch.equal(part, want.to(torch.bfloat16).float())
            assert not got[r, k, :, :, WIDE_C:].any() and not got[r, k, ..., hi_f - lo_f :].any()
    assert packed["vec"].shape == (len(heads), 3, slices * ns) and packed["w2"].shape == (len(heads), K.MAX_OUT, slices * ns)
