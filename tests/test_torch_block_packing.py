"""The bf16 ConvNeXt block's weight packing (``adascale_torch/kernels/packing.py``
``pack_core_kmajor`` and ``pack_block_bf16``, the layouts ``csrc/block_bf16.cuh``
reads), on the CPU: every packed element against an index-by-index
reimplementation of the layout, zero past the real widths, and a round trip
back to nn.Linear's (out, in) weights, in the fused form (the 4C hidden kept
on chip: W1 and W2 interleaved by chunks of 64 hidden units, C padded to the
wgmma width) at C = 96, 128 and 192 and at a C that pads, and in the
two-GEMM form (128 x 64 tiles) at C = 384 and a C that pads; the form and
width each C takes; the depthwise taps packed tap-major; the module mode's
GELU lookup outside its table (the closed forms the kernel takes there)
against the port's bf16 GELU for every bf16 value; and the wrapper's reuse
of a parameter set's pack."""
import numpy as np
import pytest
import torch

from adascale_torch.kernels import convnext_block as K
from adascale_torch.kernels import packing
from adascale_torch.ops.bf16 import gelu
from adascale_torch.kernels.packing import (
    BLOCK_HIDDEN_CHUNK, BLOCK_TILE, block_fused_width, pack_block_bf16, pack_core_kmajor,
)


def _weights(c, seed=0):
    """W1 (4C, C) and W2 (C, 4C) from numpy, with distinct values that bf16
    keeps apart."""
    rng = np.random.default_rng(seed)
    w1 = torch.from_numpy(rng.standard_normal((4 * c, c)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((c, 4 * c)).astype(np.float32))
    return w1, w2


def _expected_core_kmajor(w, rows, depth):
    """pack_core_kmajor's layout for the numpy (n, k) ``w``, element by
    element: tile (i, j), row group rg, K group kg, row r, K k holds
    w[rows i + 8 rg + r, depth j + 8 kg + k], zero past w."""
    n, k = w.shape
    nt, kt = -(-n // rows), -(-k // depth)
    out = np.zeros((nt, kt, rows // 8, depth // 8, 8, 8), np.float32)
    for i in range(nt):
        for j in range(kt):
            for rg in range(rows // 8):
                for r in range(8):
                    row = rows * i + 8 * rg + r
                    if row >= n:
                        continue
                    for kg in range(depth // 8):
                        col = depth * j + 8 * kg
                        if col >= k:
                            continue
                        out[i, j, rg, kg, r, : min(8, k - col)] = w[row, col : col + 8]
    return out


@pytest.mark.parametrize("n,k,rows,depth", [(40, 24, 16, 16), (128, 64, 128, 64), (24, 200, 8, 64)])
def test_core_kmajor_matches_the_layout_index_by_index(n, k, rows, depth):
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((n, k)).astype(np.float32))
    got = pack_core_kmajor(w, rows, depth)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    want = _expected_core_kmajor(w.to(torch.bfloat16).float().numpy(), rows, depth)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _unpack_fused(flat, c, cp):
    """pack_block_bf16's fused buffer back to W1 (4C, C) and W2 (C, 4C)."""
    h = BLOCK_HIDDEN_CHUNK
    chunks = -(-4 * c // h)
    t = flat.float().reshape(chunks, 2, h * cp)
    up = t[:, 0].reshape(chunks, h // 8, cp // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(chunks * h, cp)
    down = t[:, 1].reshape(chunks, cp // 8, h // 8, 8, 8).permute(1, 3, 0, 2, 4).reshape(cp, chunks * h)
    return up, down


def _unpack_tiles(flat, n, k):
    """A two-GEMM pack (128 x 64 tiles) back to its (n, k) operand, with the
    zero padding."""
    rows, depth = BLOCK_TILE
    nt, kt = -(-n // rows), -(-k // depth)
    t = flat.float().reshape(nt, kt, rows // 8, depth // 8, 8, 8)
    return t.permute(0, 2, 4, 1, 3, 5).reshape(nt * rows, kt * depth)


@pytest.mark.parametrize("c", [96, 128, 192, 40])
def test_fused_pack_index_by_index_and_round_trip(c):
    w1, w2 = _weights(c)
    cp = block_fused_width(c)
    packed = pack_block_bf16(w1, w2)
    assert packed["w2"].numel() == 0 and packed["w1"].dtype == torch.bfloat16
    flat = packed["w1"].float().numpy()
    h = BLOCK_HIDDEN_CHUNK
    chunks = -(-4 * c // h)
    assert flat.size == chunks * 2 * h * cp
    b1, b2 = w1.to(torch.bfloat16).float().numpy(), w2.to(torch.bfloat16).float().numpy()
    rng = np.random.default_rng(2)
    # Every element of the first and last chunk, and a sample of the rest.
    offsets = np.concatenate([np.arange(2 * h * cp), np.arange((chunks - 1) * 2 * h * cp, flat.size),
                              rng.integers(0, flat.size, 4000)])
    for o in offsets:
        j, part, rest = o // (2 * h * cp), o // (h * cp) % 2, o % (h * cp)
        core, r, k = rest // 64, rest // 8 % 8, rest % 8
        if part == 0:  # W1 rows of chunk j: (8 row groups, cp / 8 K groups)
            rg, kg = core // (cp // 8), core % (cp // 8)
            row, col = h * j + 8 * rg + r, 8 * kg + k
            want = b1[row, col] if row < 4 * c and col < c else 0.0
        else:  # W2 columns of chunk j: (cp / 8 row groups, 8 K groups)
            rg, kg = core // (h // 8), core % (h // 8)
            row, col = 8 * rg + r, h * j + 8 * kg + k
            want = b2[row, col] if row < c and col < 4 * c else 0.0
        assert flat[o] == want, (o, j, part)
    up, down = _unpack_fused(packed["w1"], c, cp)
    torch.testing.assert_close(up[: 4 * c, :c], w1.to(torch.bfloat16).float(), rtol=0, atol=0)
    torch.testing.assert_close(down[:c, : 4 * c], w2.to(torch.bfloat16).float(), rtol=0, atol=0)
    assert not up[4 * c :].any() and not up[:, c:].any() and not down[c:].any() and not down[:, 4 * c :].any()


@pytest.mark.parametrize("c", [384, 264])
def test_two_gemm_pack_index_by_index_and_round_trip(c):
    w1, w2 = _weights(c)
    packed = pack_block_bf16(w1, w2)
    for key, w in (("w1", w1), ("w2", w2)):
        n, k = w.shape
        want = _expected_core_kmajor(w.to(torch.bfloat16).float().numpy(), *BLOCK_TILE)
        np.testing.assert_array_equal(packed[key].float().numpy(), want.reshape(-1))
        back = _unpack_tiles(packed[key], n, k)
        torch.testing.assert_close(back[:n, :k], w.to(torch.bfloat16).float(), rtol=0, atol=0)
        assert not back[n:].any() and not back[:, k:].any()


def test_form_and_width_by_channels():
    """The fused form up to C = 192 at the next wgmma width, the two-GEMM
    form above: tiny's 96 / 192, base's 128 and large's 192 fused, base's
    256 and every stage from 384 on in two GEMMs."""
    assert [block_fused_width(c) for c in (8, 96, 104, 128, 136, 192)] == [96, 96, 128, 128, 192, 192]
    assert all(block_fused_width(c) == 0 for c in (200, 256, 384, 512, 768, 1024, 1536))


def test_depthwise_taps_are_packed_tap_major():
    p = _block_params(96)
    packed = K.bf16_weights(p, 96, torch.device("cpu"))["dw_w"]
    assert packed.shape == (49, 96) and packed.is_contiguous()
    for t in (0, 17, 48):
        torch.testing.assert_close(packed[t], p["dwconv.weight"][:, 0, t // 7, t % 7], rtol=0, atol=0)


# The module mode's GELU table in csrc/block_bf16.cuh: |z| in [2^-12, 2^4),
# by biased exponent from GELU_EXP0.
GELU_EXP0, GELU_BINADES = 127 - 12, 16


def test_module_gelu_closed_forms_outside_the_table_match_the_bf16_gelu():
    """Outside the table the kernel takes z / 2 (below it: erfc rounds to
    1), z (z >= 16: erfc rounds to 2) or -0 (z <= -16: erfc is 0; -inf gives
    NaN); held here against the port's bf16 GELU (XLA's roundings) for all
    65536 bf16 values. The card checks the table and these forms against
    the kernel's own GELU before the first module-mode launch."""
    bits = torch.arange(65536, dtype=torch.int32)
    z = bits.to(torch.int16).view(torch.bfloat16).float()
    want = gelu(z, torch.bfloat16).float()
    e, neg = (bits >> 7) & 0xFF, bits >> 15
    outside = (e < GELU_EXP0) | (e >= GELU_EXP0 + GELU_BINADES)
    far = torch.where(neg == 1, torch.where(e == 0xFF, float("nan"), -0.0), z)
    got = torch.where(e < GELU_EXP0, (0.5 * z).to(torch.bfloat16).float(), far)
    same = (got.view(torch.int32) == want.view(torch.int32)) | (got.isnan() & want.isnan())
    assert outside.sum() == 65536 - 2 * GELU_BINADES * 128
    assert bool(same[outside].all()), bits[outside & ~same][:8].tolist()


def _block_params(c, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return {
        "dwconv.weight": r(c, 1, 7, 7), "dwconv.bias": r(c), "ln.weight": r(c), "ln.bias": r(c),
        "mlp_up.weight": r(4 * c, c), "mlp_up.bias": r(4 * c), "mlp_down.weight": r(c, 4 * c),
        "mlp_down.bias": r(c), "block_scale": r(c),
    }


def test_launch_arguments_are_reused_per_parameter_set_and_rebuilt_on_change():
    """The bf16 launch checks and packs a parameter set once: the same
    tensors at the same versions give the same arguments without a new
    pack; an in-place update, or another tensor, rebuilds them; a tensor of
    the wrong shape is refused."""
    p = _block_params(96)
    dev = torch.device("cpu")
    packs = packing.PACKS
    args = K.bf16_weights(p, 96, dev)
    assert list(args) == list(K.BF16_ARGS) and packing.PACKS == packs + 1
    assert K.bf16_weights(p, 96, dev) is args and packing.PACKS == packs + 1
    with torch.no_grad():
        p["mlp_up.weight"].mul_(2.0)
    changed = K.bf16_weights(p, 96, dev)
    assert packing.PACKS == packs + 2
    assert changed["w1"].data_ptr() != args["w1"].data_ptr()
    torch.testing.assert_close(changed["w1"], pack_block_bf16(p["mlp_up.weight"], p["mlp_down.weight"])["w1"])
    p["ln.weight"] = p["ln.weight"].clone()
    moved = K.bf16_weights(p, 96, dev)
    assert moved["ln_g"].data_ptr() == p["ln.weight"].data_ptr()
    with pytest.raises(ValueError, match="ln.bias"):
        K.bf16_weights(dict(p, **{"ln.bias": torch.zeros(95)}), 96, dev)
