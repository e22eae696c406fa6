"""Serving-forward ceiling analysis: per-component time against a roofline,
on the H100.

Counterpart of ``adascale/tools/serve_profile.py``, with its rows: the full
rough forward, the backbone alone, the neck alone, both heads, and per
backbone stage a chain of its depthwise 7x7 convolutions and a chain of its
LN + MLP 4x, each timed warm (CUDA events around ``iters`` calls after one
warm-up; the host clock on the CPU). Each row has an analytic FLOP count
(``train_profile.forward_flops``; ``FlopCounterMode`` agrees,
``tests/test_torch_profile_tools.py``) and byte count (each input, weight
and output moved once: the least any schedule moves) and its bound

    t_bound = max(flops / peak, bytes / HBM_BW)

at the H100's peak for the dtype (``H100_PEAK_BF16``; f32 at
``H100_PEAK_F32_3XTF32``, the 3xTF32 products this port computes f32
with, the card's fastest f32 rate). A row that takes less than its bound
is an error, not a line: the count or the timing is wrong.

``--pallas`` builds the model as the engine's ``use_pallas_backbone`` does:
in bf16 the blocks run the kernel's Pallas mode (a bf16 residual), else
its module mode; in f32 the two are one function. The blocks run the
hand-written kernel either way (the CPU: its plain version).

Usage:
  python -m adascale_torch.tools.serve_profile [--batch 16] [--hw 1280]
      [--dtype bf16] [--iters 8] [--pallas] [--device cuda|cpu]
      [--block-spec 96x3,192x3,384x9,768x3]
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import train_profile as tp

Row = Tuple[str, Callable[[], object], int, int]


def _param_bytes(*modules) -> int:
    return sum(p.numel() * p.element_size() for m in modules for p in m.parameters())


def rows(model, specs, b: int, hw: int, dtype: str, device: torch.device) -> List[Row]:
    """[(label, call, flops, bytes)] in the JAX tool's order."""
    from ..models.convnext import EPS, conv2d_nhwc

    dt = tp.DTYPES[dtype]
    bpe = 2 if dtype == "bf16" else 4
    gen = torch.Generator(device=device).manual_seed(0)
    image = torch.rand(b, hw, hw, 3, generator=gen, device=device) * 255
    shapes = tp.stage_shapes(specs, b, hw, hw)
    parts = tp.forward_flops(specs, b, hw, hw, "rough", dt)
    feats = [torch.randn(s, generator=gen, device=device).to(dt) for s in shapes]
    cn = specs[-2][0]
    b0, h0, w0, _ = shapes[0]
    neck_carry = torch.randn(b0, h0, w0, cn, generator=gen, device=device).to(dt)
    feat_bytes = sum(bb * hh * ww * c for bb, hh, ww, c in shapes) * bpe
    map_bytes = 2 * b0 * (2 * h0) * (2 * w0) * bpe
    heads = (model.rough_char_mask_head, model.rough_char_height_head)
    backbone_flops = sum(tp.backbone_parts(parts).values())
    out: List[Row] = [
        ("full_rough_forward", lambda: model.forward_rough(image), sum(parts.values()),
         image.numel() * 4 + _param_bytes(model.backbone, model.rough_neck, *heads) + map_bytes),
        ("backbone_only", lambda: model.backbone(image), backbone_flops,
         image.numel() * 4 + _param_bytes(model.backbone) + feat_bytes),
        ("neck_only", lambda: model.rough_neck(feats), parts["neck"],
         feat_bytes + _param_bytes(model.rough_neck) + neck_carry.numel() * bpe),
        ("heads_only(x2)", lambda: [h(neck_carry) for h in heads], parts["heads"],
         neck_carry.numel() * bpe + _param_bytes(*heads) + map_bytes),
    ]
    for si, ((bb, r, r2, c), (_, n)) in enumerate(zip(shapes, specs)):
        x = torch.randn(bb, r, r2, c, generator=gen, device=device).to(dt)
        npix = bb * r * r2
        dw = torch.nn.Conv2d(c, c, 7, padding=3, groups=c).to(device)
        with torch.no_grad():
            # A chain of n x iters depthwise convolutions grows each channel's
            # variance (nothing mixes them); halved weights let it decay.
            dw.weight.mul_(0.5)

        def dw_chain(t=x, dw=dw, n=n):
            for _ in range(n):
                t = conv2d_nhwc(t, dw, dt)
            return t

        ln, up, down = torch.nn.LayerNorm(c, eps=EPS), torch.nn.Linear(c, 4 * c), torch.nn.Linear(4 * c, c)
        for m in (ln, up, down):
            m.to(device)

        def mlp_chain(t=x, ln=ln, up=up, down=down, n=n):
            for _ in range(n):
                y = F.layer_norm(t.float(), (t.shape[-1],), ln.weight, ln.bias, EPS).to(dt)
                y = F.gelu(F.linear(y, up.weight.to(dt), up.bias.to(dt)))
                t = t + 1e-6 * F.linear(y, down.weight.to(dt), down.bias.to(dt))
            return t

        dw_flops, mlp_flops = (n * v for v in tp.block_flops(npix, c))
        act = 2 * npix * c * bpe
        out.append((f"stage{si} dwconv7x7 x{n}", dw_chain, dw_flops, act + _param_bytes(dw)))
        out.append((f"stage{si} LN+MLP4x x{n}", mlp_chain, mlp_flops, act + _param_bytes(ln, up, down)))
    return out


def main(argv=None) -> List[Dict[str, float]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hw", type=int, default=1280)
    ap.add_argument("--dtype", default="bf16", choices=sorted(tp.DTYPES))
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--block-spec", default=tp.TINY_SPEC, help="backbone stages, CxN each (default: tiny)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    from ..models.adaptive_scaling import AdaptiveScaling

    device = tp.resolve(args.device)
    base, specs = tp.build(args.block_spec, "f32", torch.device("cpu"))
    dt = tp.DTYPES[args.dtype]
    residual = dt if args.pallas else torch.float32
    model = AdaptiveScaling(base.config, dt, residual)
    model.load_state_dict(base.state_dict())
    model = model.to(device).eval()
    peak = tp.H100_PEAK_BF16 if args.dtype == "bf16" else tp.H100_PEAK_F32_3XTF32
    ridge = peak / tp.HBM_BW
    label_card = tp.card(args.device)
    print(
        f"tiny/FPN rough forward, B{args.batch}@{args.hw}, {args.dtype}, pallas={args.pallas}, "
        f"device={device.type} [{label_card}]; peak {peak / 1e12:.0f} TFLOP/s, {tp.HBM_BW / 1e12:.2f} TB/s, "
        f"ridge point {ridge:.0f} flops/byte",
        flush=True,
    )
    results = []
    with torch.inference_mode():
        for label, fn, flops, nbytes in rows(model, specs, args.batch, args.hw, args.dtype, device):
            dt_s = tp.seconds_per_call(fn, args.iters, device)
            bound = max(flops / peak, nbytes / tp.HBM_BW)
            share = bound / dt_s
            if share > 1.0:
                raise AssertionError(
                    f"{label}: {dt_s * 1e3:.4f} ms is under its bound {bound * 1e3:.4f} ms "
                    f"({share * 100:.1f} %): the count or the timing is wrong"
                )
            ai = flops / max(nbytes, 1)
            print(
                f"{label:<28} {dt_s * 1e3:8.3f} ms  {flops / dt_s / 1e12:7.2f} TF/s  roofline: AI={ai:7.1f} fl/B "
                f"({'BW' if ai < ridge else 'FLOP'}-bound) bound={bound * 1e3:8.4f} ms  "
                f"achieved/bound={share * 100:5.1f}%  [{label_card}]",
                flush=True,
            )
            results.append({"label": label, "ms": dt_s * 1e3, "flops": flops, "bytes": nbytes,
                            "bound_ms": bound * 1e3, "share": share})

    by = {r["label"]: r for r in results}
    stage_bound = sum(r["bound_ms"] for r in results if r["label"].startswith("stage"))
    print("\nsummary:", flush=True)
    print(f"  sum of per-stage roofline bounds (dw+mlp only): {stage_bound:.3f} ms", flush=True)
    print(
        f"  measured full forward: {by['full_rough_forward']['ms']:.3f} ms; "
        f"backbone {by['backbone_only']['ms']:.3f} ms  [{label_card}]",
        flush=True,
    )
    print(
        "  interpretation: components below the ridge point are HBM-bound - their bound is set by"
        " byte traffic, not flops; whole-model MFU is capped at (flops_total/peak) / sum(bounds)"
        " regardless of schedule.",
        flush=True,
    )
    return results


if __name__ == "__main__":
    main()
