"""A/B sweep of the hand-written kernels on the card.

Counterpart of ``adascale/tools/kernel_sweep.py``. Per backbone stage of the
tiny preset at (batch, hw), a chain of that stage's blocks through each
entry the Hopper block kernel has:

  * ``3xtf32``: f32, three TF32 products a product (``matmul_precision``
    "highest", the default);
  * ``tf32``: f32, one TF32 pass inside ``matmul_precision("default")``;
  * ``bf16 pallas``: bf16 in and out (the Pallas backbone's mode);
  * ``bf16 module``: f32 in and out, bf16 products (the module mode);

then the full rough forward (the block kernel in the backbone) with the
module neck and heads, with the heads fused (``forward_rough_from_features_fused(
..., fuse_neck=False)``: the module neck feeds the heads kernel) and with
neck and heads fused, and the full precise forward with the module and the
fused neck and heads, at ``--dtype``. Each is timed warm (CUDA events around
``iters`` calls after one warm-up; the host clock on the CPU) and printed,
then all as the JAX tool's JSON line ``{"kernel_sweep_ms": {...}}``.

``--skip-stages`` leaves out the per-stage chains and times only the full
forwards, as in the JAX tool.

The TPU sweep's ``tile_h``, ``dw_tap_major`` and ``halo_thin`` were Mosaic
tiling choices; the Hopper kernels have no such knobs and none was added.

Usage:  python -m adascale_torch.tools.kernel_sweep [--batch 16] [--hw 1280]
            [--dtype bf16|f32] [--iters 8] [--skip-stages] [--device cuda|cpu]
            [--block-spec 96x3,192x3,384x9,768x3]
"""
from __future__ import annotations

import argparse
import contextlib
import json
from typing import Dict

import torch

from . import train_profile as tp

ENTRIES = ("3xtf32", "tf32", "bf16 pallas", "bf16 module")


def block_chain(x: torch.Tensor, p: Dict[str, torch.Tensor], n: int, entry: str):
    """``n`` blocks on ``x`` through one entry of the block kernel."""
    from ..kernels.convnext_block import convnext_block
    from ..utils.precision import matmul_precision

    x = x.to(torch.bfloat16) if entry == "bf16 pallas" else x.float()

    def run():
        t = x
        with matmul_precision("default") if entry == "tf32" else contextlib.nullcontext():
            for _ in range(n):
                t = convnext_block(t, p) if entry in ("3xtf32", "tf32") else convnext_block(t, p, torch.bfloat16)
        return t

    return run


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hw", type=int, default=1280)
    ap.add_argument("--dtype", default="bf16", choices=sorted(tp.DTYPES))
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--skip-stages", action="store_true",
                    help="skip the per-stage block sweep; time only the full forwards")
    ap.add_argument("--block-spec", default=tp.TINY_SPEC, help="backbone stages, CxN each (default: tiny)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    from ..kernels.fpn_heads import forward_rough_from_features_fused
    from ..kernels.precise_heads import forward_precise_from_features_fused
    from ..models.adaptive_scaling import AdaptiveScaling

    device = tp.resolve(args.device)
    label_card = tp.card(args.device)
    b, hw = args.batch, args.hw
    base, specs = tp.build(args.block_spec, "f32", torch.device("cpu"))
    print(f"kernel sweep: tiny backbone stages, B{b}@{hw} {args.dtype}, device={device.type} [{label_card}]",
          flush=True)
    results: Dict[str, float] = {}

    def timed(label, fn, pages=None):
        dt = tp.seconds_per_call(fn, args.iters, device)
        results[label] = dt * 1e3
        rate = f"  -> {pages / dt:.1f} pages/s" if pages else ""
        print(f"{label:<44} {dt * 1e3:9.3f} ms{rate}  [{label_card}]", flush=True)

    with torch.inference_mode():
        if not args.skip_stages:
            gen = torch.Generator(device=device).manual_seed(0)
            for si, ((bb, r, r2, c), (_, n)) in enumerate(zip(tp.stage_shapes(specs, b, hw, hw), specs)):
                block = getattr(base.backbone, f"stage{si}").layer0
                p = {k: v.to(device) for k, v in block.state_dict().items()}
                x = torch.randn(bb, r, r2, c, generator=gen, device=device)
                for entry in ENTRIES:
                    timed(f"s{si} {r}x{r2}x{c} x{n} {entry}", block_chain(x, p, n, entry))

        dt = tp.DTYPES[args.dtype]
        # The fused neck and heads take the Pallas backbone's features, as
        # the engine routes them (a bf16 residual in bf16).
        model = AdaptiveScaling(base.config, dt, dt)
        model.load_state_dict(base.state_dict())
        model = model.to(device).eval()
        image = torch.rand(b, hw, hw, 3, generator=torch.Generator(device=device).manual_seed(1), device=device)
        image = image * 255
        variants = [
            ("full rough fwd module", lambda f: model.forward_rough_from_features(f)),
            ("full rough fwd +heads", lambda f: forward_rough_from_features_fused(model, f, fuse_neck=False)),
            ("full rough fwd +neck+heads", lambda f: forward_rough_from_features_fused(model, f)),
            ("full precise fwd module", lambda f: model.forward_precise_from_features(f)),
            ("full precise fwd fused", lambda f: forward_precise_from_features_fused(model, f)),
        ]
        for label, head in variants:
            timed(label, lambda head=head: head(model.backbone(image)), pages=b)
    print(json.dumps({"kernel_sweep_ms": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
