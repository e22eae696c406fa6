"""Time the f32 FPN neck level-0, heads and ConvNeXt-block kernels of one
checkout's ``adascale_torch`` alone, on one CUDA card, at the flagship's
shapes, random weights from ``--seed``:

- the block (``convnext_block``) at the four stage shapes of the rough pass
  of a 1024x768 page (240x192x96 .. 30x24x768);
- the neck level 0 (``fused_neck_l0``) over f0 (1, H, W, 96) and u
  (1, H, W, 384), 384 -> 96, at the rough pass's 240x192 and the precise
  pass's 256x208;
- the rough heads over (1, 240, 192, 384) and the precise heads over
  (1, 256, 208, 384).

    python3 tools/kernel_ms.py [--root CHECKOUT] [--label NAME] [--only neck|heads|block]

For each case it prints one JSON line with:

- ``call_ms``: one wrapper call, CUDA events around back-to-back warm
  calls, median of three runs; whatever host work the wrapper does per call
  (such as packing the weights) counts where it outlasts the device work;
- ``kernel_ms``: the device time of the kernel's launches per call, from a
  ``torch.profiler`` trace of warm calls (``key_averages()``, kernels whose
  name holds one of the case's patterns), and ``launches_ms``: the same by
  kernel name (the neck's two launches apart);
- ``other_device_ms``: the device time of everything else the call ran on
  the card (copies and fills, for a wrapper that packs per call).

Every checkout's wrappers take the same arguments, so two of them (each
unpacked from ``git archive``) can be compared in one run on one card:
``--root`` names the checkout whose ``adascale_torch`` is imported (default:
the one holding this script). The card's name and power limit come first,
as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

NECK_SHAPES = ((1, 240, 192), (1, 256, 208))
NECK_WIDTHS = (96, 384, 96)  # C0, Cm, Co
ROUGH_SHAPE = (1, 240, 192, 384)
PRECISE_SHAPE = (1, 256, 208, 384)
ROUGH_OUT = (1, 1)
PRECISE_OUT = (1, 2, 4, 4)
BLOCK_SHAPES = ((1, 240, 192, 96), (1, 120, 96, 192), (1, 60, 48, 384), (1, 30, 24, 768))
# Kernel-name patterns of each wrapper's launches.
NECK_KERNELS = ("step1_kernel", "step2_kernel")
HEADS_KERNELS = ("heads_kernel",)
BLOCK_KERNELS = ("dw_ln_kernel", "gemm_3xtf32_kernel", "reduce_kernel")


def randn(gen: torch.Generator, *shape, scale=1.0, shift=0.0):
    return (torch.randn(*shape, generator=gen) * scale + shift).to("cuda")


def head_params(c: int, m: int, gen: torch.Generator):
    """An FpnHead's parameters under the port's names; inner width
    (c + m) // 2 as the model has it."""
    f = (c + m) // 2
    return {
        "step1.conv.weight": randn(gen, f, c, 3, 3, scale=(9 * c) ** -0.5),
        "step1.conv.bias": randn(gen, f, scale=0.1),
        "step1.ln.weight": randn(gen, f, scale=0.1, shift=1.0),
        "step1.ln.bias": randn(gen, f, scale=0.1),
        "step2.weight": randn(gen, m, f, scale=f ** -0.5),
        "step2.bias": randn(gen, m, scale=0.1),
    }


def neck_params(c0: int, cm: int, co: int, gen: torch.Generator):
    """The neck's level-0 parameters under the port's names."""
    return {
        "step1_0.conv.weight": randn(gen, cm, c0, scale=c0 ** -0.5),
        "step1_0.conv.bias": randn(gen, cm, scale=0.1),
        "step1_0.ln.weight": randn(gen, cm, scale=0.1, shift=1.0),
        "step1_0.ln.bias": randn(gen, cm, scale=0.1),
        "step2_0.conv.weight": randn(gen, co, cm, 3, 3, scale=(9 * cm) ** -0.5),
        "step2_0.conv.bias": randn(gen, co, scale=0.1),
        "step2_0.ln.weight": randn(gen, co, scale=0.1, shift=1.0),
        "step2_0.ln.bias": randn(gen, co, scale=0.1),
    }


def block_params(c: int, gen: torch.Generator):
    """A ConvNeXt block's parameters under the port's names."""
    return {
        "dwconv.weight": randn(gen, c, 1, 7, 7, scale=0.1),
        "dwconv.bias": randn(gen, c, scale=0.1),
        "ln.weight": randn(gen, c, scale=0.1, shift=1.0),
        "ln.bias": randn(gen, c, scale=0.1),
        "mlp_up.weight": randn(gen, 4 * c, c, scale=c ** -0.5),
        "mlp_up.bias": randn(gen, 4 * c, scale=0.1),
        "mlp_down.weight": randn(gen, c, 4 * c, scale=(4 * c) ** -0.5),
        "mlp_down.bias": randn(gen, c, scale=0.1),
        "block_scale": randn(gen, c, scale=0.1),
    }


def call_ms(fn, reps: int) -> float:
    """Milliseconds of one call, back to back and warm: median of three runs
    of ``reps`` calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return sorted(runs)[1]


def short_name(key: str) -> str:
    """A kernel's name with its template arguments, without its namespace
    and argument list."""
    found = re.search(r"\w+_kernel(<[^>]*>)?", key)
    return found.group(0) if found else key


def device_ms(fn, reps: int, patterns):
    """(kernel ms, kernel ms by name, everything else) per call, device time
    from a trace of ``reps`` warm calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name, other = {}, 0.0
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        ms = event.device_time_total / 1e3 / reps
        if any(p in event.key for p in patterns):
            name = short_name(event.key)
            by_name[name] = by_name.get(name, 0.0) + ms
        else:
            other += ms
    if not by_name:
        raise AssertionError(f"no launch matching {patterns} in the trace")
    return sum(by_name.values()), by_name, other


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default="")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--only", choices=("neck", "heads", "block"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_ms: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from adascale_torch.kernels import convnext_block, fpn_heads, fpn_neck, precise_heads

    if not os.path.abspath(fpn_heads.__file__).startswith(root + os.sep):
        sys.exit(f"kernel_ms: imported {fpn_heads.__file__}, not from {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    wanted = {args.only} if args.only else {"neck", "heads", "block"}
    cases = []
    if "block" in wanted:
        for shape in BLOCK_SHAPES:
            p, x = block_params(shape[-1], gen), randn(gen, *shape)
            cases.append(("convnext_block", list(shape), BLOCK_KERNELS,
                          lambda x=x, p=p: convnext_block.convnext_block(x, p)))
    if "neck" in wanted:
        c0, cm, co = NECK_WIDTHS
        for shape in NECK_SHAPES:
            p = neck_params(c0, cm, co, gen)
            f0, u = randn(gen, *shape, c0), randn(gen, *shape, cm)
            cases.append(("fpn_neck_l0", [*shape, c0, cm, co], NECK_KERNELS,
                          lambda f0=f0, u=u, p=p: fpn_neck.fused_neck_l0(f0, u, p)))
    if "heads" in wanted:
        for name, shape, outs, wrapper in (
            ("fpn_heads", ROUGH_SHAPE, ROUGH_OUT, lambda x, heads: fpn_heads.fused_rough_heads(x, *heads)),
            ("precise_heads", PRECISE_SHAPE, PRECISE_OUT, precise_heads.fused_precise_heads),
        ):
            heads = [head_params(shape[-1], m, gen) for m in outs]
            x = randn(gen, *shape)
            cases.append((name, list(shape), HEADS_KERNELS,
                          lambda x=x, heads=heads, wrapper=wrapper: wrapper(x, heads)))
    for name, shape, patterns, fn in cases:
        kernel, launches, other = device_ms(fn, args.reps, patterns)
        print(json.dumps({
            "label": args.label,
            "kernel": name,
            "shape": shape,
            "call_ms": call_ms(fn, args.reps),
            "kernel_ms": kernel,
            "launches_ms": launches,
            "other_device_ms": other,
            "card": card,
        }), flush=True)


if __name__ == "__main__":
    main()
