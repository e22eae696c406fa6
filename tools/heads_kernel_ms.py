"""Time the two heads kernels of one checkout's ``adascale_torch`` alone, on
one CUDA card, at the flagship's shapes: rough heads over (1, 240, 192, 384),
precise heads over (1, 256, 208, 384), random weights from ``--seed``.

    python3 tools/heads_kernel_ms.py [--root CHECKOUT] [--label NAME]

For each kernel it prints one JSON line with:

- ``call_ms``: one wrapper call (``fused_rough_heads``,
  ``fused_precise_heads``), CUDA events around back-to-back warm calls,
  median of three runs; whatever host work the wrapper does per call (such
  as packing the weights) counts where it outlasts the device work;
- ``kernel_ms``: the device time of the heads kernel's launches per call,
  from a ``torch.profiler`` trace of warm calls (``key_averages()``,
  kernels whose name holds ``heads_kernel``);
- ``other_device_ms``: the device time of everything else the call ran on
  the card (copies and fills, for a wrapper that packs per call).

Both checkouts' wrappers take the same arguments, so two of them (each
unpacked from ``git archive``) can be compared in one run on one card:
``--root`` names the checkout whose ``adascale_torch`` is imported (default:
the one holding this script). The card's name and power limit come first,
as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROUGH_SHAPE = (1, 240, 192, 384)
PRECISE_SHAPE = (1, 256, 208, 384)
ROUGH_OUT = (1, 1)
PRECISE_OUT = (1, 2, 4, 4)


def head_params(c: int, m: int, gen: torch.Generator, device: str):
    """An FpnHead's parameters under the port's names; inner width
    (c + m) // 2 as the model has it."""
    f = (c + m) // 2

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device)

    return {
        "step1.conv.weight": r(f, c, 3, 3, scale=(9 * c) ** -0.5),
        "step1.conv.bias": r(f, scale=0.1),
        "step1.ln.weight": r(f, scale=0.1, shift=1.0),
        "step1.ln.bias": r(f, scale=0.1),
        "step2.weight": r(m, f, scale=f ** -0.5),
        "step2.bias": r(m, scale=0.1),
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


def device_ms(fn, reps: int):
    """(heads kernel, everything else) device ms per call, from a trace of
    ``reps`` warm calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernel = other = 0.0
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        ms = event.device_time_total / 1e3 / reps
        if "heads_kernel" in event.key:
            kernel += ms
        else:
            other += ms
    if not kernel:
        raise AssertionError("no heads_kernel launch in the trace")
    return kernel, other


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default="")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("heads_kernel_ms: no CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from adascale_torch.kernels import fpn_heads, precise_heads

    if not os.path.abspath(fpn_heads.__file__).startswith(root + os.sep):
        sys.exit(f"heads_kernel_ms: imported {fpn_heads.__file__}, not from {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    cases = (
        ("fpn_heads", ROUGH_SHAPE, ROUGH_OUT, lambda x, heads: fpn_heads.fused_rough_heads(x, *heads)),
        ("precise_heads", PRECISE_SHAPE, PRECISE_OUT, precise_heads.fused_precise_heads),
    )
    for name, shape, outs, wrapper in cases:
        heads = [head_params(shape[-1], m, gen, "cuda") for m in outs]
        x = torch.randn(*shape, generator=gen).to("cuda")
        kernel, other = device_ms(lambda: wrapper(x, heads), args.reps)
        print(json.dumps({
            "label": args.label,
            "kernel": name,
            "shape": list(shape),
            "call_ms": call_ms(lambda: wrapper(x, heads), args.reps),
            "kernel_ms": kernel,
            "other_device_ms": other,
            "card": card,
        }), flush=True)


if __name__ == "__main__":
    main()
