"""Time the f32 FPN neck level-0, heads and ConvNeXt-block kernels, and the
block's bf16 entries, of one checkout's ``adascale_torch`` alone, on one
CUDA card, at the flagship's shapes, random weights from ``--seed``:

- the block (``convnext_block``) at the four stage shapes of the rough pass
  of a 1024x768 page (240x192x96 .. 30x24x768);
- the block in bf16 (``--only block_bf16``; ``convnext_block(x, p,
  torch.bfloat16)``), in its Pallas mode (bf16 x) and its module mode (f32
  x), at the eight stage shapes of both passes of that page (the rough
  pass's and its 1024x832 precise stack's), each launch by name; beside
  them, as a yardstick that is on no path of the port, one cuBLAS bf16
  ``torch.matmul`` of each of the block's two GEMM shapes (M x C . C x 4C
  and M x 4C . 4C x C);
- the neck level 0 (``fused_neck_l0``) over f0 (1, H, W, 96) and u
  (1, H, W, 384), 384 -> 96, at the rough pass's 240x192 and the precise
  pass's 256x208;
- the rough heads over (1, 240, 192, 384) and the precise heads over
  (1, 256, 208, 384).

    python3 tools/kernel_ms.py [--root CHECKOUT] [--label NAME]
        [--only neck|heads|block|block_bf16|block_bf16_host]

For each case it prints one JSON line with:

- ``call_ms``: one wrapper call, CUDA events around back-to-back warm
  calls, median of three runs; whatever host work the wrapper does per call
  (such as packing the weights) counts where it outlasts the device work;
- ``kernel_ms``: the device time of the kernel's launches per call, from a
  ``torch.profiler`` trace of warm calls (``key_averages()``, kernels whose
  name holds one of the case's patterns, each one's mean launch), and
  ``launches_ms``: the same by kernel name (the neck's two launches apart);
- ``other_device_ms``: the device time of everything else the call ran on
  the card (copies and fills, for a wrapper that packs per call).

The bf16 block's cases add ``mode``, and after each pass's four shapes a
line sums the pass (``blocks``: 3, 3, 9, 3 blocks a stage), launch by
launch; a last line sums both passes (36 blocks) in each mode. The
yardstick lines carry ``cublas_gemm1_ms`` and ``cublas_gemm2_ms`` (CUDA
events, warm); a ``host_us_per_call`` line a mode gives the wrapper's host
time a call (the wall clock over back-to-back calls on a 8x8x384 block,
whose device work is shorter), which bounds a call from below where the
device work is shorter still.

``--only block_bf16_host`` prints one line instead: the bf16 block
wrapper's host time a call on an 8x8x384 block, whole and step by step
(each per-call step beside a dict lookup that would cache it, and the
checks that the per-parameter-set pack cache skips), each the median of
five runs of back-to-back calls on the wall clock.

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
import time

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
# Both passes' stage shapes (the rough pass's, then the 1024x832 precise
# stack's) and the blocks each stage runs.
BLOCK_BF16_SHAPES = {
    "rough": BLOCK_SHAPES,
    "precise": ((1, 256, 208, 96), (1, 128, 104, 192), (1, 64, 52, 384), (1, 32, 26, 768)),
}
STAGE_BLOCKS = (3, 3, 9, 3)
# Kernel-name patterns of each wrapper's launches.
NECK_KERNELS = ("step1_kernel", "step2_kernel")
HEADS_KERNELS = ("heads_kernel",)
BLOCK_KERNELS = ("dw_ln_kernel", "gemm_3xtf32_kernel", "reduce_kernel")
# The bf16 block's launches, whatever its design names them.
BLOCK_BF16_KERNELS = ("dw_ln_", "gemm_", "mlp_", "reduce_bf16_kernel")


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


def device_ms(fn, reps: int, patterns, tries: int = 3):
    """(kernel ms, kernel ms by name, everything else) per call, device time
    from a trace of ``reps`` warm calls. The profiler loses launches now
    and then, and this reads a trace as ``chip_smoke.py::kernel_device_ms``
    does: each kernel of a case launches once a call, so its mean launch is
    its ms a call, which a partial loss does not bias; a trace that kept
    none of the case's kernels is taken again, up to ``tries`` times. A
    kernel whose launches in the trace are not ``reps`` is printed, so that
    every loss shows."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if any(p in e.key for e in events for p in patterns):
            break
        print(f"torch.profiler kept no launch matching {patterns}; tracing again", file=sys.stderr, flush=True)
    else:
        raise AssertionError(f"no launch matching {patterns} in {tries} traces")
    by_name, other = {}, 0.0
    for event in events:
        if any(p in event.key for p in patterns):
            if event.count != reps:
                print(f"torch.profiler kept {event.count} launches of {event.key[:80]} over {reps} calls",
                      file=sys.stderr, flush=True)
            name = short_name(event.key)
            by_name[name] = by_name.get(name, 0.0) + event.device_time_total / 1e3 / event.count
        else:
            other += event.device_time_total / 1e3 / reps
    return sum(by_name.values()), by_name, other


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default="")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--only", choices=("neck", "heads", "block", "block_bf16", "block_bf16_host"))
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
    if args.only == "block_bf16_host":
        block_bf16_host(convnext_block, gen, args, card)
        return
    wanted = {args.only} if args.only else {"neck", "heads", "block", "block_bf16"}
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
    if "block_bf16" in wanted:
        block_bf16(convnext_block, gen, args, card)


def block_bf16(convnext_block, gen: torch.Generator, args, card: str) -> None:
    """The bf16 block in both modes at both passes' stage shapes, each launch
    by name, summed per pass and over both; the cuBLAS yardstick beside each
    shape."""
    totals = {}
    for which, shapes in BLOCK_BF16_SHAPES.items():
        for shape, blocks in zip(shapes, STAGE_BLOCKS):
            b, h, w, c = shape
            p, x32 = block_params(c, gen), randn(gen, *shape)
            for mode in ("pallas", "module"):
                x = x32 if mode == "module" else x32.to(torch.bfloat16)
                fn = lambda x=x, p=p: convnext_block.convnext_block(x, p, torch.bfloat16)  # noqa: E731
                kernel, launches, other = device_ms(fn, args.reps, BLOCK_BF16_KERNELS)
                line = {"label": args.label, "kernel": "convnext_block_bf16", "mode": mode, "pass": which,
                        "shape": list(shape), "blocks": blocks, "call_ms": call_ms(fn, args.reps),
                        "kernel_ms": kernel, "launches_ms": launches, "other_device_ms": other, "card": card}
                print(json.dumps(line), flush=True)
                for key in ((mode, which), (mode, "both")):
                    t = totals.setdefault(key, {"kernel_ms": 0.0, "call_ms": 0.0, "launches_ms": {}})
                    t["kernel_ms"] += blocks * kernel
                    t["call_ms"] += blocks * line["call_ms"]
                    for name, ms in launches.items():
                        t["launches_ms"][name] = t["launches_ms"].get(name, 0.0) + blocks * ms
            m = b * h * w
            hb = randn(gen, m, c).to(torch.bfloat16)
            ub = randn(gen, m, 4 * c).to(torch.bfloat16)
            w1t = randn(gen, c, 4 * c, scale=c ** -0.5).to(torch.bfloat16)
            w2t = randn(gen, 4 * c, c, scale=(4 * c) ** -0.5).to(torch.bfloat16)
            print(json.dumps({
                "label": args.label, "yardstick": "cublas_bf16_matmul", "pass": which, "shape": list(shape),
                "cublas_gemm1_ms": call_ms(lambda: torch.matmul(hb, w1t), args.reps),
                "cublas_gemm2_ms": call_ms(lambda: torch.matmul(ub, w2t), args.reps), "card": card,
            }), flush=True)
    # The wrapper's host time a call: back-to-back calls on a shape whose
    # device work is far shorter, the wall clock over the calls.
    shape = (1, 8, 8, 384)
    p, x32 = block_params(shape[-1], gen), randn(gen, *shape)
    for mode in ("pallas", "module"):
        x = x32 if mode == "module" else x32.to(torch.bfloat16)
        for _ in range(20):
            convnext_block.convnext_block(x, p, torch.bfloat16)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(200):
            convnext_block.convnext_block(x, p, torch.bfloat16)
        host_us = (time.perf_counter() - start) / 200 * 1e6
        torch.cuda.synchronize()
        print(json.dumps({"label": args.label, "kernel": "convnext_block_bf16", "mode": mode,
                          "host_us_per_call": host_us, "shape": list(shape), "card": card}), flush=True)
    for (mode, which), t in totals.items():
        print(json.dumps({"label": args.label, "kernel": "convnext_block_bf16", "mode": mode, "pass": which,
                          "blocks": 36 if which == "both" else 18, **t, "card": card}), flush=True)


def host_us(fn, n: int = 5000) -> float:
    """Microseconds of host time a call of ``fn``: the median of five runs
    of ``n`` back-to-back calls on the wall clock."""
    for _ in range(100):
        fn()
    runs = []
    for _ in range(5):
        start = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - start) / n * 1e6)
    return sorted(runs)[2]


def block_bf16_host(convnext_block, gen: torch.Generator, args, card: str) -> None:
    """The bf16 block wrapper's host time a call, whole and by step, on
    this checkout's wrapper (``--root`` is not read): each step that the
    wrapper does per call beside what a cache of it would cost instead (a
    dict lookup; ``raw_stream`` for ``current_stream``), and the checks
    that the per-parameter-set cache skips. One JSON line."""
    from adascale_torch.kernels import _nvcc, packing

    shape = (1, 8, 8, 384)
    b, h, w, c = shape
    p, x32 = block_params(c, gen), randn(gen, *shape)
    dev = x32.device
    index = dev.index
    lib = convnext_block.build_bf16(False)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    cache = {index: sms}
    xb = x32.to(torch.bfloat16)
    steps = {
        "wrapper_pallas": lambda: convnext_block.convnext_block(xb, p, torch.bfloat16),
        "wrapper_module": lambda: convnext_block.convnext_block(x32, p, torch.bfloat16),
        "parameter_set_cache_hit": lambda: convnext_block.bf16_weights(p, c, dev),
        "parameter_checks_skipped": lambda: [
            _nvcc.check_param(name, p[name], s, dev) for name, s in convnext_block._param_shapes(c).items()
        ],
        "device_properties": lambda: torch.cuda.get_device_properties(index).multi_processor_count,
        "dict_lookup": lambda: cache.get(index),
        "workspace_size": lambda: lib.convnext_block_bf16_workspace(b, h, w, c, sms),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "device_guard": lambda: _guard(index),
        "check_activation": lambda: _nvcc.check_activation("x", xb, dev, (torch.bfloat16,)),
        "two_empties": lambda: (torch.empty(4096, dtype=torch.float32, device=dev), torch.empty_like(xb)),
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        steps["raw_stream"] = lambda: raw(index)
    packs = packing.PACKS
    result = {name: host_us(fn, 1000 if name.startswith("wrapper") else 5000) for name, fn in steps.items()}
    torch.cuda.synchronize()
    print(json.dumps({"label": args.label, "kernel": "convnext_block_bf16", "shape": list(shape),
                      "host_us": result, "packs_during_timing": packing.PACKS - packs, "card": card}),
          flush=True)


def _guard(index: int) -> None:
    with torch.cuda.device(index):
        pass


if __name__ == "__main__":
    main()
