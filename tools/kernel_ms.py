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
  (1, 256, 208, 384);
- in bf16 (``--only heads_bf16`` and ``--only neck_bf16``; the
  ``compute_dtype="bfloat16"`` entries, rows 2b, 4b and 3b of PERF.md) the
  same heads and neck cases on bf16 inputs, each launch by name, with the
  wrapper's host time a call (``host_us_per_call``, the wall clock over
  back-to-back calls on a 1x8x16 map, whose device work is shorter) and
  the bytes the checkout's design reads through L2 a call
  (``l2_read_bytes``, counted from its tiles: the TMA-fed design's halo
  boxes and B stages where the checkout packs ``pack_sw128``, else the
  shared-memory-ring design's shifted A rows and B a block) over the
  kernel's device time; beside them, as a yardstick that is on no path of the port, one
  cuBLAS bf16 ``torch.matmul`` of each kernel's product shape: for each
  head (4 phases x pixels) x 4C . 4C x F, and the neck's pixels x C0 .
  C0 x Cm and pixels x 9Cm . 9Cm x Co;
- ``--only forwards_bf16``: the flagship's fused bf16 forwards
  (``compute_dtype="bfloat16"``, the Pallas backbone, the fused neck and
  heads; weights from ``--weights``) on random inputs of page_0's rough
  (1, 960, 768, 3) and precise (1, 1024, 832, 3) shapes, at B = 1 and per
  page at B = 16;
- ``--only forwards``: the flagship's eager rough and precise forwards
  (the engine's ``_forward``) in f32 and bf16, module path and fused
  (bf16 with the Pallas backbone, as the fused bf16 engine needs), on
  random inputs of page_0's shapes at B = 1 and per page at B = 16, and
  the block's host time a call on a 1x8x8x96 block (f32, bf16 in both
  modes). Each is timed with the blocks through the checkout's wrapper
  (eager: straight to the launch) and, where the checkout registers the
  block operator (``torch.ops.adascale_torch.convnext_block``, which
  traced calls reach), also through the operator, the two alternately in
  one process (``FORWARD_ROUNDS`` rounds each, the median), so that the
  operator's dispatch cost shows beside the same process's direct calls;
- ``--only block_tf32``: the block's single-pass TF32 entry
  (``convnext_block(x, p)`` inside ``matmul_precision("default")``) at the
  eight stage shapes of both passes, each launch by name (depthwise + LN,
  the GEMMs or the fused MLP, the split reduction), summed per pass and
  over both (36 blocks), with the 3xTF32 entry's call on the same inputs
  beside each (``call_3xtf32_ms``);
- ``--only heads_tf32``: the heads' single-pass TF32 entries (the precise
  heads over (1, 256, 208, 384), the rough over (1, 240, 192, 384)) inside
  ``matmul_precision("default")``, each launch by name, with the 3xTF32
  entry's call beside them;
- ``--only heads_wide``: the rough and precise heads at the widths of the
  ``base`` and ``large`` backbones (C = Cm = 512 / 768, F = (C + M) // 2),
  wider than one tile, B = 1 at the page shapes (the rough heads over
  240x192, the precise over 256x208), in all three precisions (f32 at
  "highest", its single-pass TF32 entry at "default", bf16): the device
  ms a call (each kernel's mean launch times its launches a call, summed,
  whatever the design's launches a call; ``launches_per_call`` says how
  many launches the trace kept), each launch by
  name, the wrapper call's ms, and the bound (the products at the
  precision's dense rate: 989 TFLOP/s bf16, 495 TF32, three TF32 products
  a product for f32; against the bytes at 3.35 TB/s) with the kernel's
  share of it;
- ``--only neck_wide``: the neck level 0 at the widths of the ``base`` and
  ``large`` backbones (C0 / Cm / Co = 128 / 512 / 128 and 192 / 768 /
  192), wider than the one-pass tiles, B = 1 at both passes' level-0 shapes
  (240x192, 256x208), in all three precisions: the device ms a call as
  ``heads_wide`` sums it, by step (``step1_ms``, ``step2_ms``; the split
  design's second passes apart, ``second_pass_ms``), the bound (operations
  at the precision's rate against the bytes: f0, u, t written and read,
  out) with the share of it, and ``estimate`` (``neck_wide_estimate``:
  each step's bytes into the multiprocessors and from device memory,
  counted from the tiles of the cluster design, at stated rates);
- ``--only neck_tf32``: the neck level 0's single-pass TF32 entry at the
  rough pass's 240x192 and the precise pass's 256x208 (96 -> 384 -> 96)
  inside ``matmul_precision("default")``, its two launches by name and as
  ``step1_ms`` / ``step2_ms``, with the 3xTF32 entry's call beside them,
  and a line summing both shapes;
- ``--only forwards_tf32``: the flagship's f32 rough and precise forwards
  at ``matmul_precision("default")`` (the single-pass TF32 entries), module
  path and fused (weights from ``--weights``), on random inputs of
  page_0's shapes at B = 1 and per page at B = 16;
- ``--only l2``: the read rate the card gives from L2 and from device
  memory: a copy kernel written for this (``L2_READ_SOURCE``, on no path
  of the port; built by ``nvcc`` into ``tools/_build/``) reads a buffer of
  8, 16 or 24 MB (which stays in the 50 MB L2) 64 times, 16 bytes a
  thread a load cached in L2 only, and a 1 GB buffer once (CUDA events
  over back-to-back warm calls).

    python3 tools/kernel_ms.py [--root CHECKOUT] [--label NAME]
        [--only neck|heads|block|block_bf16|block_bf16_host|block_tf32|heads_tf32|heads_wide|neck_wide|
                neck_tf32|heads_bf16|neck_bf16|forwards_bf16|forwards_tf32|forwards|l2, or several joined by
                commas, run in that order]
        [--weights NPZ]

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
import statistics
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
# The heads at the base and large backbones' widths (C = Cm; F = (C + M)
# // 2, wider than one tile) at the page shapes, B = 1.
WIDE_PRESETS = {"base": 512, "large": 768}
WIDE_PAGE_HW = {"fpn_heads": (240, 192), "precise_heads": (256, 208)}
# The neck level 0 at the base and large backbones' widths (C0, Cm, Co),
# at both passes' level-0 shapes, B = 1.
WIDE_NECK_PRESETS = {"base": (128, 512, 128), "large": (192, 768, 192)}
# Dense peaks of one H100 SXM (700 W), FLOP/s and bytes/s.
PEAK_BF16, PEAK_TF32, PEAK_BYTES = 989e12, 495e12, 3.35e12
# Kernel-name patterns of each wrapper's launches (each design's names).
NECK_KERNELS = ("neck_step1_", "neck_step2_")
# The wide neck's launches in either design (the split design's second
# LayerNorm pass, ln_gelu_rows, too).
WIDE_NECK_KERNELS = NECK_KERNELS + ("ln_gelu_rows",)
# The rates the wide neck's estimate assumes: what the TMA-fed TF32 and bf16
# wide heads took into the multiprocessors (~6.5 and ~5.0 TB/s, PERF.md row
# 2w), what a step1 reads and writes in device memory (2.0 TB/s, between the
# narrow step1s' 0.9-1.6 and the 3.35 peak), and the share of the 3xTF32
# bound the f32 conv_gemm.cuh kernels reach (0.55; rows 2-4: 40-60 %).
INGRESS_RATE = {"tf32": 6.5e12, "bf16": 5.0e12}
STEP1_DRAM_RATE = 2.0e12
F32_SHARE = 0.55
HEADS_KERNELS = ("heads_",)
BLOCK_KERNELS = ("dw_ln_kernel", "gemm_3xtf32_kernel", "reduce_kernel")
# The bf16 block's launches, whatever its design names them.
BLOCK_BF16_KERNELS = ("dw_ln_", "gemm_", "mlp_", "reduce_bf16_kernel")
# The TF32 block's launches, whatever its design names them (the mma.sync
# design's gemm_tf32_kernel, or the wgmma design's dw_ln_rows_kernel,
# mlp_fused_tf32_kernel and gemm_tf32_wgmma_kernel).
BLOCK_TF32_KERNELS = ("dw_ln_", "gemm_", "mlp_", "reduce_kernel")


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
    parser.add_argument("--only", type=lambda v: v.split(","))
    parser.add_argument("--weights", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples/flagship_training/flagship_fpn_params.f16.npz"))
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
    onlys = args.only or [None]
    unknown = set(onlys) - {None, *ONLY_CHOICES}
    if unknown:
        sys.exit(f"kernel_ms: unknown --only {sorted(unknown)}; choose from {ONLY_CHOICES}")
    for only in onlys:
        args.only = only
        run_one(args, card, convnext_block, fpn_heads, fpn_neck, precise_heads)


ONLY_CHOICES = ("neck", "heads", "block", "block_bf16", "block_bf16_host", "block_tf32", "heads_tf32",
                "heads_wide", "neck_wide", "neck_tf32", "heads_bf16", "neck_bf16", "forwards_bf16",
                "forwards_tf32", "forwards", "l2")


def run_one(args, card: str, convnext_block, fpn_heads, fpn_neck, precise_heads) -> None:
    """One ``--only`` case (or, for None, the default set), its generator
    seeded from ``--seed``."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.only == "neck_wide":
        neck_wide(fpn_neck, gen, args, card)
        return
    if args.only == "block_bf16_host":
        block_bf16_host(convnext_block, gen, args, card)
        return
    if args.only == "l2":
        l2_rate(args, card)
        return
    if args.only == "block_tf32":
        block_tf32(convnext_block, gen, args, card)
        return
    if args.only == "heads_tf32":
        heads_tf32(fpn_heads, precise_heads, gen, args, card)
        return
    if args.only == "neck_tf32":
        neck_tf32(fpn_neck, gen, args, card)
        return
    if args.only == "heads_wide":
        heads_wide(fpn_heads, precise_heads, gen, args, card)
        return
    if args.only == "forwards_bf16":
        forwards_bf16(gen, args, card)
        return
    if args.only == "forwards_tf32":
        forwards_tf32(gen, args, card)
        return
    if args.only == "forwards":
        forwards(convnext_block, gen, args, card)
        return
    if args.only in ("heads_bf16", "neck_bf16"):
        conv_bf16(args.only, fpn_heads, precise_heads, fpn_neck, gen, args, card)
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


def at_default(fn):
    """``fn`` called inside ``matmul_precision("default")``: the single-pass
    TF32 entries."""
    from adascale_torch.utils.precision import matmul_precision

    def call():
        with matmul_precision("default"):
            return fn()

    return call


def block_tf32(convnext_block, gen: torch.Generator, args, card: str) -> None:
    """The block's TF32 entry at both passes' stage shapes, each launch by
    name, summed per pass and over both; the 3xTF32 entry's call beside."""
    totals = {}
    for which, shapes in BLOCK_BF16_SHAPES.items():
        for shape, blocks in zip(shapes, STAGE_BLOCKS):
            p, x = block_params(shape[-1], gen), randn(gen, *shape)
            fn = at_default(lambda x=x, p=p: convnext_block.convnext_block(x, p))
            kernel, launches, other = device_ms(fn, args.reps, BLOCK_TF32_KERNELS)
            line = {"label": args.label, "kernel": "convnext_block_tf32", "pass": which, "shape": list(shape),
                    "blocks": blocks, "call_ms": call_ms(fn, args.reps), "kernel_ms": kernel,
                    "launches_ms": launches, "other_device_ms": other,
                    "call_3xtf32_ms": call_ms(lambda x=x, p=p: convnext_block.convnext_block(x, p), args.reps),
                    "card": card}
            print(json.dumps(line), flush=True)
            for key in (which, "both"):
                t = totals.setdefault(key, {"kernel_ms": 0.0, "call_ms": 0.0, "call_3xtf32_ms": 0.0,
                                            "launches_ms": {}})
                for k in ("kernel_ms", "call_ms", "call_3xtf32_ms"):
                    t[k] += blocks * line[k]
                for name, ms in launches.items():
                    t["launches_ms"][name] = t["launches_ms"].get(name, 0.0) + blocks * ms
    for which, t in totals.items():
        print(json.dumps({"label": args.label, "kernel": "convnext_block_tf32", "pass": which,
                          "blocks": 36 if which == "both" else 18, **t, "card": card}), flush=True)


def heads_tf32(fpn_heads, precise_heads, gen: torch.Generator, args, card: str) -> None:
    """The heads' TF32 entries at the flagship's shapes, each launch by
    name; the 3xTF32 entry's call beside."""
    for name, shape, outs, wrapper in (
        ("precise_heads_tf32", PRECISE_SHAPE, PRECISE_OUT, precise_heads.fused_precise_heads),
        ("fpn_heads_tf32", ROUGH_SHAPE, ROUGH_OUT, lambda x, heads: fpn_heads.fused_rough_heads(x, *heads)),
    ):
        heads = [head_params(shape[-1], m, gen) for m in outs]
        x = randn(gen, *shape)
        fn3 = lambda x=x, heads=heads, wrapper=wrapper: wrapper(x, heads)  # noqa: E731
        fn = at_default(fn3)
        kernel, launches, other = device_ms(fn, args.reps, HEADS_KERNELS)
        print(json.dumps({"label": args.label, "kernel": name, "shape": list(shape),
                          "call_ms": call_ms(fn, args.reps), "kernel_ms": kernel, "launches_ms": launches,
                          "other_device_ms": other, "call_3xtf32_ms": call_ms(fn3, args.reps), "card": card}),
              flush=True)


def device_ms_a_call(fn, reps: int, patterns, tries: int = 3):
    """(kernel ms, ms by kernel name, launches a call) of ``fn``: for each
    kernel matching ``patterns`` in a trace of ``reps`` warm calls, its mean
    launch times its launches a call (its launches over ``reps``, rounded:
    the profiler loses launches now and then, and a lost launch must not
    read as a faster call), summed, for a call that may launch a kernel
    several times. A trace that kept no such launch is taken again; a
    kernel whose launches are not a whole multiple of ``reps`` is printed,
    and ``launches a call`` counts what the trace kept."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and any(p in e.key for p in patterns)]
        if events:
            break
        print(f"torch.profiler kept no launch matching {patterns}; tracing again", file=sys.stderr, flush=True)
    else:
        raise AssertionError(f"no launch matching {patterns} in {tries} traces")
    by_name, launches = {}, 0
    for event in events:
        if event.count % reps:
            print(f"torch.profiler kept {event.count} launches of {event.key[:80]} over {reps} calls",
                  file=sys.stderr, flush=True)
        name = short_name(event.key)
        per_call = max(1, round(event.count / reps))
        by_name[name] = by_name.get(name, 0.0) + event.device_time_total / 1e3 / event.count * per_call
        launches += event.count
    return sum(by_name.values()), by_name, launches / reps


def heads_wide(fpn_heads, precise_heads, gen: torch.Generator, args, card: str) -> None:
    """Rows 2w and 4w: both heads at the base and large widths at the page
    shapes, B = 1, f32, TF32 ("default") and bf16, every kernel of a call
    summed (``device_ms_a_call``); the bound and the share of it."""
    for preset, c in WIDE_PRESETS.items():
        for name, outs, wrapper in (
            ("precise_heads", PRECISE_OUT, precise_heads.fused_precise_heads),
            ("fpn_heads", ROUGH_OUT, lambda x, heads: fpn_heads.fused_rough_heads(x, *heads)),
        ):
            h, w = WIDE_PAGE_HW[name]
            heads = [head_params(c, m, gen) for m in outs]
            x32 = randn(gen, 1, h, w, c)
            widths = [p["step1.conv.weight"].shape[0] for p in heads]
            flops = h * w * 4 * sum(2 * 4 * c * f + 2 * f * m for f, m in zip(widths, outs))
            for precision in ("f32", "tf32", "bf16"):
                x = x32.to(torch.bfloat16) if precision == "bf16" else x32
                fn = lambda x=x, heads=heads, wrapper=wrapper: wrapper(x, heads)  # noqa: E731
                if precision == "tf32":
                    fn = at_default(fn)
                t_ops = {"f32": 3 * flops / PEAK_TF32, "tf32": flops / PEAK_TF32, "bf16": flops / PEAK_BF16}[precision]
                nbytes = x.element_size() * h * w * c + 4 * 4 * h * w * sum(outs)
                bound = max(t_ops, nbytes / PEAK_BYTES) * 1e3
                kernel, launches, per_call = device_ms_a_call(fn, args.reps, HEADS_KERNELS)
                print(json.dumps({
                    "label": args.label, "kernel": f"{name}_wide", "preset": preset, "precision": precision,
                    "shape": [1, h, w, c], "widths": widths, "call_ms": call_ms(fn, args.reps),
                    "kernel_ms": kernel, "launches_ms": launches, "launches_per_call": per_call,
                    "bound_ms": bound, "share_of_bound": bound / kernel, "card": card,
                }), flush=True)
            del x32, heads
            torch.cuda.empty_cache()


def neck_wide_flops_bytes(h: int, w: int, widths, precision: str):
    """(flops, bytes) of one wide neck call at B = 1: the two products; f0
    and u read, t written and read back by the 3x3, out written, in the
    operand type (the weights' few MB left out)."""
    c0, cm, co = widths
    npix = h * w
    e = 2 if precision == "bf16" else 4
    return npix * (2 * c0 * cm + 18 * cm * co), e * npix * (c0 + 3 * cm + co)


def neck_wide_bound_ms(h: int, w: int, widths, precision: str) -> float:
    """The least time of a wide neck call: the operations at the
    precision's dense rate (three TF32 products a product for f32) against
    the bytes at 3.35 TB/s."""
    flops, nbytes = neck_wide_flops_bytes(h, w, widths, precision)
    rate = {"f32": PEAK_TF32 / 3, "tf32": PEAK_TF32, "bf16": PEAK_BF16}[precision]
    return max(flops / rate, nbytes / PEAK_BYTES) * 1e3


def neck_wide_estimate(h: int, w: int, widths, precision: str) -> dict:
    """What the cluster design should take, step by step (ms), from its
    tiles at B = 1: step1's 64-pixel units read f0 once a CTA of a cluster
    (one per slice of Cm, W1 resident) and u, and write t; step2's
    128-pixel units take W2 (9 x Cm x N) and, per chunk of 128 bytes of
    channels, one 10 x 18 halo box of t. bf16 and TF32: step1 the larger of
    its device-memory bytes at STEP1_DRAM_RATE and its ingress at
    INGRESS_RATE, step2 the larger of its ingress at INGRESS_RATE and its
    products at the dense rate; f32: each step's 3xTF32 products at
    F32_SHARE of 495 TFLOP/s, or step1's bytes where more."""
    from math import ceil

    c0, cm, co = widths
    npix = h * w
    e = 2 if precision == "bf16" else 4
    kc = 128 // e
    slices1 = ceil(cm / (256 if cm <= 512 else 384 if precision != "tf32" else 192))
    n2 = 128 if co <= 128 else 192
    tiles1, tiles2 = ceil(h / 4) * ceil(w / 16), ceil(h / 8) * ceil(w / 16)
    dram1 = e * npix * (c0 + 2 * cm)
    in1 = tiles1 * 64 * e * (slices1 * c0 + cm)
    in2 = tiles2 * (9 * cm * n2 * e + ceil(cm / kc) * 10 * 18 * 128)
    ops1, ops2 = 2 * npix * c0 * cm, 18 * npix * cm * co
    if precision == "f32":
        step1 = max(3 * ops1 / (F32_SHARE * PEAK_TF32), dram1 / STEP1_DRAM_RATE)
        step2 = 3 * ops2 / (F32_SHARE * PEAK_TF32)
    else:
        peak = PEAK_TF32 if precision == "tf32" else PEAK_BF16
        step1 = max(dram1 / STEP1_DRAM_RATE, in1 / INGRESS_RATE[precision], ops1 / peak)
        step2 = max(in2 / INGRESS_RATE[precision], ops2 / peak)
    return {"step1_ingress_bytes": in1, "step1_dram_bytes": dram1, "step2_ingress_bytes": in2,
            "step1_ms": step1 * 1e3, "step2_ms": step2 * 1e3, "ms": (step1 + step2) * 1e3}


def neck_wide(fpn_neck, gen: torch.Generator, args, card: str) -> None:
    """Row 3w: the neck level 0 at the base and large widths at both
    passes' level-0 shapes, B = 1, f32, TF32 ("default") and bf16, every
    launch of a call summed (``device_ms_a_call``), by step; the bound, the
    share of it and the design's estimate."""
    for preset, widths in WIDE_NECK_PRESETS.items():
        c0, cm, co = widths
        p = neck_params(c0, cm, co, gen)
        for shape in NECK_SHAPES:
            _, h, w = shape
            f0_32, u32 = randn(gen, *shape, c0), randn(gen, *shape, cm)
            for precision in ("f32", "tf32", "bf16"):
                d = torch.bfloat16 if precision == "bf16" else torch.float32
                f0, u = f0_32.to(d), u32.to(d)
                fn = lambda f0=f0, u=u: fpn_neck.fused_neck_l0(f0, u, p)  # noqa: E731
                if precision == "tf32":
                    fn = at_default(fn)
                kernel, launches, per_call = device_ms_a_call(fn, args.reps, WIDE_NECK_KERNELS)
                bound = neck_wide_bound_ms(h, w, widths, precision)
                print(json.dumps({
                    "label": args.label, "kernel": "fpn_neck_l0_wide", "preset": preset, "precision": precision,
                    "shape": [*shape, c0, cm, co], "call_ms": call_ms(fn, args.reps), "kernel_ms": kernel,
                    **{f"{step}_ms": sum(ms for name, ms in launches.items() if f"neck_{step}_" in name)
                       for step in ("step1", "step2")},
                    "second_pass_ms": sum(ms for name, ms in launches.items() if "ln_gelu_rows" in name),
                    "launches_ms": launches, "launches_per_call": per_call, "bound_ms": bound,
                    "share_of_bound": bound / kernel, "estimate": neck_wide_estimate(h, w, widths, precision),
                    "card": card,
                }), flush=True)
            del f0_32, u32, f0, u
        del p
        torch.cuda.empty_cache()


def neck_tf32(fpn_neck, gen: torch.Generator, args, card: str) -> None:
    """The neck's TF32 entry at both passes' level-0 shapes, each launch by
    name and by step; the 3xTF32 entry's call beside; then both shapes
    summed, as one page's fused forwards launch them."""
    c0, cm, co = NECK_WIDTHS
    total = {"kernel_ms": 0.0, "step1_ms": 0.0, "step2_ms": 0.0, "call_ms": 0.0, "call_3xtf32_ms": 0.0}
    for shape in NECK_SHAPES:
        p = neck_params(c0, cm, co, gen)
        f0, u = randn(gen, *shape, c0), randn(gen, *shape, cm)
        fn3 = lambda f0=f0, u=u, p=p: fpn_neck.fused_neck_l0(f0, u, p)  # noqa: E731
        fn = at_default(fn3)
        kernel, launches, other = device_ms(fn, args.reps, NECK_KERNELS)
        line = {"label": args.label, "kernel": "fpn_neck_l0_tf32", "shape": [*shape, c0, cm, co],
                "call_ms": call_ms(fn, args.reps), "kernel_ms": kernel, "launches_ms": launches,
                **{f"{step}_ms": sum(ms for name, ms in launches.items() if f"neck_{step}_" in name)
                   for step in ("step1", "step2")},
                "other_device_ms": other, "call_3xtf32_ms": call_ms(fn3, args.reps), "card": card}
        print(json.dumps(line), flush=True)
        for k in total:
            total[k] += line[k]
    print(json.dumps({"label": args.label, "kernel": "fpn_neck_l0_tf32", "shapes": "both", **total, "card": card}),
          flush=True)


def wrapper_host_us(fn, n: int = 200) -> float:
    """Host microseconds a wrapper call: the wall clock over ``n``
    back-to-back calls (whose device work is shorter), then a synchronise
    outside the clock."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - start) / n * 1e6
    torch.cuda.synchronize()
    return us


def l2_bytes(tma: bool, kind: str, b: int, h: int, w: int, c, widths) -> int:
    """Bytes a bf16 call reads through L2, from its tiles. The TMA-fed
    design (``csrc/conv_tma.cuh``): per tile and 64-channel chunk one halo
    box (16 + KW - 1 columns by BH + KH - 1 rows) and each tap's B (the
    neck's 1x1 B once a block, 132 blocks). The design before it
    (``conv_gemm.cuh::mainloop_bf16``): every block of 128 pixels (the
    neck's 1x1: 64) reads its shifted A rows and all of its B."""
    npix = b * h * w
    if kind == "heads":
        if tma:
            tiles, chunks = b * -(-h // 8) * -(-w // 16), -(-c // 64)
            return sum(tiles * 4 * chunks * (9 * 17 * 128 + 4 * n * 128) for n in widths)
        tiles = -(-npix // 128)
        return sum(tiles * 4 * (128 * 4 * c * 2 + 4 * c * n * 2) for n in widths)
    c0, cm, co = c
    if tma:
        k0, k1 = -(-c0 // 64), -(-cm // 64)
        return (b * -(-h // 4) * -(-w // 16) * k0 * 64 * 128 + 132 * k0 * 384 * 128
                + b * -(-h // 8) * -(-w // 16) * k1 * (10 * 18 * 128 + 9 * 96 * 128))
    return (-(-npix // 64) * (64 * c0 * 2 + c0 * 384 * 2)
            + -(-npix // 128) * (128 * 9 * cm * 2 + 9 * cm * 96 * 2))


def conv_bf16(which: str, fpn_heads, precise_heads, fpn_neck, gen: torch.Generator, args, card: str) -> None:
    """Rows 2b and 4b (``heads_bf16``) or 3b (``neck_bf16``): the bf16 heads
    or neck at the flagship's shapes, each launch by name, host time a
    call, the L2 read rate, and the cuBLAS yardstick of each product."""
    from adascale_torch.kernels import packing

    tma = hasattr(packing, "pack_sw128")
    cases = []
    if which == "heads_bf16":
        for name, module, shape, outs, wrapper in (
            ("fpn_heads", fpn_heads, ROUGH_SHAPE, ROUGH_OUT, lambda x, heads: fpn_heads.fused_rough_heads(x, *heads)),
            ("precise_heads", precise_heads, PRECISE_SHAPE, PRECISE_OUT, precise_heads.fused_precise_heads),
        ):
            b, h, w, c = shape
            heads = [head_params(c, m, gen) for m in outs]
            x = randn(gen, *shape).to(torch.bfloat16)
            small = randn(gen, 1, 8, 16, c).to(torch.bfloat16)
            tile = 200 if name == "precise_heads" else 192
            nbytes = l2_bytes(tma, "heads", b, h, w, c, [tile] * len(heads))
            products = [(4 * b * h * w, 4 * c, p["step1.conv.weight"].shape[0]) for p in heads]
            cases.append((name, list(shape), HEADS_KERNELS, lambda x=x, heads=heads, wr=wrapper: wr(x, heads),
                          lambda small=small, heads=heads, wr=wrapper: wr(small, heads), nbytes, products))
    else:
        c0, cm, co = NECK_WIDTHS
        for shape in NECK_SHAPES:
            b, h, w = shape
            p = neck_params(c0, cm, co, gen)
            f0, u = randn(gen, *shape, c0).to(torch.bfloat16), randn(gen, *shape, cm).to(torch.bfloat16)
            sf0, su = f0[:, :8, :16].contiguous(), u[:, :8, :16].contiguous()
            nbytes = l2_bytes(tma, "neck", b, h, w, (c0, cm, co), ())
            products = [(b * h * w, c0, cm), (b * h * w, 9 * cm, co)]
            cases.append(("fpn_neck_l0", [*shape, c0, cm, co], NECK_KERNELS,
                          lambda f0=f0, u=u, p=p: fpn_neck.fused_neck_l0(f0, u, p),
                          lambda f0=sf0, u=su, p=p: fpn_neck.fused_neck_l0(f0, u, p), nbytes, products))
    for name, shape, patterns, fn, small, nbytes, products in cases:
        kernel, launches, other = device_ms(fn, args.reps, patterns)
        print(json.dumps({
            "label": args.label, "kernel": f"{name}_bf16", "shape": shape,
            "call_ms": call_ms(fn, args.reps), "kernel_ms": kernel, "launches_ms": launches,
            "other_device_ms": other, "host_us_per_call": wrapper_host_us(small),
            "l2_read_bytes": nbytes, "l2_read_tb_per_s": nbytes / (kernel * 1e-3) / 1e12, "card": card,
        }), flush=True)
        yard = []
        for m, k, n in products:
            a = randn(gen, m, k).to(torch.bfloat16)
            bm = randn(gen, k, n, scale=k ** -0.5).to(torch.bfloat16)
            yard.append({"m": m, "k": k, "n": n, "ms": call_ms(lambda a=a, bm=bm: torch.matmul(a, bm), args.reps)})
            del a, bm
        print(json.dumps({"label": args.label, "yardstick": "cublas_bf16_matmul", "kernel": f"{name}_bf16",
                          "shape": shape, "products": yard, "sum_ms": sum(y["ms"] for y in yard), "card": card}),
              flush=True)


def forwards_bf16(gen: torch.Generator, args, card: str) -> None:
    """The flagship's fused bf16 rough and precise forwards (the engine's
    ``_forward``, as ``chip_smoke.py`` times them) at B = 1 and B = 16, on
    random inputs of page_0's shapes: CUDA events, warm, the median of
    three runs."""
    from adascale_torch import AdaptiveScalingConfig, AdaptiveScalingInference, AdaptiveScalingInferenceConfig
    from adascale_torch.utils.params import load_npz

    cfg = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(size="tiny", neck_head_type="fpn"), compute_dtype="bfloat16",
        use_pallas_backbone=True, use_pallas_neck_heads=True, device="cuda",
    )
    engine = AdaptiveScalingInference(cfg, params=load_npz(args.weights))
    with torch.inference_mode():
        for which, shape in (("rough", (1, 960, 768, 3)), ("precise", (1, 1024, 832, 3))):
            x = randn(gen, *shape)
            xb = x.expand(16, *shape[1:]).contiguous()
            one = call_ms(lambda: engine._forward(x, which), args.reps)
            many = call_ms(lambda: engine._forward(xb, which), 2) / 16
            print(json.dumps({"label": args.label, "forward": f"{which}_bf16_fused", "shape": list(shape),
                              "b1_ms": one, "b16_ms_per_page": many, "card": card}), flush=True)


def forwards_tf32(gen: torch.Generator, args, card: str) -> None:
    """The flagship's f32 rough and precise forwards inside
    ``matmul_precision("default")``, module path and fused, at B = 1 and B
    = 16, on random inputs of page_0's shapes: CUDA events, warm, the median
    of three runs."""
    from adascale_torch import AdaptiveScalingConfig, AdaptiveScalingInference, AdaptiveScalingInferenceConfig
    from adascale_torch.utils.params import load_npz

    params = load_npz(args.weights)
    for fused in (False, True):
        cfg = AdaptiveScalingInferenceConfig(
            model=AdaptiveScalingConfig(size="tiny", neck_head_type="fpn"), use_pallas_neck_heads=fused,
            device="cuda",
        )
        engine = AdaptiveScalingInference(cfg, params=params)
        for which, shape in (("rough", (1, 960, 768, 3)), ("precise", (1, 1024, 832, 3))):
            x = randn(gen, *shape)
            xb = x.expand(16, *shape[1:]).contiguous()
            with torch.inference_mode():
                one = call_ms(at_default(lambda: engine._forward(x, which)), args.reps)
                many = call_ms(at_default(lambda: engine._forward(xb, which)), 2) / 16
            print(json.dumps({"label": args.label, "forward": f"{which}_tf32_{'fused' if fused else 'module'}",
                              "shape": list(shape), "b1_ms": one, "b16_ms_per_page": many, "card": card}),
                  flush=True)


# --only forwards: rounds of each route, alternately; the median is kept.
FORWARD_ROUNDS = 5


def forwards(convnext_block, gen: torch.Generator, args, card: str) -> None:
    """The flagship's eager forwards in four configurations at B = 1 and 16
    (CUDA events, warm, the median of ``FORWARD_ROUNDS`` rounds of
    ``call_ms``) and the block's host time a call, each as one JSON line
    with a value a route: ``wrapper`` (the checkout's ``convnext_block``)
    and, on a checkout with the block operator, ``operator`` (the mode
    chosen as the wrapper chooses it, then the operator, without the
    wrapper's checks)."""
    from adascale_torch import AdaptiveScalingConfig, AdaptiveScalingInference, AdaptiveScalingInferenceConfig
    from adascale_torch.models import convnext
    from adascale_torch.utils.params import load_npz

    routes = {"wrapper": convnext_block.convnext_block}
    if hasattr(torch.ops.adascale_torch, "convnext_block"):
        op, names = torch.ops.adascale_torch.convnext_block, convnext_block.PARAM_NAMES

        def operator(x, p, compute_dtype=torch.float32):
            if compute_dtype == torch.float32:
                mode = convnext_block.MODE_F32
            else:
                mode = convnext_block.MODE_BF16_MODULE if x.dtype == torch.float32 else convnext_block.MODE_BF16
            return op(x, *(p[n] for n in names), mode)

        routes["operator"] = operator

    def by_route(fn, reps):
        runs = {route: [] for route in routes}
        for _ in range(FORWARD_ROUNDS):
            for route, block in routes.items():
                convnext.convnext_block = block
                runs[route].append(call_ms(fn, reps))
        convnext.convnext_block = routes["wrapper"]
        return {route: statistics.median(v) for route, v in runs.items()}

    params = load_npz(args.weights)
    model = AdaptiveScalingConfig(size="tiny", neck_head_type="fpn")
    inputs = {which: randn(gen, *shape, scale=60.0, shift=128.0)
              for which, shape in (("rough", (1, 960, 768, 3)), ("precise", (1, 1024, 832, 3)))}
    for dtype in ("float32", "bfloat16"):
        for fused in (False, True):
            engine = AdaptiveScalingInference(AdaptiveScalingInferenceConfig(
                model=model, compute_dtype=dtype, use_pallas_backbone=True, use_pallas_neck_heads=fused,
                device="cuda"), params=params)
            with torch.inference_mode():
                for which, x in inputs.items():
                    xb = x.expand(16, *x.shape[1:]).contiguous()
                    launches = convnext_block.LAUNCHES + convnext_block.LAUNCHES_BF16
                    engine._forward(x, which)
                    ran = convnext_block.LAUNCHES + convnext_block.LAUNCHES_BF16 - launches
                    one = by_route(lambda: engine._forward(x, which), args.reps)
                    many = by_route(lambda: engine._forward(xb, which), 1)
                    print(json.dumps({
                        "label": args.label,
                        "forward": f"{which}_{'bf16' if dtype == 'bfloat16' else 'f32'}_{'fused' if fused else 'module'}",
                        "shape": list(x.shape), "b1_ms": one,
                        "b16_ms_per_page": {route: v / 16 for route, v in many.items()},
                        "block_launches": ran, "card": card}), flush=True)
            del engine
    p, x32 = block_params(96, gen), randn(gen, 1, 8, 8, 96)
    xb16 = x32.to(torch.bfloat16)
    host = {}
    with torch.inference_mode():
        for route, block in routes.items():
            host[route] = {
                "f32": host_us(lambda: block(x32, p), 2000),
                "bf16_pallas": host_us(lambda: block(xb16, p, torch.bfloat16), 2000),
                "bf16_module": host_us(lambda: block(x32, p, torch.bfloat16), 2000),
            }
    torch.cuda.synchronize()
    print(json.dumps({"label": args.label, "block_host_us_per_call": host,
                      "shape": [1, 8, 8, 96], "card": card}), flush=True)


# The L2 read-rate probe: every thread XORs the 16-byte words it reads
# (ld.global.cg: cached in L2, not in L1), `reps` passes over the buffer.
L2_READ_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void l2_read_kernel(const uint4* __restrict__ p, long long n, int reps, unsigned* out) {
  unsigned acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int r = 0; r < reps; ++r)
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += stride) {
      const uint4 v = __ldcg(p + i);
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  if (acc == 0x9e3779b9u) out[0] = acc;
}
extern "C" int l2_read(const void* p, long long n, int reps, unsigned* out, int blocks, cudaStream_t s) {
  l2_read_kernel<<<blocks, 512, 0, s>>>(static_cast<const uint4*>(p), n, reps, out);
  return (int)cudaGetLastError();
}
"""


def l2_rate(args, card: str) -> None:
    """The read rate from L2 and from device memory: L2_READ_SOURCE over a
    buffer that stays in the 50 MB L2, 64 passes a call, and over a 1 GB
    buffer, one pass; CUDA events over back-to-back warm calls; bytes read
    a second."""
    import ctypes
    import shutil

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "l2_read.cu"), os.path.join(out_dir, "libl2_read.so")
    with open(src, "w") as f:
        f.write(L2_READ_SOURCE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.l2_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_void_p]
    lib.l2_read.restype = ctypes.c_int
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    for mb in (8, 16, 24, 1024):
        buf = torch.randint(0, 1 << 30, (mb * (1 << 20) // 4,), dtype=torch.int32, device="cuda")
        reps = 1 if mb > 48 else 64
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            rc = lib.l2_read(buf.data_ptr(), buf.numel() // 4, reps, out.data_ptr(), blocks, stream)
            if rc:
                raise RuntimeError(f"l2_read: CUDA error {rc}")

        ms = call_ms(run, 20)
        print(json.dumps({"label": args.label, "buffer_mb": mb, "reads": reps, "ms": ms,
                          "read_tb_per_s": reps * buf.numel() * 4 / (ms * 1e-3) / 1e12, "card": card}),
              flush=True)
        del buf


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
