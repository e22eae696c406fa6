"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each announced with its elapsed seconds:

  1. device: the card's name, count and power limit (nvidia-smi);
  2. build: nvcc builds the four kernel libraries from the sources in this
     checkout, one nvcc each, all started together; prints each build's
     seconds and the ptxas register, shared-memory and spill report;
  3. kernels: the ConvNeXt-block kernel against its plain PyTorch version on
     the card at the shapes the main path gives it (the four stage shapes of
     the rough pass of a 1024x768 page and of its precise stack, 1024x832),
     a ragged one and the widths the main path does not reach (C = 8, 1024,
     1536), f32, relative error <= 1e-5; kernel and plain times from CUDA
     events (warm); each of the kernel's launches (depthwise + LN, GEMM 1,
     GEMM 2) timed from a torch.profiler trace, with the GEMM kernels'
     names, which name their inner product;
  3b. the same for the FPN neck level-0, rough-heads and precise-heads
     kernels (all three 3xTF32 wgmma), at the flagship's shapes (neck at
     240x192 and 256x208, rough heads at 240x192x384, precise heads at
     256x208x384) and a ragged micro shape each (13x19, neck widths
     8/32/8, head widths 16..18); each also against an f64 evaluation of
     the plain version (rel_vs_f64, for the kernel and the plain version),
     with bound_ms at the 3xTF32 rate and bound_f32_simt_ms beside it, and
     the time to pack its weights (once per parameter set; the kernel is
     timed with the packing cached); the neck's two launches (step1, step2)
     timed apart from a torch.profiler trace;
  4. detect: the default path, ``AdaptiveScalingInference.detect()`` with
     the tiny/FPN flagship weights on a committed page, held against the JAX
     package's stored output (tests/fixtures/torch_port/
     flagship_fpn_reference.npz): rough mask agreement >= 99.5 %, and >= 95 %
     of char polygons matched one-to-one at IoU >= 0.5 both ways. Kernel
     launch counts are read from this run. Then warm timings of the rough
     and precise forwards and of detect();
  5. fused detect: the same with ``use_pallas_neck_heads=True`` (neck level
     0 and the heads through their kernels), the same bars, exact launch
     counts of all four kernels, the fused forwards against the module
     path's (relative error <= 1e-4) and their warm timings beside it, and
     each fused forward's device time by kernel from a torch.profiler
     trace; three warm fused detect() calls build no weight pack;
  6. multi-chunk detect: the fused configuration with a small
     ``precise_stacked_image_max_area``, so that the page's regions make
     several precise stacks, against its JAX reference (the same bars; the
     same number of chunks; launches exactly 18 x (1 + chunks) blocks);
  7. blank page: the fused configuration on a page with no text against its
     JAX reference (no char polygons; the same stacked shape and chunks);
  8. training, the two-task train step with the flagship (f32, B = 6 at the
     training shapes: 512x512 rough crops, 320x320 precise crops, 200 label
     points):
     8a. the trainable block (``TrainableBlock``: kernel forward, backward
         by recompute and autograd of the plain version) against autograd
         through the plain version at the 8 training stage shapes: forward
         and the gradients of x and the 9 parameters within 1e-5 relative;
         forward, plain forward and backward ms from CUDA events; a raw
         ``convnext_block`` call that needs a gradient goes through it;
     8b. the flagship's two-task loss, gradients and one optimizer step at
         B = 2, deterministic, against the JAX package's stored step
         (tests/fixtures/torch_port/flagship_fpn_train_reference.npz, the
         batch regenerated and checked by checksum): losses and the global
         gradient norm within 1e-4 relative, each leaf's gradient norm and
         projection within 1e-3 of its norm and 64 strided elements of it
         within 1e-3 of its largest magnitude; the update's norm and
         projection within 1e-3 of its norm (its elements printed);
     8c. 3 warm-up and 5 timed ``train_step`` calls with drop path on from a
         seeded generator: finite losses, every parameter moved, exactly 36
         block-kernel launches a step; ms per step, samples/s, peak memory;
         one step's device time by part from a torch.profiler trace, which
         also shows that every depthwise convolution of the plain version
         ran inside the blocks' backward, and the plain version's block
         forwards traced in the same place (the kernels line's times); the fused forwards of the trained
         model against its module path (1e-4; the weight packs rebuilt);
         one step with remat against one without (losses within 1e-6,
         72 launches).

The second-to-last line is a JSON object describing each kernel, the last
line ``{"ok": true, "device": {...}}``. Any failure raises and the script
exits non-zero without those lines. Without a CUDA device it exits non-zero
at once.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import json
import os
import re
import statistics
import subprocess
import time

T0 = time.perf_counter()

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "examples/flagship_training/flagship_fpn_params.f16.npz")
FIXTURES = os.path.join(ROOT, "tests/fixtures/torch_port")
REFERENCE = os.path.join(FIXTURES, "flagship_fpn_reference.npz")
MULTICHUNK_REFERENCE = os.path.join(FIXTURES, "flagship_fpn_multichunk_reference.npz")
BLANK_REFERENCE = os.path.join(FIXTURES, "flagship_fpn_blank_reference.npz")
TRAIN_REFERENCE = os.path.join(FIXTURES, "flagship_fpn_train_reference.npz")

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 without tensor cores, dense
# TF32 on the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
REL_TOL = 1e-5
# Fused forwards against the module path: same function, other summation
# order and phase-collapsed taps; the JAX tests hold the pair at 2e-5.
FORWARD_REL_TOL = 1e-4
# Rough pass of a 1024x768 page (resized 960x720, padded 960x768): the block
# shapes of the four stages and the number of blocks run at each.
STAGE_SHAPES = [((240, 192, 96), 3), ((120, 96, 192), 3), ((60, 48, 384), 9), ((30, 24, 768), 3)]
# Precise pass of the same page: its one 1024x832 stack.
PRECISE_STAGE_SHAPES = [
    ((256, 208, 96), 3), ((128, 104, 192), 3), ((64, 52, 384), 9), ((32, 26, 768), 3),
]
RAGGED_SHAPE = (13, 19, 96)
# Widths the main path does not reach: the micro fixture's C = 8 and the
# base / large presets' last stages (C = 1024, 1536).
EXTRA_BLOCK_SHAPES = [(16, 16, 8), (16, 12, 1024), (16, 12, 1536)]
# Neck level 0 (H, W, C0, Cm, Co) and head inputs (H, W, C), with the number
# of calls one one-chunk detect() makes at each: the flagship's rough and
# precise (page_0's stack) shapes, then a ragged micro one.
NECK_SHAPES = [((240, 192, 96, 384, 96), 1), ((256, 208, 96, 384, 96), 1), ((13, 19, 8, 32, 8), 0)]
ROUGH_HEAD_SHAPES = [((240, 192, 384), 1), ((13, 19, 32), 0)]
PRECISE_HEAD_SHAPES = [((256, 208, 384), 1), ((13, 19, 32), 0)]
PRECISE_OUT = (1, 2, 4, 4)  # prob, offset, angle, distance
# Training (examples/flagship_training/steps.json, epoch.json): B = 6, rough
# crops 512x512 and precise crops 320x320, so the stage shapes of the two
# passes and the blocks run at each.
TRAIN_BATCH = 6
TRAIN_STAGE_SHAPES = [
    ((128, 128, 96), 3), ((64, 64, 192), 3), ((32, 32, 384), 9), ((16, 16, 768), 3),
    ((80, 80, 96), 3), ((40, 40, 192), 3), ((20, 20, 384), 9), ((10, 10, 768), 3),
]
# The flagship step against the JAX reference: f32 on both sides, other
# summation orders through 35.6 M parameters.
TRAIN_LOSS_TOL = 1e-4
LEAF_TOL = 1e-3
REMAT_TOL = 1e-6
WARMUP_STEPS, TIMED_STEPS = 3, 5


def stamp(phase: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 10) -> float:
    """Milliseconds of one call of ``fn`` on the current stream, warm: CUDA
    events around ``reps`` calls in a row, divided by ``reps``; the median of
    three such runs. Back-to-back calls let the host enqueue the next call
    while the card runs the last, so a call's host overhead counts only
    where it is longer than its device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / reps)
    return statistics.median(runs)


def block_bound_ms(npix: int, c: int):
    """(ops_ms, bytes_ms, f32_simt_ms) for one block. Operations as the
    kernel computes them: the two projections as three TF32 products each
    on the tensor cores, the depthwise at the f32 peak. Bytes: each input
    (activation and weights) read once and the output written once at the
    memory rate. The last is the operations bound at the f32 SIMT peak
    alone, for comparison."""
    mlp, dw = npix * 16 * c * c, npix * 2 * 49 * c
    nbytes = 4 * (2 * npix * c + 49 * c + 8 * c * c + 4 * c + 6 * c)
    return (
        (3 * mlp / PEAK_TF32_FLOPS + dw / PEAK_F32_FLOPS) * 1e3,
        nbytes / PEAK_BYTES * 1e3,
        (mlp + dw) / PEAK_F32_FLOPS * 1e3,
    )


def random_block_params(c: int, gen, device):
    import torch

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device)

    return {
        "dwconv.weight": r(c, 1, 7, 7, scale=0.1),
        "dwconv.bias": r(c, scale=0.1),
        "ln.weight": r(c, scale=0.1, shift=1.0),
        "ln.bias": r(c, scale=0.1),
        "mlp_up.weight": r(4 * c, c, scale=c ** -0.5),
        "mlp_up.bias": r(4 * c, scale=0.1),
        "mlp_down.weight": r(c, 4 * c, scale=(4 * c) ** -0.5),
        "mlp_down.bias": r(c, scale=0.1),
        "block_scale": torch.rand(c, generator=gen).to(device),
    }


def random_neck_params(c0: int, cm: int, co: int, gen, device):
    import torch

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device)

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


def random_head_params(c: int, m: int, gen, device):
    """An FpnHead's parameters; inner width (c + m) // 2 as the model has it."""
    import torch

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


def neck_work(b: int, h: int, w: int, c0: int, cm: int, co: int):
    """(flops, bytes) of the level-0 chain: the step1 and 3x3 products; f0
    and u read, z0 written, the weights read once."""
    npix = b * h * w
    flops = npix * (2 * c0 * cm + 2 * 9 * cm * co)
    nbytes = 4 * (npix * (c0 + cm + co) + c0 * cm + 9 * cm * co + 3 * cm + 3 * co)
    return flops, nbytes


def heads_work(b: int, h: int, w: int, c: int, heads):
    """(flops, bytes) of FpnHeads over one (B, H, W, C) input at the
    phase-collapsed form: 4 phases x 4 taps x C x F per low-resolution
    pixel and head, plus the projections; x read, the (B, 2H, 2W, M) maps
    written, the collapsed taps read once."""
    npix = b * h * w
    fsum = sum(p["step1.conv.weight"].shape[0] for p in heads)
    fm = sum(p["step2.weight"].shape[0] * p["step2.weight"].shape[1] for p in heads)
    mtot = sum(p["step2.weight"].shape[0] for p in heads)
    flops = npix * 4 * (2 * 4 * c * fsum + 2 * fm)
    nbytes = 4 * (npix * c + 4 * npix * mtot + 16 * c * fsum + 3 * fsum + fm + mtot)
    return flops, nbytes


def check_kernel(label: str, kernel, plain, args, exact_args, work, reps: int = 10):
    """The kernel against its plain version on the same inputs; raises past
    REL_TOL. Prints and returns max_abs_err, kernel and plain ms, the
    operations at the 3xTF32 rate (three TF32 products a product at the
    dense TF32 peak) and the bytes (each input read once, each output
    written once) at the memory rate, in ms, the operations at the f32 SIMT
    peak too (``t_simt``, printed as bound_f32_simt_ms), and how far the
    kernel and the plain version each are from the plain version run on
    ``exact_args`` (the same inputs in f64), relative to its largest value
    (``rel64``)."""
    import torch

    got = kernel(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    exact = plain(*exact_args)
    got, want, exact = ([v] if torch.is_tensor(v) else list(v) for v in (got, want, exact))
    err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    rel = err / max(float(w_.abs().max()) for w_ in want)
    scale = max(float(e.abs().max()) for e in exact)
    rel64 = {
        which: max(float((v.double() - e).abs().max()) for v, e in zip(vals, exact)) / scale
        for which, vals in (("kernel", got), ("plain", want))
    }
    ms = cuda_ms(lambda: kernel(*args), reps)
    plain_ms = cuda_ms(lambda: plain(*args), reps)
    flops, nbytes = work
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    t_simt = flops / PEAK_F32_FLOPS * 1e3
    bound, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    print(
        f"{label}: max_abs_err={err:.3e} rel={rel:.3e} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({by}, 3xTF32) bound_f32_simt_ms={t_simt:.4f} "
        f"rel_vs_f64 kernel={rel64['kernel']:.3e} plain={rel64['plain']:.3e}",
        flush=True,
    )
    if not rel <= REL_TOL:
        raise AssertionError(f"{label}: relative error {rel} > {REL_TOL}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "t_ops": t_ops, "t_bytes": t_bytes,
            "rel64": rel64}


def kernel_device_ms(fn, reps: int = 10):
    """Device ms per call of each kernel that ``fn`` runs on the card, by its
    name in a torch.profiler trace of ``reps`` warm calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for event in prof.key_averages():
        if event.device_type == DeviceType.CUDA:  # host-side entries carry their kernels' time too
            ms[event.key] = ms.get(event.key, 0.0) + event.device_time_total / 1e3 / reps
    return ms


def block_launch_ms(x, p, reps: int = 10):
    """Device ms per call of each of the block kernel's launches, read from a
    torch.profiler trace of ``reps`` whole calls: the depthwise + LN, GEMM 1
    and GEMM 2 (with its split-K reduction, where it has one). Also returns
    the names of the GEMM kernels that ran, which name their inner product
    (``gemm_3xtf32_kernel<columns, epilogue>``; epilogue 0 is GEMM 1's GELU,
    1 GEMM 2's residual, 2 GEMM 2's split partials)."""
    from adascale_torch.kernels import convnext_block as K

    part_ms, gemms = {"dw_ln": 0.0, "gemm1": 0.0, "gemm2": 0.0}, []
    for key, ms in kernel_device_ms(lambda: K.convnext_block(x, p), reps).items():
        gemm = re.search(r"(gemm_\w+_kernel)<(\d+), (\d)>", key)
        if "dw_ln_kernel" in key:
            part = "dw_ln"
        elif gemm:
            part = "gemm1" if gemm.group(3) == "0" else "gemm2"
            gemms.append(f"{gemm.group(1)}<{gemm.group(2)},{gemm.group(3)}>")
        elif "reduce_kernel" in key:
            part = "gemm2"
            gemms.append("reduce_kernel")
        else:
            continue
        part_ms[part] += ms
    if not all(part_ms.values()):
        raise AssertionError(f"block launches missing from the trace: {part_ms}")
    return part_ms, sorted(gemms)


def check_blocks(gen, device):
    """Phase 3: the block kernel against its plain version at every stage
    shape of both passes and at the extra widths; each shape's launches
    (depthwise + LN, GEMM 1, GEMM 2 with its reduction) timed from a trace
    too. Returns the entries of the kernels line: times and bounds summed
    over the 18 blocks of each pass and over both passes."""
    import torch

    from adascale_torch.kernels import convnext_block as K

    passes = {"rough": STAGE_SHAPES, "precise": PRECISE_STAGE_SHAPES}
    cases = [(shape, which, n) for which, shapes in passes.items() for shape, n in shapes]
    cases += [(RAGGED_SHAPE, None, 0)] + [(shape, None, 0) for shape in EXTRA_BLOCK_SHAPES]
    keys = ("ms", "plain_ms", "t_ops", "t_bytes", "simt")
    sums = {k: dict.fromkeys(keys, 0.0) for k in passes}
    max_abs_err, gemm_kernels = 0.0, set()
    for (h, w, c), which, blocks in cases:
        p = random_block_params(c, gen, device)
        x = torch.randn(1, h, w, c, generator=gen).to(device)
        got = K.convnext_block(x, p)
        torch.cuda.synchronize()
        want = K.convnext_block_plain(x, p)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        # Both against the same function in f64: how far each is from exact.
        exact = K.convnext_block_plain(x.double(), {k: v.double() for k, v in p.items()})
        scale = float(exact.abs().max())
        rel64 = {k: float((v.double() - exact).abs().max()) / scale for k, v in (("kernel", got), ("plain", want))}
        ms = cuda_ms(lambda: K.convnext_block(x, p))
        plain_ms = cuda_ms(lambda: K.convnext_block_plain(x, p))
        part_ms, gemms = block_launch_ms(x, p)
        gemm_kernels.update(gemms)
        t_ops, t_bytes, simt = block_bound_ms(h * w, c)
        bound, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        print(
            f"convnext_block {h}x{w}x{c}: max_abs_err={err:.3e} rel={rel:.3e} "
            f"rel_vs_f64 kernel={rel64['kernel']:.3e} plain={rel64['plain']:.3e} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({by}, 3xTF32) "
            f"bound_f32_simt_ms={simt:.4f} "
            + " ".join(f"{name}_ms={v:.4f}" for name, v in part_ms.items())
            + f" kernels={'+'.join(gemms)} pass={which} blocks_per_pass={blocks}",
            flush=True,
        )
        if not rel <= REL_TOL:
            raise AssertionError(f"convnext_block {h}x{w}x{c}: relative error {rel} > {REL_TOL}")
        max_abs_err = max(max_abs_err, err)
        if which:
            for key, v in zip(keys, (ms, plain_ms, t_ops, t_bytes, simt)):
                sums[which][key] += blocks * v
    for which, t in sums.items():
        print(
            f"convnext_block {which} pass (18 blocks): kernel_ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} bound_ms={max(t['t_ops'], t['t_bytes']):.4f} (3xTF32) "
            f"bound_f32_simt_ms={t['simt']:.4f}",
            flush=True,
        )
    t_ops, t_bytes = (sum(t[key] for t in sums.values()) for key in ("t_ops", "t_bytes"))
    return {
        "max_abs_err": max_abs_err,
        # Summed over the 36 blocks of a one-chunk detect(): both passes.
        "ms": sum(t["ms"] for t in sums.values()),
        "plain_ms": sum(t["plain_ms"] for t in sums.values()),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_rate": "projections as 3 TF32 products at 495 TFLOP/s, depthwise at 67 TFLOP/s f32",
        **{f"{which}_pass_{key}": t[key] for which, t in sums.items() for key in ("ms", "plain_ms")},
        "gemm_kernels": sorted(gemm_kernels),
    }


def build_all():
    """Build the four kernel libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from adascale_torch.kernels import _nvcc, convnext_block, fpn_heads, fpn_neck, precise_heads

    modules = {
        "convnext_block": convnext_block,
        "fpn_neck_l0": fpn_neck,
        "fpn_heads": fpn_heads,
        "precise_heads": precise_heads,
    }
    with ThreadPoolExecutor(len(modules)) as pool:
        for future in [pool.submit(m.build) for m in modules.values()]:
            future.result()
    for name in modules:
        report = _nvcc.BUILD_REPORT[name]
        print(f"build {name}: {report['seconds']:.2f} s (cached={report['cached']})", flush=True)
        for line in str(report["ptxas"]).splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "entry function" in line:
                print("ptxas:", line.strip(), flush=True)


def pack_ms(pack) -> float:
    """Host-clock ms of ``pack()``, packing one parameter set for its kernel
    (median of 3, synchronised): what a call pays once per parameter set."""
    import torch

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pack()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return statistics.median(walls)


def neck_launch_ms(f0, u, p):
    """Device ms per call of the neck kernel's two launches (step1: the 1x1
    + LN + GELU + u; step2: the 3x3 + LN + GELU), from a trace of 10 calls."""
    from adascale_torch.kernels import fpn_neck

    parts = {"step1": 0.0, "step2": 0.0}
    for key, ms in kernel_device_ms(lambda: fpn_neck.fused_neck_l0(f0, u, p)).items():
        for part in parts:
            if f"neck_{part}_kernel" in key:
                parts[part] += ms
    if not all(parts.values()):
        raise AssertionError(f"neck launches missing from the trace: {parts}")
    return parts


def check_neck_and_heads(gen, device):
    """Phase 3b: the neck and head kernels against their plain versions and
    an f64 evaluation, with their bounds at the 3xTF32 rate they compute at
    and their packing time; the neck's two launches apart. Returns per
    kernel the entries of the kernels line (times and bounds summed over one
    one-chunk detect()'s calls)."""
    import torch

    from adascale_torch.kernels import fpn_heads, fpn_neck, precise_heads

    def total(rows):
        t_ops = sum(n * r["t_ops"] for r, n in rows)
        t_bytes = sum(n * r["t_bytes"] for r, n in rows)
        return {
            "max_abs_err": max(r["max_abs_err"] for r, _ in rows),
            "ms": sum(n * r["ms"] for r, n in rows),
            "plain_ms": sum(n * r["plain_ms"] for r, n in rows),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_rate": "3 TF32 products a product at 495 TFLOP/s",
            "rel_vs_f64": {
                which: max(r["rel64"][which] for r, _ in rows) for which in ("kernel", "plain")
            },
            "pack_ms": sum(r.get("pack_ms", 0.0) for r, _ in rows),
        }

    def double(params):
        return {k: v.double() for k, v in params.items()}

    rows = []
    for (h, w, c0, cm, co), calls in NECK_SHAPES:
        p = random_neck_params(c0, cm, co, gen, device)
        f0 = torch.randn(1, h, w, c0, generator=gen).to(device)
        u = torch.randn(1, h, w, cm, generator=gen).to(device)
        label = f"fpn_neck_l0 {h}x{w} {c0}->{cm}->{co}"
        r = check_kernel(
            label, fpn_neck.fused_neck_l0, fpn_neck.fused_neck_l0_plain, (f0, u, p),
            (f0.double(), u.double(), double(p)), neck_work(1, h, w, c0, cm, co),
        )
        rows.append((r, calls))
        if calls:
            parts = neck_launch_ms(f0, u, p)
            r["pack_ms"] = pack_ms(lambda: fpn_neck.pack_neck(p))
            print(
                f"{label} launches, device ms a call (torch.profiler, 10 calls): "
                + " ".join(f"{k}_ms={v:.4f}" for k, v in parts.items())
                + f"; packing, once per parameter set: pack_ms={r['pack_ms']:.4f}",
                flush=True,
            )
    neck = total(rows)

    heads_rows = {}
    for name, module, shapes, outs in (
        ("fpn_heads", fpn_heads, ROUGH_HEAD_SHAPES, (1, 1)),
        ("precise_heads", precise_heads, PRECISE_HEAD_SHAPES, PRECISE_OUT),
    ):
        rows = []
        for (h, w, c), calls in shapes:
            heads = [random_head_params(c, m, gen, device) for m in outs]
            x = torch.randn(1, h, w, c, generator=gen).to(device)
            if module is fpn_heads:
                kernel, plain = fpn_heads.fused_rough_heads, fpn_heads.fused_rough_heads_plain
                args, exact_args = (x, *heads), (x.double(), *map(double, heads))
            else:
                kernel, plain = precise_heads.fused_precise_heads, precise_heads.fused_precise_heads_plain
                args, exact_args = (x, heads), (x.double(), [double(p) for p in heads])
            r = check_kernel(
                f"{name} {h}x{w}x{c}", kernel, plain, args, exact_args, heads_work(1, h, w, c, heads),
            )
            rows.append((r, calls))
            if calls:
                width = getattr(module.build(), f"{name}_max_width")()
                r["pack_ms"] = pack_ms(lambda: fpn_heads.pack_heads(heads, width))
                print(f"{name} {h}x{w}x{c} packing, once per parameter set: pack_ms={r['pack_ms']:.4f}",
                      flush=True)
        heads_rows[name] = total(rows)
    return neck, heads_rows["fpn_heads"], heads_rows["precise_heads"]


def check_against_reference(result, ref, extra: str) -> None:
    """detect()'s output against the JAX package's stored output: rough mask
    agreement >= 99.5 % and >= 95 % of polygons matched at IoU >= 0.5 both
    ways."""
    from adascale_torch.data.geometry import Polygon
    from adascale_torch.inference.eval import match_polygons

    mask = result["rough"].rough_char_mask
    ref_mask = ref["rough_char_mask"]
    if mask.shape != ref_mask.shape:
        raise AssertionError(f"rough mask shape {mask.shape} != reference {ref_mask.shape}")
    agreement = float((mask == ref_mask).mean())
    ours = result["char_polygons"]
    theirs = [Polygon(p) for p in ref["char_polygons"]]
    matched = len(match_polygons(ours, theirs, 0.5))
    # Two empty sets agree (a blank page).
    ref_recall = matched / len(theirs) if theirs else float(not ours)
    port_precision = matched / len(ours) if ours else float(not theirs)
    print(
        f"rough mask agreement={agreement:.6f} polygons port={len(ours)} jax={len(theirs)} "
        f"matched@0.5={matched} ({ref_recall:.4f} of jax, {port_precision:.4f} of port) "
        f"regions port={len(result['regions'])} jax={int(ref['num_regions'])} "
        f"num_precise_chunks={result['num_precise_chunks']} (jax {int(ref['num_precise_chunks'])}) "
        f"{extra}",
        flush=True,
    )
    if agreement < 0.995:
        raise AssertionError(f"rough mask agreement {agreement} < 0.995")
    if ref_recall < 0.95 or port_precision < 0.95:
        raise AssertionError(f"polygon match {ref_recall}/{port_precision} < 0.95")


def fused_detect_checked(engine, image, ref, blocks_per_pass: int, min_chunks: int = 1):
    """One counted detect() of a ``use_pallas_neck_heads=True`` engine, held
    against a JAX reference; the launches of all four kernels must be exactly
    what its precise chunks need, and the chunk count the reference's.
    Returns the result and the launch counts."""
    import torch

    from adascale_torch.kernels import convnext_block, fpn_heads, fpn_neck, precise_heads

    modules = {
        "convnext_block": convnext_block,
        "fpn_neck_l0": fpn_neck,
        "fpn_heads": fpn_heads,
        "precise_heads": precise_heads,
    }
    for m in modules.values():
        m.LAUNCHES = 0
    result = engine.detect(image)
    torch.cuda.synchronize()
    launches = {name: m.LAUNCHES for name, m in modules.items()}
    chunks = result["num_precise_chunks"]
    want = {
        "convnext_block": blocks_per_pass * (1 + chunks),
        "fpn_neck_l0": 1 + chunks,
        "fpn_heads": 1,
        "precise_heads": chunks,
    }
    stamp("fused detect() done; comparing with the JAX reference")
    check_against_reference(result, ref, f"LAUNCHES={launches}")
    if launches != want:
        raise AssertionError(f"LAUNCHES {launches} != {want}")
    if chunks != int(ref["num_precise_chunks"]) or chunks < min_chunks:
        raise AssertionError(f"{chunks} precise chunks; reference {int(ref['num_precise_chunks'])}")
    return result, launches


# Kernel-name patterns of the port's kernels in a profiler trace.
KERNEL_GROUPS = {
    "heads": ("heads_kernel",),
    "neck_l0": ("neck_step1_kernel", "neck_step2_kernel"),
    "blocks": ("dw_ln_kernel", "gemm_3xtf32_kernel", "reduce_kernel"),
}


def kernel_group(name: str):
    """The ``KERNEL_GROUPS`` entry a traced kernel's name belongs to, or
    None. PyTorch's own kernels (``at::native::reduce_kernel`` among them)
    belong to none."""
    if "at::native" in name:
        return None
    return next((g for g, keys in KERNEL_GROUPS.items() if any(k in name for k in keys)), None)


def forward_device_ms(fn, reps: int = 3):
    """Device ms per call of ``fn`` by kernel group, from a torch.profiler
    trace of ``reps`` warm calls: the port's kernels (``KERNEL_GROUPS``),
    everything else the card ran (``other``: library convolutions, norms,
    copies) and their sum (``device``)."""
    parts = dict.fromkeys([*KERNEL_GROUPS, "other"], 0.0)
    for key, ms in kernel_device_ms(fn, reps).items():
        parts[kernel_group(key) or "other"] += ms
    parts["device"] = sum(parts.values())
    return parts


def detect_wall_ms(engine, image) -> float:
    """Median host-clock ms of three warm detect() calls."""
    import torch

    walls = []
    for _ in range(3):
        t = time.perf_counter()
        engine.detect(image)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return statistics.median(walls)


def print_detect_steps(engine, image) -> None:
    """Where one detect() spends its wall time (host clock; device work ends
    in a host copy inside rough_infer / precise_infer)."""
    steps = {}
    t = time.perf_counter()
    rough = engine.rough_infer(image)
    steps["rough_infer"], t = time.perf_counter() - t, time.perf_counter()
    regions = engine.build_flattened_text_regions(image, rough)
    steps["flatten_regions"], t = time.perf_counter() - t, time.perf_counter()
    stacked, boxes = engine.stack_flattened_text_regions(regions)
    steps["stack"], t = time.perf_counter() - t, time.perf_counter()
    precise = engine.precise_infer(stacked)
    steps["precise_infer"], t = time.perf_counter() - t, time.perf_counter()
    grouped = engine.precise_build_grouped_polygons(precise, regions, boxes)
    remapped = engine.precise_build_remapped_polygons(regions, boxes, grouped)
    steps["build_polygons"], t = time.perf_counter() - t, time.perf_counter()
    engine.dedup_char_polygons(remapped)
    steps["nms"] = time.perf_counter() - t
    print("detect() steps (ms): " + ", ".join(f"{k}={v * 1e3:.1f}" for k, v in steps.items()), flush=True)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def check_trainable_block(gen, device):
    """Phase 8a: ``TrainableBlock`` against autograd through the plain
    version at the training stage shapes, each shape timed alone; returns
    the kernels line's errors and bound (the bound summed over one train
    step's 36 block forwards; the times come from phase 8c's traced step)."""
    import torch

    from adascale_torch.kernels import convnext_block as K

    names = ("x",) + K.PARAM_NAMES
    totals = dict.fromkeys(("t_ops", "t_bytes"), 0.0)
    worst, max_abs = (0.0, ""), 0.0
    for (h, w, c), blocks in TRAIN_STAGE_SHAPES:
        p = {k: v.requires_grad_() for k, v in random_block_params(c, gen, device).items()}
        x = torch.randn(TRAIN_BATCH, h, w, c, generator=gen).to(device).requires_grad_()
        g = torch.randn(TRAIN_BATCH, h, w, c, generator=gen).to(device)
        inputs = [x] + [p[k] for k in K.PARAM_NAMES]
        out = K.TrainableBlock.apply(*inputs)
        want = K.convnext_block_plain(x, p)
        errs = {"forward": rel_err(out.detach(), want.detach())}
        max_abs = max(max_abs, float((out - want).detach().abs().max()))
        got_grads = torch.autograd.grad(out, inputs, g, retain_graph=True)
        want_grads = torch.autograd.grad(want, inputs, g, retain_graph=True)
        errs.update({f"d{n}": rel_err(a, b) for n, a, b in zip(names, got_grads, want_grads)})
        bad = {k: v for k, v in errs.items() if not v <= REL_TOL}
        if bad:
            raise AssertionError(f"trainable block {h}x{w}x{c}: relative errors {bad} > {REL_TOL}")
        xd, pd = x.detach(), {k: v.detach() for k, v in p.items()}
        ms = cuda_ms(lambda: K.convnext_block(xd, pd))
        plain_ms = cuda_ms(lambda: K.convnext_block_plain(xd, pd))
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, inputs, g, retain_graph=True))
        plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(want, inputs, g, retain_graph=True))
        t_ops, t_bytes, _ = block_bound_ms(TRAIN_BATCH * h * w, c)
        name, err = max(errs.items(), key=lambda kv: kv[1])
        worst = max(worst, (err, f"{h}x{w}x{c} {name}"))
        print(
            f"trainable block B={TRAIN_BATCH} {h}x{w}x{c}: rel err forward={errs['forward']:.3e} "
            f"worst grad {max((k for k in errs if k != 'forward'), key=errs.get)}="
            f"{max(v for k, v in errs.items() if k != 'forward'):.3e}; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"backward_ms={bwd_ms:.4f} (recompute + autograd of the plain version) "
            f"plain_backward_ms={plain_bwd_ms:.4f} bound_ms={max(t_ops, t_bytes):.4f} (3xTF32) "
            f"blocks_per_step={blocks}",
            flush=True,
        )
        totals["t_ops"] += blocks * t_ops
        totals["t_bytes"] += blocks * t_bytes
        del out, want, got_grads, want_grads

    # The repair: a raw call that needs a gradient keeps it.
    (h, w, c), _ = TRAIN_STAGE_SHAPES[-1]
    p = random_block_params(c, gen, device)
    p["block_scale"].requires_grad_()
    before = K.LAUNCHES
    out = K.convnext_block(torch.randn(2, h, w, c, generator=gen).to(device), p)
    if out.grad_fn is None or "TrainableBlock" not in type(out.grad_fn).__name__ or K.LAUNCHES != before + 1:
        raise AssertionError(f"raw convnext_block with a gradient: grad_fn={out.grad_fn}")
    print(f"raw convnext_block call needing a gradient: grad_fn={type(out.grad_fn).__name__}, "
          f"one kernel launch", flush=True)
    print(
        f"trainable block, one train step's 36 blocks: forward bound_ms="
        f"{max(totals['t_ops'], totals['t_bytes']):.4f}; worst rel err {worst[0]:.3e} ({worst[1]})",
        flush=True,
    )
    return {
        "max_abs_err": max_abs,
        "max_rel_err": worst[0],
        "bound_ms": max(totals["t_ops"], totals["t_bytes"]),
        "bound_by": "operations" if totals["t_ops"] >= totals["t_bytes"] else "bytes",
        "bound_rate": "forward only: projections as 3 TF32 products at 495 TFLOP/s, depthwise at 67 TFLOP/s f32",
    }


def flagship_model(params, device):
    import torch

    from adascale_torch import AdaptiveScaling, AdaptiveScalingConfig
    from adascale_torch.utils.params import state_dict_from_jax

    model = AdaptiveScaling(AdaptiveScalingConfig(size="tiny", neck_head_type="fpn"))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.to(device)


def check_train_reference(params, device) -> dict:
    """Phase 8b: the flagship's two-task loss, gradients and one optimizer
    step against the JAX package's stored step."""
    import numpy as np
    import torch

    from adascale_torch.training import (
        OptimizerConfig, TrainStepConfig, batch_checksum, build_optimizer, seeded_batches,
        two_task_loss, upcast_batch,
    )
    from adascale_torch.training.optimizer import global_norm
    from adascale_torch.utils.params import leaf_fingerprints, leaf_sample

    ref = np.load(TRAIN_REFERENCE)
    rough, precise, rough_box, precise_box = seeded_batches(int(ref["seed"]), int(ref["batch_size"]))
    checksum = batch_checksum(rough, precise)
    if checksum != str(ref["checksum"]):
        raise AssertionError(f"the regenerated batch differs from the reference's ({checksum})")
    model = flagship_model(params, device)
    cfg = TrainStepConfig(rough_core_box=rough_box, precise_core_box=precise_box)
    total, (r_loss, p_loss) = two_task_loss(
        model, upcast_batch(rough, device), upcast_batch(precise, device), cfg, True
    )
    total.backward()
    named = dict(model.named_parameters())
    grads = {k: v.grad for k, v in named.items()}
    norm = float(global_norm(grads.values()))
    old = {k: v.detach().clone() for k, v in named.items()}
    opt, _ = build_optimizer(named, OptimizerConfig(), steps_per_epoch=1000)
    opt.step()
    updates = {k: named[k].detach() - old[k] for k in named}
    names = [str(n) for n in ref["names"]]
    if sorted(grads) != names:
        raise AssertionError("parameter names differ from the reference's")

    def leaf_errors(leaves, which):
        """Per leaf: the norm's and the projection's error over the leaf's
        norm, and the worst sampled element's error over the leaf's largest
        magnitude (a projection on one unit vector is only ~norm/sqrt(n), so
        on a large leaf the elements are what tell a wrong gradient)."""
        fingerprints, elements = {}, {}
        prints = leaf_fingerprints(leaves, int(ref["fingerprint_seed"]))
        norms, projections = ref[f"{which}_norms"], ref[f"{which}_projections"]
        samples, maxes = ref[f"{which}_samples"], ref[f"{which}_maxes"]
        begin = 0
        for k, n, pr, m in zip(names, norms, projections, maxes):
            got = leaf_sample(leaves[k])
            want = samples[begin : begin + got.size]
            begin += got.size
            fingerprints[k] = max(abs(prints[k][0] - n), abs(prints[k][1] - pr)) / max(n, 1e-30)
            elements[k] = float(np.abs(got.astype(np.float64) - want).max()) / max(float(m), 1e-30)
        if begin != samples.size:
            raise AssertionError(f"{which} samples: {begin} taken, {samples.size} stored")
        return fingerprints, elements

    grad_prints, grad_elements = leaf_errors(grads, "grad")
    grad_errs = {k: max(grad_prints[k], grad_elements[k]) for k in names}
    worst_grad_element = max(grad_elements, key=grad_elements.get)
    # The update is held by norm and projection. Its elements are printed
    # with no bar: AdamW's first step is ~g / (|g| + 1e-8) an element, so
    # where |g| is near 1e-8 f32 rounding in g moves it by up to its size;
    # the gradient's elements, of which it is a function, have the bar.
    update_errs, update_elements = leaf_errors(updates, "update")
    worst_update_element = max(update_elements, key=update_elements.get)
    loss_errs = {
        "rough_loss": abs(r_loss.item() - float(ref["rough_loss"])) / abs(float(ref["rough_loss"])),
        "precise_loss": abs(p_loss.item() - float(ref["precise_loss"])) / abs(float(ref["precise_loss"])),
        "grad_norm": abs(norm - float(ref["grad_norm"])) / float(ref["grad_norm"]),
    }
    worst_grad = max(grad_errs, key=grad_errs.get)
    worst_update = max(update_errs, key=update_errs.get)
    print(
        f"flagship two-task step vs JAX (B={int(ref['batch_size'])}, deterministic): "
        f"rough_loss={r_loss.item():.7f} (jax {float(ref['rough_loss']):.7f}) "
        f"precise_loss={p_loss.item():.7f} (jax {float(ref['precise_loss']):.7f}) "
        f"grad_norm={norm:.6f} (jax {float(ref['grad_norm']):.6f}); rel errs "
        + " ".join(f"{k}={v:.3e}" for k, v in loss_errs.items())
        + f"; worst leaf gradient {worst_grad} {grad_errs[worst_grad]:.3e} (norm and projection over "
        f"its norm, 64 sampled elements over its largest magnitude; worst element alone "
        f"{worst_grad_element} {grad_elements[worst_grad_element]:.3e}); worst leaf update {worst_update} "
        f"{update_errs[worst_update]:.3e} (norm and projection); update elements, no bar: worst "
        f"{worst_update_element} {update_elements[worst_update_element]:.3e}; {len(names)} leaves",
        flush=True,
    )
    if not max(loss_errs.values()) <= TRAIN_LOSS_TOL:
        raise AssertionError(f"losses / grad norm vs JAX: {loss_errs} > {TRAIN_LOSS_TOL}")
    if not grad_errs[worst_grad] <= LEAF_TOL:
        raise AssertionError(f"leaf gradient {worst_grad}: {grad_errs[worst_grad]} > {LEAF_TOL}")
    if not update_errs[worst_update] <= LEAF_TOL:
        raise AssertionError(f"leaf update {worst_update}: {update_errs[worst_update]} > {LEAF_TOL}")
    return {"losses": loss_errs, "worst_leaf_grad": grad_errs[worst_grad], "worst_leaf_update": update_errs[worst_update],
            "worst_update_element": update_elements[worst_update_element]}


def range_device_ms(events, name: str) -> float:
    """Device ms of the kernels launched under the ``record_function``
    ranges called ``name`` in a torch.profiler trace's events."""
    from torch.autograd import DeviceType

    return sum(
        e.device_time_total for e in events if e.device_type == DeviceType.CPU and e.name == name
    ) / 1e3


def plain_forward_device_ms(model, rough, precise, cfg, device, blocks_per_step: int) -> float:
    """Device ms of the plain version's block forwards in one traced two-task
    forward and backward at the step's shapes: ``TrainableBlock`` runs
    ``convnext_block_plain`` in place of the kernel, under a range, for this
    one measurement (no kernel launch, nothing counted, no update)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from adascale_torch.kernels import convnext_block as K
    from adascale_torch.training import two_task_loss, upcast_batch

    def plain(x, p):
        with torch.profiler.record_function("convnext_block.plain_forward"):
            return K.convnext_block_plain(x, p)

    launch, K._launch = K._launch, plain
    try:
        model.zero_grad()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            total, _ = two_task_loss(
                model, upcast_batch(rough, device), upcast_batch(precise, device), cfg, False,
                torch.Generator(device=device).manual_seed(3),
            )
            total.backward()
            torch.cuda.synchronize()
    finally:
        K._launch = launch
    model.zero_grad()
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = sum(
        1 for e in events if e.device_type == DeviceType.CPU and e.name == "convnext_block.plain_forward"
    )
    if ranges != blocks_per_step:
        raise AssertionError(f"plain forward ranges {ranges} != {blocks_per_step}")
    return range_device_ms(events, "convnext_block.plain_forward")


def step_device_split(prof) -> dict:
    """One train step's device ms by part, from a torch.profiler trace: the
    block kernel's forwards (by kernel name), the blocks' backward (the
    kernels under ``convnext_block.backward``: recompute and autograd of the
    plain version), the optimizer (under ``optimizer.step``), the rest
    (stem, stage LNs, downsamples, neck and heads forward and backward
    through cuDNN and cuBLAS, losses) and the whole. Also checks that every
    depthwise 7x7 convolution (the plain version's) ran inside the blocks'
    backward, and returns how many ran."""
    from torch.autograd import DeviceType

    events = prof.events()
    kernels = [
        e for e in events
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    total = sum(e.device_time_total for e in kernels) / 1e3
    blocks_fwd = sum(
        e.device_time_total for e in kernels if kernel_group(e.name) == "blocks"
    ) / 1e3

    def inside(e, name):
        while e is not None:
            if e.name == name:
                return True
            e = e.cpu_parent
        return False

    depthwise = [
        e for e in events
        if e.device_type == DeviceType.CPU and e.name == "aten::convolution"
        and len(e.input_shapes) > 1 and len(e.input_shapes[1]) == 4 and list(e.input_shapes[1][1:]) == [1, 7, 7]
    ]
    outside = [e for e in depthwise if not inside(e, "convnext_block.backward")]
    if outside:
        raise AssertionError(f"{len(outside)} depthwise convolutions ran outside the blocks' backward")
    backward = range_device_ms(events, "convnext_block.backward")
    optimizer = range_device_ms(events, "optimizer.step")
    by_kernel, by_op = {}, {}
    for e in kernels:
        n, ms = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, ms + e.device_time_total / 1e3)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key.startswith("aten::") and e.self_device_time_total > 0:
            by_op[e.key] = (e.count, e.self_device_time_total / 1e3)
    for label, table in (("kernels", by_kernel), ("operators, by the device time of the kernels they launch", by_op)):
        top = sorted(table.items(), key=lambda kv: -kv[1][1])[:10]
        print(f"train step, top {label} (device ms, calls): "
              + "; ".join(f"{name[:90]}={ms:.3f} ({n})" for name, (n, ms) in top), flush=True)
    return {
        "blocks_forward_kernel": blocks_fwd,
        "blocks_backward_recompute": backward,
        "optimizer": optimizer,
        "rest": total - blocks_fwd - backward - optimizer,
        "device": total,
        "depthwise_in_backward": len(depthwise),
        "dw_ln_launches": sum(1 for e in kernels if "dw_ln_kernel" in e.name),
    }


def train_steps(params, device) -> dict:
    """Phase 8c: warm-up and timed train steps with drop path; the launch
    count, a traced step, the fused forwards after training and remat."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from adascale_torch.kernels import convnext_block as K
    from adascale_torch.kernels import packing
    from adascale_torch.kernels.fpn_heads import forward_rough_from_features_fused
    from adascale_torch.kernels.precise_heads import forward_precise_from_features_fused
    from adascale_torch.training import (
        OptimizerConfig, TrainStepConfig, build_optimizer, make_train_step, seeded_batches,
        two_task_loss, upcast_batch,
    )

    model = flagship_model(params, device)
    rough, precise, rough_box, precise_box = seeded_batches(1, TRAIN_BATCH)
    cfg = TrainStepConfig(rough_core_box=rough_box, precise_core_box=precise_box)
    blocks_per_step = 2 * len(model.backbone.blocks())
    x_rough = upcast_batch(rough, device)["image"]
    x_precise = upcast_batch(precise, device)["image"]

    def fused_forwards():
        with torch.inference_mode():
            return (
                forward_rough_from_features_fused(model, model.backbone(x_rough)),
                forward_precise_from_features_fused(model, model.backbone(x_precise)),
            )

    fused_forwards()  # weight packs for the weights before training
    opt, _ = build_optimizer(dict(model.named_parameters()), OptimizerConfig(), steps_per_epoch=1000)
    step = make_train_step(model, opt, cfg, device=str(device))
    gen = torch.Generator(device=device).manual_seed(0)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, launches = [], []

    def counted_step():
        K.LAUNCHES = 0
        metrics.append(step(rough, precise, gen))
        launches.append(K.LAUNCHES)

    for _ in range(WARMUP_STEPS):
        counted_step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    wall = time.perf_counter()
    start.record()
    for _ in range(TIMED_STEPS):
        counted_step()
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - wall) * 1e3 / TIMED_STEPS
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [(float(m["rough_loss"]), float(m["precise_loss"]), float(m["grad_norm"])) for m in metrics]
    print(
        f"train steps (B={TRAIN_BATCH}, drop path on): losses (rough, precise, grad norm) "
        + "; ".join(f"{r:.5f}, {p:.5f}, {n:.3f}" for r, p, n in losses)
        + f"; block launches per step {launches}",
        flush=True,
    )
    if not all(all(map(lambda v: v == v and abs(v) != float("inf"), t)) for t in losses):
        raise AssertionError(f"a loss is not finite: {losses}")
    if launches != [blocks_per_step] * len(launches):
        raise AssertionError(f"block launches per step {launches} != {blocks_per_step}")
    unmoved = [k for k, v in model.named_parameters() if torch.equal(v.detach(), before[k])]
    if unmoved:
        raise AssertionError(f"{len(unmoved)} parameters did not move, e.g. {unmoved[:5]}")
    print(
        f"train step: {step_ms:.3f} ms a step (CUDA events over {TIMED_STEPS} steps, warm; host wall "
        f"{wall_ms:.3f} ms), {TRAIN_BATCH / step_ms * 1e3:.2f} samples/s (a sample: one rough and one "
        f"precise crop), peak memory {peak / 2**30:.3f} GiB (max_memory_allocated); every one of "
        f"{len(before)} parameters moved",
        flush=True,
    )

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        wall = time.perf_counter()
        counted_step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - wall) * 1e3
    split = step_device_split(prof)
    split["traced_step_wall"] = traced_ms
    if not launches[-1] == split["dw_ln_launches"] == split["depthwise_in_backward"] == blocks_per_step:
        raise AssertionError(f"traced step: {launches[-1]} launches, {split['dw_ln_launches']} traced "
                             f"dw_ln_kernel launches, {split['depthwise_in_backward']} depthwise "
                             f"convolutions in the backward; want {blocks_per_step}")
    print("train step, device ms by part (torch.profiler, one step): "
          + ", ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}" for k, v in split.items()),
          flush=True)
    plain_ms = plain_forward_device_ms(model, rough, precise, cfg, device, blocks_per_step)
    print(f"train step, the blocks' forwards by the plain version instead (torch.profiler, one "
          f"forward and backward): {plain_ms:.3f} device ms against the kernel's "
          f"{split['blocks_forward_kernel']:.3f}", flush=True)

    # AdamW updated the parameters in place: the fused forwards must build
    # new weight packs and agree with the module path.
    packs = packing.PACKS
    fused = fused_forwards()
    rebuilt = packing.PACKS - packs
    with torch.inference_mode():
        module = (model.forward_rough(x_rough), model.forward_precise(x_precise))
    errs = [rel_err(g, w_) for got, want in zip(fused, module) for g, w_ in zip(got, want)]
    print(f"fused forwards after training vs module path: rel errs {[f'{e:.3e}' for e in errs]}; "
          f"weight packs rebuilt {rebuilt}", flush=True)
    if not max(errs) <= FORWARD_REL_TOL or rebuilt < 1:
        raise AssertionError(f"fused after training: errs {errs}, packs rebuilt {rebuilt}")

    # remat: the same losses, twice the block forwards.
    remat_losses = []
    for remat in (False, True):
        model.zero_grad()
        K.LAUNCHES = 0
        total, (r_loss, p_loss) = two_task_loss(
            model, upcast_batch(rough, device), upcast_batch(precise, device),
            dataclasses.replace(cfg, remat=remat), False, torch.Generator(device=device).manual_seed(5),
        )
        total.backward()
        remat_losses.append((float(r_loss.detach()), float(p_loss.detach()), K.LAUNCHES))
    (r0, p0, n0), (r1, p1, n1) = remat_losses
    remat_err = max(abs(r1 - r0) / abs(r0), abs(p1 - p0) / abs(p0))
    print(f"remat: losses {r1:.7f}, {p1:.7f} vs {r0:.7f}, {p0:.7f} (rel err {remat_err:.3e}); "
          f"block launches {n1} vs {n0}", flush=True)
    if not remat_err <= REMAT_TOL or n1 != 2 * blocks_per_step or n0 != blocks_per_step:
        raise AssertionError(f"remat: rel err {remat_err}, launches {n1} / {n0}")
    return {"step_ms": step_ms, "samples_per_s": TRAIN_BATCH / step_ms * 1e3, "peak_bytes": peak,
            "launches": launches[-1], "split": split, "plain_forward_ms": plain_ms}


def main() -> None:
    # A hang ends as a traceback naming the phase, not as a cut run.
    faulthandler.dump_traceback_later(420, exit=True)
    import numpy as np
    import torch

    stamp("phase 1: device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; a CUDA device is required")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = smi_line()
    print(f"device: {name} count={count}", flush=True)
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    from adascale_torch.kernels import convnext_block as K

    stamp("phase 2: build")
    build_all()

    stamp("phase 3: kernels against plain")
    gen = torch.Generator().manual_seed(0)
    block_rows = check_blocks(gen, device)

    stamp("phase 3b: neck and head kernels against plain")
    neck_row, rough_row, precise_row = check_neck_and_heads(gen, device)

    stamp("phase 4: detect() with the tiny/FPN flagship")
    from adascale_torch import AdaptiveScalingConfig, AdaptiveScalingInference, AdaptiveScalingInferenceConfig
    from adascale_torch.utils.params import load_npz

    ref = np.load(REFERENCE)
    image = np.load(os.path.join(ROOT, str(ref["page"])))["image"]
    cfg = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(size="tiny", neck_head_type="fpn"),
        use_pallas_backbone=True,
        device="cuda",
    )
    params = load_npz(WEIGHTS)
    engine = AdaptiveScalingInference(cfg, params=params)
    stamp("engine built; first detect() (counted)")
    K.LAUNCHES = 0
    result = engine.detect(image)
    torch.cuda.synchronize()
    launches = K.LAUNCHES
    chunks = result["num_precise_chunks"]
    blocks_per_pass = sum(n for _, n in engine.config.model.backbone_spec())
    stamp("detect() done; comparing with the JAX reference")

    check_against_reference(result, ref, f"convnext_block LAUNCHES={launches}")
    if launches != blocks_per_pass * (1 + chunks):
        raise AssertionError(f"LAUNCHES {launches} != {blocks_per_pass} x (1 + {chunks})")

    stamp("warm timings")
    h, w = image.shape[:2]
    from adascale_torch.inference.preprocess import compute_rough_shapes, preprocess_image

    resized_hw, padded_hw = compute_rough_shapes(h, w)
    with torch.inference_mode():
        x_rough = preprocess_image(torch.from_numpy(image).to(device), resized_hw, padded_hw)
        stacked = result["stacked_image"]
        ph, pw = result["precise"].padded_image_shape
        x_precise = torch.nn.functional.pad(
            torch.from_numpy(stacked).to(device).float()[None],
            (0, 0, 0, pw - stacked.shape[1], 0, ph - stacked.shape[0]),
        )
        rough_ms = cuda_ms(lambda: engine.model.forward_rough(x_rough), reps=5)
        precise_ms = cuda_ms(lambda: engine.model.forward_precise(x_precise), reps=5)
    print(
        f"rough forward {tuple(x_rough.shape)}: {rough_ms:.3f} ms; precise forward "
        f"{tuple(x_precise.shape)}: {precise_ms:.3f} ms; detect() wall: "
        f"{detect_wall_ms(engine, image):.1f} ms per page (median of 3)",
        flush=True,
    )
    print_detect_steps(engine, image)

    stamp("phase 5: detect() with use_pallas_neck_heads=True")
    from adascale_torch.kernels import packing

    fused_cfg = dataclasses.replace(cfg, use_pallas_neck_heads=True)
    fused = AdaptiveScalingInference(fused_cfg, params=params)
    _, fused_launches = fused_detect_checked(fused, image, ref, blocks_per_pass)

    stamp("fused forwards against the module path; warm timings")
    forward_ms = {}
    with torch.inference_mode():
        for which, x in (("rough", x_rough), ("precise", x_precise)):
            want = engine._forward(x, which)
            got = fused._forward(x, which)
            for k, (g, w_) in enumerate(zip(got, want)):
                rel = float((g - w_).abs().max()) / float(w_.abs().max())
                print(
                    f"fused {which} output {k} {tuple(g.shape)}: rel err vs module path {rel:.3e}",
                    flush=True,
                )
                if not rel <= FORWARD_REL_TOL:
                    raise AssertionError(f"fused {which} output {k}: rel err {rel} > {FORWARD_REL_TOL}")
            forward_ms[which] = (
                cuda_ms(lambda: engine._forward(x, which), reps=5),
                cuda_ms(lambda: fused._forward(x, which), reps=5),
            )
            parts = forward_device_ms(lambda: fused._forward(x, which))
            print(
                f"fused {which} forward, device ms a call by kernel (torch.profiler, 3 calls): "
                + ", ".join(f"{k}={v:.4f}" for k, v in parts.items()),
                flush=True,
            )
    packs = packing.PACKS
    wall = detect_wall_ms(fused, image)
    print(
        "forward ms (module path / fused): "
        + "; ".join(f"{k} {m:.3f} / {f:.3f}" for k, (m, f) in forward_ms.items())
        + f"; fused detect() wall: {wall:.1f} ms per page (median of 3); weight packs built "
        f"during those 3 warm detect(): {packing.PACKS - packs}",
        flush=True,
    )
    if packing.PACKS != packs:
        raise AssertionError(f"warm fused detect() built {packing.PACKS - packs} weight packs")
    print_detect_steps(fused, image)

    stamp("phase 6: multi-chunk fused detect() (a small precise stack-area cap)")
    ref = np.load(MULTICHUNK_REFERENCE)
    chunked = AdaptiveScalingInference(
        dataclasses.replace(
            fused_cfg, precise_stacked_image_max_area=int(ref["precise_stacked_image_max_area"])
        ),
        params=params,
    )
    fused_detect_checked(chunked, np.load(os.path.join(ROOT, str(ref["page"])))["image"], ref,
                         blocks_per_pass, min_chunks=2)

    stamp("phase 7: fused detect() on a blank page")
    ref = np.load(BLANK_REFERENCE)
    result, _ = fused_detect_checked(
        fused, np.zeros(tuple(ref["image_shape"]), np.uint8), ref, blocks_per_pass
    )
    if result["stacked_image"].shape != tuple(ref["stacked_image_shape"]):
        raise AssertionError(
            f"blank page stack {result['stacked_image'].shape} != {tuple(ref['stacked_image_shape'])}"
        )

    stamp("phase 8a: the trainable block against autograd of the plain version")
    trainable_row = check_trainable_block(gen, device)

    stamp("phase 8b: the flagship's two-task step against the JAX reference")
    check_train_reference(params, device)

    stamp("phase 8c: train steps with the flagship")
    trained = train_steps(params, device)

    stamp("done")
    print(smi_line(), flush=True)
    kernels = [
        {
            "name": "convnext_block",
            "route": "cuda",
            "source": "adascale_torch/kernels/csrc/convnext_block.cu",
            "replaces": "adascale/ops/pallas/convnext_block.py:290",
            "launches": launches,
            **block_rows,
            "library_ms": None,
        }
    ]
    # The neck and head kernels: launches from phase 5; times and bounds
    # summed over one one-chunk detect()'s calls at the flagship shapes.
    for kernel, source, replaces, numbers in (
        ("fpn_neck_l0", "fpn_neck_l0.cu", "adascale/ops/pallas/fpn_neck.py:185", neck_row),
        ("fpn_heads", "fpn_heads.cu", "adascale/ops/pallas/fpn_heads.py:200", rough_row),
        ("precise_heads", "precise_heads.cu", "adascale/ops/pallas/precise_heads.py:144", precise_row),
    ):
        kernels.append(
            {
                "name": kernel,
                "route": "cuda",
                "source": f"adascale_torch/kernels/csrc/{source}",
                "replaces": replaces,
                "launches": fused_launches[kernel],
                **numbers,
                "library_ms": None,
            }
        )
    kernels.append(
        {
            "name": "convnext_block_trainable",
            "route": "cuda",
            "source": "adascale_torch/kernels/csrc/convnext_block.cu",
            "replaces": "adascale/ops/pallas/convnext_block.py:340",
            "launches": trained["launches"],
            # Device ms of one traced B = 6 step's 36 block forwards (kernel;
            # plain version in the same place) and of their backward.
            "ms": trained["split"]["blocks_forward_kernel"],
            "plain_ms": trained["plain_forward_ms"],
            "backward_ms": trained["split"]["blocks_backward_recompute"],
            **trainable_row,
            "library_ms": None,
        }
    )
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
    faulthandler.cancel_dump_traceback_later()
