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
     JAX reference (no char polygons; the same stacked shape and chunks).

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


def forward_device_ms(fn, reps: int = 3):
    """Device ms per call of ``fn`` by kernel group, from a torch.profiler
    trace of ``reps`` warm calls: the port's kernels (``KERNEL_GROUPS``),
    everything else the card ran (``other``: library convolutions, norms,
    copies) and their sum (``device``)."""
    parts = dict.fromkeys([*KERNEL_GROUPS, "other"], 0.0)
    for key, ms in kernel_device_ms(fn, reps).items():
        group = next((g for g, keys in KERNEL_GROUPS.items() if any(k in key for k in keys)), "other")
        parts[group] += ms
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
    faulthandler.cancel_dump_traceback_later()
