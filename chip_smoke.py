"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each announced with its elapsed seconds:

  1. device: the card's name, count and power limit (nvidia-smi);
  2. build: nvcc builds the four kernel libraries from the sources in this
     checkout, one nvcc each, all started together; prints each build's
     seconds and the ptxas register, shared-memory and spill report;
  3. kernels: the ConvNeXt-block kernel against its plain PyTorch version on
     the card at the shapes the main path gives it (the four rough-pass stage
     shapes of a 1024x768 page, plus a ragged one), f32, relative error
     <= 1e-5; kernel and plain times from CUDA events (warm, median of 10);
  3b. the same for the FPN neck level-0, rough-heads and precise-heads
     kernels, at the flagship's shapes (neck at 240x192 and 256x208, rough
     heads at 240x192x384, precise heads at 256x208x384) and a ragged micro
     shape each (13x19, C=32, head widths 16..18);
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
     path's (relative error <= 1e-4) and their warm timings beside it.

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
import statistics
import subprocess
import time

T0 = time.perf_counter()

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "examples/flagship_training/flagship_fpn_params.f16.npz")
REFERENCE = os.path.join(ROOT, "tests/fixtures/torch_port/flagship_fpn_reference.npz")

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 without tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
REL_TOL = 1e-5
# Fused forwards against the module path: same function, other summation
# order and phase-collapsed taps; the JAX tests hold the pair at 2e-5.
FORWARD_REL_TOL = 1e-4
# Rough pass of a 1024x768 page (resized 960x720, padded 960x768): the block
# shapes of the four stages and the number of blocks run at each.
STAGE_SHAPES = [((240, 192, 96), 3), ((120, 96, 192), 3), ((60, 48, 384), 9), ((30, 24, 768), 3)]
RAGGED_SHAPE = (13, 19, 96)
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
    """Median milliseconds of ``fn`` on the current stream (warm)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def block_bound_ms(npix: int, c: int):
    """(ops_ms, bytes_ms) for one block: the depthwise and two projection
    multiply-adds at the f32 peak; each input (activation and weights) read
    once and the output written once at the memory rate."""
    flops = npix * (2 * 49 * c + 16 * c * c)
    nbytes = 4 * (2 * npix * c + 49 * c + 8 * c * c + 4 * c + 6 * c)
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


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


def check_kernel(label: str, kernel, plain, args, work, reps: int = 10):
    """The kernel against its plain version on the same inputs; raises past
    REL_TOL. Prints and returns max_abs_err, kernel and plain ms, and the
    operations at the f32 peak and the bytes (each input read once, each
    output written once) at the memory rate, in ms."""
    import torch

    got = kernel(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
    rel = err / max(float(w_.abs().max()) for w_ in want)
    ms = cuda_ms(lambda: kernel(*args), reps)
    plain_ms = cuda_ms(lambda: plain(*args), reps)
    flops, nbytes = work
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    print(
        f"{label}: max_abs_err={err:.3e} rel={rel:.3e} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({by})",
        flush=True,
    )
    if not rel <= REL_TOL:
        raise AssertionError(f"{label}: relative error {rel} > {REL_TOL}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "t_ops": t_ops, "t_bytes": t_bytes}


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


def check_neck_and_heads(gen, device):
    """Phase 3b: the neck and head kernels against their plain versions.
    Returns per kernel the entries of the kernels line (times and bounds
    summed over one one-chunk detect()'s calls)."""
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
        }

    rows = []
    for (h, w, c0, cm, co), calls in NECK_SHAPES:
        p = random_neck_params(c0, cm, co, gen, device)
        f0 = torch.randn(1, h, w, c0, generator=gen).to(device)
        u = torch.randn(1, h, w, cm, generator=gen).to(device)
        r = check_kernel(
            f"fpn_neck_l0 {h}x{w} {c0}->{cm}->{co}", fpn_neck.fused_neck_l0,
            fpn_neck.fused_neck_l0_plain, (f0, u, p), neck_work(1, h, w, c0, cm, co),
        )
        rows.append((r, calls))
    neck = total(rows)

    rows = []
    for (h, w, c), calls in ROUGH_HEAD_SHAPES:
        heads = [random_head_params(c, 1, gen, device) for _ in range(2)]
        x = torch.randn(1, h, w, c, generator=gen).to(device)
        r = check_kernel(
            f"fpn_heads {h}x{w}x{c}", fpn_heads.fused_rough_heads,
            fpn_heads.fused_rough_heads_plain, (x, *heads), heads_work(1, h, w, c, heads),
        )
        rows.append((r, calls))
    rough = total(rows)

    rows = []
    for (h, w, c), calls in PRECISE_HEAD_SHAPES:
        heads = [random_head_params(c, m, gen, device) for m in PRECISE_OUT]
        x = torch.randn(1, h, w, c, generator=gen).to(device)
        r = check_kernel(
            f"precise_heads {h}x{w}x{c}", precise_heads.fused_precise_heads,
            precise_heads.fused_precise_heads_plain, (x, heads), heads_work(1, h, w, c, heads),
        )
        rows.append((r, calls))
    precise = total(rows)
    return neck, rough, precise


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
    ref_recall = matched / max(len(theirs), 1)
    port_precision = matched / max(len(ours), 1)
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
    max_abs_err = 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "t_ops": 0.0, "t_bytes": 0.0}
    for (h, w, c), blocks in STAGE_SHAPES + [(RAGGED_SHAPE, 0)]:
        p = random_block_params(c, gen, device)
        x = torch.randn(1, h, w, c, generator=gen).to(device)
        got = K.convnext_block(x, p)
        torch.cuda.synchronize()
        want = K.convnext_block_plain(x, p)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        ms = cuda_ms(lambda: K.convnext_block(x, p))
        plain_ms = cuda_ms(lambda: K.convnext_block_plain(x, p))
        t_ops, t_bytes = block_bound_ms(h * w, c)
        bound, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        print(
            f"convnext_block {h}x{w}x{c}: max_abs_err={err:.3e} rel={rel:.3e} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({by}) "
            f"blocks_per_rough_pass={blocks}",
            flush=True,
        )
        if not rel <= REL_TOL:
            raise AssertionError(f"convnext_block {h}x{w}x{c}: relative error {rel} > {REL_TOL}")
        max_abs_err = max(max_abs_err, err)
        totals["ms"] += blocks * ms
        totals["plain_ms"] += blocks * plain_ms
        totals["t_ops"] += blocks * t_ops
        totals["t_bytes"] += blocks * t_bytes

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
    from adascale_torch.kernels import fpn_heads, fpn_neck, precise_heads

    fused = AdaptiveScalingInference(dataclasses.replace(cfg, use_pallas_neck_heads=True), params=params)
    K.LAUNCHES = fpn_neck.LAUNCHES = fpn_heads.LAUNCHES = precise_heads.LAUNCHES = 0
    result = fused.detect(image)
    torch.cuda.synchronize()
    fused_launches = {
        "convnext_block": K.LAUNCHES,
        "fpn_neck_l0": fpn_neck.LAUNCHES,
        "fpn_heads": fpn_heads.LAUNCHES,
        "precise_heads": precise_heads.LAUNCHES,
    }
    chunks = result["num_precise_chunks"]
    want_launches = {
        "convnext_block": blocks_per_pass * (1 + chunks),
        "fpn_neck_l0": 1 + chunks,
        "fpn_heads": 1,
        "precise_heads": chunks,
    }
    stamp("fused detect() done; comparing with the JAX reference")
    check_against_reference(result, ref, f"LAUNCHES={fused_launches}")
    if fused_launches != want_launches:
        raise AssertionError(f"LAUNCHES {fused_launches} != {want_launches}")

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
    print(
        "forward ms (module path / fused): "
        + "; ".join(f"{k} {m:.3f} / {f:.3f}" for k, (m, f) in forward_ms.items())
        + f"; fused detect() wall: {detect_wall_ms(fused, image):.1f} ms per page (median of 3)",
        flush=True,
    )
    print_detect_steps(fused, image)

    stamp("done")
    print(smi_line(), flush=True)
    kernels = [
        {
            "name": "convnext_block",
            "route": "cuda",
            "source": "adascale_torch/kernels/csrc/convnext_block.cu",
            "replaces": "adascale/ops/pallas/convnext_block.py:290",
            "launches": launches,
            "max_abs_err": max_abs_err,
            # Times and bound summed over the 18 blocks of one rough pass.
            "ms": totals["ms"],
            "plain_ms": totals["plain_ms"],
            "bound_ms": max(totals["t_ops"], totals["t_bytes"]),
            "bound_by": "operations" if totals["t_ops"] >= totals["t_bytes"] else "bytes",
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
