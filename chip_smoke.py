"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each announced with its elapsed seconds:

  1. device: the card's name, count and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of the main path from the sources in
     this checkout; prints the build seconds and the ptxas register,
     shared-memory and spill report;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the main path gives it (the four rough-pass stage shapes of a
     1024x768 page, plus a ragged one), f32, relative error <= 1e-5; kernel
     and plain times from CUDA events (warm, median of 10);
  4. detect: the main path, ``AdaptiveScalingInference.detect()`` with the
     tiny/FPN flagship weights on a committed page, held against the JAX
     package's stored output (tests/fixtures/torch_port/
     flagship_fpn_reference.npz): rough mask agreement >= 99.5 %, and >= 95 %
     of char polygons matched one-to-one at IoU >= 0.5 both ways. Kernel
     launch counts are read from this run. Then warm timings of the rough
     and precise forwards and of detect().

The second-to-last line is a JSON object describing each kernel, the last
line ``{"ok": true, "device": {...}}``. Any failure raises and the script
exits non-zero without those lines. Without a CUDA device it exits non-zero
at once.
"""
from __future__ import annotations

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
# Rough pass of a 1024x768 page (resized 960x720, padded 960x768): the block
# shapes of the four stages and the number of blocks run at each.
STAGE_SHAPES = [((240, 192, 96), 3), ((120, 96, 192), 3), ((60, 48, 384), 9), ((30, 24, 768), 3)]
RAGGED_SHAPE = (13, 19, 96)


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
    K.build()
    print(f"build: {K.BUILD_REPORT['seconds']:.2f} s (cached={K.BUILD_REPORT['cached']})", flush=True)
    for line in str(K.BUILD_REPORT["ptxas"]).splitlines():
        if "registers" in line or "spill" in line or "smem" in line or "entry function" in line:
            print("ptxas:", line.strip(), flush=True)

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

    stamp("phase 4: detect() with the tiny/FPN flagship")
    from adascale_torch import AdaptiveScalingConfig, AdaptiveScalingInference, AdaptiveScalingInferenceConfig
    from adascale_torch.data.geometry import Polygon
    from adascale_torch.inference.eval import match_polygons
    from adascale_torch.utils.params import load_npz

    ref = np.load(REFERENCE)
    image = np.load(os.path.join(ROOT, str(ref["page"])))["image"]
    cfg = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(size="tiny", neck_head_type="fpn"),
        use_pallas_backbone=True,
        device="cuda",
    )
    engine = AdaptiveScalingInference(cfg, params=load_npz(WEIGHTS))
    stamp("engine built; first detect() (counted)")
    K.LAUNCHES = 0
    result = engine.detect(image)
    torch.cuda.synchronize()
    launches = K.LAUNCHES
    chunks = result["num_precise_chunks"]
    blocks_per_pass = sum(n for _, n in engine.config.model.backbone_spec())
    stamp("detect() done; comparing with the JAX reference")

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
        f"num_precise_chunks={chunks} (jax {int(ref['num_precise_chunks'])}) "
        f"convnext_block LAUNCHES={launches}",
        flush=True,
    )
    if agreement < 0.995:
        raise AssertionError(f"rough mask agreement {agreement} < 0.995")
    if ref_recall < 0.95 or port_precision < 0.95:
        raise AssertionError(f"polygon match {ref_recall}/{port_precision} < 0.95")
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
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        engine.detect(image)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    print(
        f"rough forward {tuple(x_rough.shape)}: {rough_ms:.3f} ms; precise forward "
        f"{tuple(x_precise.shape)}: {precise_ms:.3f} ms; detect() wall: "
        f"{statistics.median(walls):.1f} ms per page (median of 3)",
        flush=True,
    )
    # Where one detect() spends its wall time (host clock; device work ends
    # in a host copy inside rough_infer / precise_infer).
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
    faulthandler.cancel_dump_traceback_later()
