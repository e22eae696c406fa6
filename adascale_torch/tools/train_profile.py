"""Ablation profiler for the two-task train step, on the H100.

Counterpart of ``adascale/tools/train_profile.py``, with its labels and
summary lines: the full step (loss, backward, clip and AdamW), the forward
alone, the gradient alone, each task's gradient, the backbone's gradient at
the rough shape, the optimizer alone and a depthwise 7x7 forward + weight
gradient per stage, each timed warm as it is (CUDA events around ``iters``
calls after one warm-up call; on the CPU the host clock). The TPU tool
chained each component in a ``lax.scan`` and took the step apart by
differencing, because its runtime did not synchronise; the split here is
still by difference of the measured components, which are real calls.

FLOPs are counted from the shapes (``forward_flops``, ``step_flops``): the
products and convolutions that the port's step runs, as
``torch.utils.flop_counter.FlopCounterMode`` counts them on the plain path
(``tests/test_torch_profile_tools.py`` holds every component to it within
1 %): a backward costs twice its forward's products, one less for a layer
whose input needs no gradient (the stem), and each ConvNeXt block's forward
runs once more in its backward (``TrainableBlock`` recomputes it); with
``--remat`` every forward runs once more. ``mfu`` is against the H100's
peak for the step's dtype, the rate its products run at: ``H100_PEAK_BF16``
in bf16, ``H100_PEAK_F32_3XTF32`` in f32 (three TF32 products a product, as
``serve_profile`` bounds f32 too); the card and its power limit are on the
header line.

``--loop-probe`` measures the train loop's overheads instead: the step in a
Python loop on device-resident, numpy f32 and compact numpy (uint8 image,
f16 maps) batches, and the cost of reading two finished scalars. The JAX
tool's ``--fused`` chose its Pallas block over the module backbone; the
port's blocks always run the kernel (``TrainableBlock`` in training), so
the flag has no counterpart here.

Usage:  python -m adascale_torch.tools.train_profile [--batch 6] [--iters 8]
        [--dtype bf16|f32] [--remat] [--loop-probe]
        [--rough-hw 512] [--precise-hw 320] [--block-spec 96x3,192x3,384x9,768x3]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import functools
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# NVIDIA H100 SXM, dense, at 700 W (the NVIDIA data sheet; PERF.md).
H100_PEAK_BF16 = 989e12
H100_PEAK_TF32 = 495e12
# f32 products as this port computes them, three TF32 products each on the
# tensor cores: the fastest f32 rate of the card (its f32 SIMT peak is 67
# TFLOP/s), for MFU and lower bounds alike.
H100_PEAK_F32_3XTF32 = H100_PEAK_TF32 / 3
HBM_BW = 3.35e12  # HBM3 bytes/s
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
PEAKS = {"f32": H100_PEAK_F32_3XTF32, "bf16": H100_PEAK_BF16}
TINY_SPEC = "96x3,192x3,384x9,768x3"


# ----------------------------------------------------------------- the card


@functools.lru_cache(maxsize=None)
def card(device: str) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    index = torch.device(device).index or 0
    return out[index] if index < len(out) else torch.cuda.get_device_name(index)


def resolve(device: str) -> torch.device:
    """The device; raises for a card that is not there (pass ``cpu`` for the
    plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False; "
                "pass --device cpu to run the plain versions on the CPU"
            )
        from ..utils.precision import pin_full_f32

        pin_full_f32()
    return dev


def seconds_per_call(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """One warm-up call, then ``iters`` calls timed: CUDA events on the card,
    the host clock on the CPU; seconds a call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


# -------------------------------------------------------------- FLOP counts


def conv_flops(npix: int, cin: int, cout: int, k: int, groups: int = 1) -> int:
    """A convolution's products (2 a multiply-add) over ``npix`` output pixels."""
    return 2 * npix * cout * (cin // groups) * k * k


def stage_shapes(specs: Sequence[Tuple[int, int]], b: int, h: int, w: int) -> List[Tuple[int, int, int, int]]:
    """(B, H, W, C) of each backbone stage for a (b, h, w) input: the 4x4
    stride-4 stem, then 2x2 stride-2 downsamples."""
    h, w = (h - 4) // 4 + 1, (w - 4) // 4 + 1
    out = []
    for i, (c, _) in enumerate(specs):
        if i:
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
        out.append((b, h, w, c))
    return out


def forward_flops(
    specs: Sequence[Tuple[int, int]], b: int, h: int, w: int, which: str, dtype: torch.dtype = torch.float32
) -> Dict[str, int]:
    """Products of one FPN forward (``which``: "rough" or "precise") of a
    (b, h, w) input by part: ``stem``, ``blocks``, ``downsample`` (the
    backbone), ``neck``, ``heads``. The factor-2 heads run as four phases of
    one product at the neck's resolution (``ops/fused_upsample.py::
    heads_phase_form``); in bf16 each head's phase is a 2x2 convolution over
    the padded input, one row and column more (``module_head_bf16``)."""
    shapes = stage_shapes(specs, b, h, w)
    npix = [bb * hh * ww for bb, hh, ww, _ in shapes]
    cn = specs[-2][0]
    inner = cn // len(specs)
    out = {
        "stem": conv_flops(npix[0], 3, specs[0][0], 4),
        "blocks": sum(n * npix[i] * c * (98 + 16 * c) for i, (c, n) in enumerate(specs)),
        "downsample": sum(conv_flops(npix[i], specs[i - 1][0], c, 2) for i, (c, _) in enumerate(specs) if i),
        "neck": sum(conv_flops(npix[i], c, cn, 1) + conv_flops(npix[i], cn, inner, 3) for i, (c, _) in enumerate(specs)),
    }
    outs = (1, 1) if which == "rough" else (1, 2, 4, 4)
    b0, h0, w0, _ = shapes[0]
    phase_pix = b0 * (h0 + 1) * (w0 + 1) if dtype == torch.bfloat16 else npix[0]
    out["heads"] = sum(
        4 * (conv_flops(phase_pix, cn, (cn + m) // 2, 2) + conv_flops(npix[0], (cn + m) // 2, m, 1)) for m in outs
    )
    return out


def block_flops(npix: int, c: int) -> Tuple[int, int]:
    """(depthwise 7x7, LN + MLP 4x) products of one ConvNeXt block."""
    return 98 * npix * c, 16 * npix * c * c


def grad_flops(parts: Dict[str, int], remat: bool = False) -> int:
    """Products of a forward with its backward as the port's step runs it:
    3x each part (forward, the gradients of input and weight), the stem 2x
    (its input needs none), the blocks 4x (``TrainableBlock`` recomputes the
    forward); ``remat`` runs every forward once more."""
    factor = {"stem": 2, "blocks": 4}
    total = sum(v * factor.get(k, 3) for k, v in parts.items())
    return total + (sum(parts.values()) if remat else 0)


def backbone_parts(parts: Dict[str, int]) -> Dict[str, int]:
    return {k: parts[k] for k in ("stem", "blocks", "downsample")}


# ------------------------------------------------------------------ the step


def build(spec: str, dtype: str, device: torch.device, seed: int = 0):
    """(model, specs): the FPN model of ``spec`` ("CxN,..." per stage) at
    ``dtype``, parameters drawn as the JAX package's init draws them."""
    from ..models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig, init_like_flax_

    specs = tuple(tuple(int(v) for v in s.split("x")) for s in spec.split(","))
    config = AdaptiveScalingConfig(size="tiny", neck_head_type="fpn", custom_block_channels_and_num_layers=specs)
    model = AdaptiveScaling(config, DTYPES[dtype])
    init_like_flax_(model, torch.Generator().manual_seed(seed))
    return model.to(device), specs


def batches(b: int, rough_hw: int, precise_hw: int, device: torch.device, seed: int = 0):
    """Rough and precise batches of random data on ``device`` (the training
    layout, the core box the whole downsampled map) and the step config's
    core boxes."""
    from ..training.train_step import seeded_batches, upcast_batch

    rough, precise, rbox, pbox = seeded_batches(seed, b, rough_hw, precise_hw, 200, 0, 0)
    return rough, precise, upcast_batch(rough, device), upcast_batch(precise, device), rbox, pbox


def ablations(model, specs, rough, precise, cfg, device: torch.device, dtype: str, remat: bool = False):
    """[(label, call, flops or None)] in the JAX tool's order; ``rough`` and
    ``precise`` are device batches. The step's components leave the model's
    parameters as they find them, except ``full_step``, which trains."""
    from ..training.optimizer import OptimizerConfig, build_optimizer
    from ..training.train_step import make_train_step, precise_task_loss, rough_task_loss, two_task_loss

    dt = DTYPES[dtype]
    b, rhw = rough["image"].shape[0], rough["image"].shape[1]
    phw = precise["image"].shape[1]
    fr = forward_flops(specs, b, rhw, rhw, "rough", dt)
    fp = forward_flops(specs, b, phw, phw, "precise", dt)
    params = dict(model.named_parameters())
    opt, _ = build_optimizer(params, OptimizerConfig(), steps_per_epoch=1000)
    step = make_train_step(model, opt, cfg, device=str(device))
    gen = torch.Generator(device=device).manual_seed(0)

    def zero():
        for p in params.values():
            p.grad = None

    def full():
        return step(rough, precise, gen)["rough_loss"]

    def fwd():
        with torch.no_grad():
            return two_task_loss(model, rough, precise, cfg, False, gen)[0]

    def grad():
        zero()
        total, _ = two_task_loss(model, rough, precise, cfg, False, gen)
        total.backward()
        return total

    def task(loss_fn, batch):
        def run():
            zero()
            masks = model.backbone.draw_drop_masks(batch["image"].shape[0], gen)
            loss = loss_fn(model, batch, cfg, False, masks)
            loss.backward()
            return loss

        return run

    def backbone():
        zero()
        masks = model.backbone.draw_drop_masks(b, gen)
        feats = model.backbone(rough["image"], False, masks)
        loss = sum(f.float().mean() for f in feats)
        loss.backward()
        return loss

    grad()
    saved = {k: p.grad.clone() for k, p in params.items()}

    def optimizer():
        for k, p in params.items():
            p.grad = saved[k]
        return opt.step()

    rows = [
        ("full_step", full, grad_flops(fr, remat) + grad_flops(fp, remat)),
        ("fwd_only(two-task loss)", fwd, sum(fr.values()) + sum(fp.values())),
        ("grad_only", grad, grad_flops(fr, remat) + grad_flops(fp, remat)),
        ("rough_task_grad", task(rough_task_loss, rough), grad_flops(fr, remat)),
        ("precise_task_grad", task(precise_task_loss, precise), grad_flops(fp, remat)),
        ("backbone_grad(rough shape)", backbone, grad_flops(backbone_parts(fr))),
        ("optimizer_only", optimizer, None),
    ]
    for _, hh, ww, c in stage_shapes(specs, b, rhw, rhw):
        rows.append((f"  dw7x7 {hh}x{ww}x{c}", depthwise_grad(b, hh, ww, c, dt, device), 2 * block_flops(b * hh * ww, c)[0]))
    return rows


def depthwise_grad(b: int, h: int, w: int, c: int, dtype: torch.dtype, device: torch.device):
    """A depthwise 7x7 forward and its weight's gradient (the micro-bench)."""
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(b, c, h, w, generator=gen, device=device).to(dtype)
    weight = (torch.randn(c, 1, 7, 7, generator=gen, device=device) * 0.01).to(dtype).requires_grad_()

    def run():
        weight.grad = None
        loss = F.conv2d(x, weight, padding=3, groups=c).float().mean()
        loss.backward()
        return loss

    return run


def report(label: str, dt: float, flops: Optional[int], peak: float, device: str) -> str:
    mfu = f"  {flops / dt / 1e12:6.2f} TF/s  mfu={flops / dt / peak * 100:5.1f}%" if flops else ""
    return f"{label:<28} {dt * 1e3:8.1f} ms{mfu}  [{card(device)}]"


def loop_probe(model, cfg, rough_np, precise_np, device: torch.device, iters: int) -> Dict[str, float]:
    """The JAX tool's ``--loop-probe``: ms a step in a Python loop on
    device-resident, numpy f32 and compact numpy batches; ms to read two
    finished scalars."""
    from ..training.optimizer import OptimizerConfig, build_optimizer
    from ..training.train_step import make_train_step, upcast_batch

    opt, _ = build_optimizer(dict(model.named_parameters()), OptimizerConfig(), steps_per_epoch=1000)
    step = make_train_step(model, opt, cfg, device=str(device))
    gen = torch.Generator(device=device).manual_seed(0)

    def as_f32(batch):
        return {k: v.astype(np.float32) if k == "image" or v.dtype == np.uint8 else v for k, v in batch.items()}

    def compact(batch):
        return {k: v.astype(np.float16) if v.dtype == np.float32 else v for k, v in batch.items()}

    variants = [
        ("py-loop, device-resident inputs", upcast_batch(rough_np, device), upcast_batch(precise_np, device)),
        ("py-loop, numpy f32 inputs", as_f32(rough_np), as_f32(precise_np)),
        ("py-loop, numpy compact inputs", compact(rough_np), compact(precise_np)),
    ]
    out = {}
    for label, rb, pb in variants:
        nbytes = sum(getattr(v, "nbytes", 0) for v in list(rb.values()) + list(pb.values()))
        dt = seconds_per_call(lambda: step(rb, pb, gen), iters, device)
        if nbytes:
            label = f"{label} ({nbytes / 1e6:.1f} MB H2D)"
        print(f"{label:<40} {dt * 1e3:8.1f} ms/step  [{card(str(device))}]", flush=True)
        out[label] = dt
    metrics = step(variants[0][1], variants[0][2], gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(10):
        float(metrics["precise_loss"])
        float(metrics["rough_loss"])
    rtt = (time.perf_counter() - t0) / 10
    print(f"{'fetch 2 ready scalars (loop sync cost)':<40} {rtt * 1e3:8.3f} ms  [{card(str(device))}]", flush=True)
    times = list(out.values())
    h2d = sum(v.nbytes for v in list(variants[1][1].values()) + list(variants[1][2].values()))
    print(f"H2D overhead/step: {(times[1] - times[0]) * 1e3:.1f} ms "
          f"(~{h2d / max(times[1] - times[0], 1e-9) / 1e6:.0f} MB/s)", flush=True)
    out["fetch"] = rtt
    return out


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--rough-hw", type=int, default=512)
    ap.add_argument("--precise-hw", type=int, default=320)
    ap.add_argument("--block-spec", default=TINY_SPEC, help="backbone stages, CxN each (default: tiny)")
    ap.add_argument("--loop-probe", action="store_true",
                    help="measure the train loop's overheads instead of the step ablations")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    from ..training.train_step import TrainStepConfig

    device = resolve(args.device)
    model, specs = build(args.block_spec, args.dtype, device)
    rough_np, precise_np, rough, precise, rbox, pbox = batches(args.batch, args.rough_hw, args.precise_hw, device)
    cfg = TrainStepConfig(
        rough_core_box=rbox, precise_core_box=pbox, remat=args.remat,
        compute_dtype={"f32": "float32", "bf16": "bfloat16"}[args.dtype],
    )
    n_params = sum(p.numel() for p in model.parameters())
    print(
        f"tiny/FPN {n_params / 1e6:.1f}M params, {args.dtype}, rough B{args.batch}@{args.rough_hw}, "
        f"precise B{args.batch}@{args.precise_hw}, remat={args.remat}, device={device.type} "
        f"[{card(args.device)}]; mfu against {PEAKS[args.dtype] / 1e12:.0f} TFLOP/s",
        flush=True,
    )
    if args.loop_probe:
        return loop_probe(model, cfg, rough_np, precise_np, device, args.iters)

    times = {}
    for label, fn, flops in ablations(model, specs, rough, precise, cfg, device, args.dtype, args.remat):
        if label.startswith("  dw7x7") and not any(k.startswith("  dw7x7") for k in times):
            print("-- depthwise 7x7 fwd+bwd microbench (rough shapes) --", flush=True)
        dt = seconds_per_call(fn, args.iters, device)
        times[label] = dt
        print(report(label, dt, flops, PEAKS[args.dtype], args.device), flush=True)

    t_full, t_fwd, t_grad = times["full_step"], times["fwd_only(two-task loss)"], times["grad_only"]
    dw = sum(v for k, v in times.items() if k.startswith("  dw7x7"))
    print("-- summary --")
    print(f"full step          {t_full * 1e3:8.1f} ms  ({1.0 / t_full:.2f} steps/s)")
    print(f"  forward           {t_fwd * 1e3:8.1f} ms  ({t_fwd / t_full * 100:.0f}%)")
    print(f"  backward (diff)   {(t_grad - t_fwd) * 1e3:8.1f} ms  ({(t_grad - t_fwd) / t_full * 100:.0f}%)")
    print(f"  optimizer (diff)  {(t_full - t_grad) * 1e3:8.1f} ms  ({(t_full - t_grad) / t_full * 100:.0f}%)")
    print(f"  rough task grad   {times['rough_task_grad'] * 1e3:8.1f} ms")
    print(f"  precise task grad {times['precise_task_grad'] * 1e3:8.1f} ms")
    print(f"  backbone grad     {times['backbone_grad(rough shape)'] * 1e3:8.1f} ms  "
          "(rough shape; task - this = neck/head/loss)")
    print(f"  optimizer alone   {times['optimizer_only'] * 1e3:8.1f} ms")
    print(f"  dwconv micro sum  {dw * 1e3:8.1f} ms  (one branch fwd+wgrad)", flush=True)
    return times


if __name__ == "__main__":
    main()
