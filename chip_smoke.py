"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--phases 3,3b,4,5,6,7,8a,8b,8c,9,10,11,12,bf16,widths]

With no argument it runs every phase; ``--phases`` runs phases 1 and 2 and
those listed. A missing weight file or reference is an error in any phase
that reads it. Phases, each announced with its elapsed seconds:

  1. device: the card's name, count and power limit (nvidia-smi);
  2. build: nvcc builds the kernel libraries from the sources in this
     checkout (the four kernels' and the block's two bf16 libraries), one
     nvcc each,
     all started together; prints each build's seconds and the ptxas
     register, shared-memory and spill report;
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
  9. UPerNeXt: the tiny/UPerNeXt flagship's detect() on the same page with
     ``use_pallas_neck_heads=True`` (the JAX engine's routing: the block
     kernel in the backbone, the module neck and heads) against its JAX
     reference (tests/fixtures/torch_port/flagship_upernext_reference.npz,
     the same bars): exactly 36 block launches and none of the neck and
     heads kernels; the rough and precise forwards' ms (CUDA events), device
     ms by kernel and costliest convolutions, FFT ones marked, from a trace;
 10. tiled band recall: the FPN flagship, fused, ``detect(tiled=True)`` with
     ``precise_band_recall_center_dist_ratio=0.5`` on ``page_0`` and
     ``page_1`` side by side (1024x1536: 2 x 3 tiles of 768, overlap 128)
     against its JAX reference (flagship_fpn_tiled_band_reference.npz, the
     same bars); the rough pass one forward of the 6 tiles, neck and heads
     1 + 1 a chunk; the B = 6 rough forward timed and traced;
 11. detect_many: the three shift pages (one rough bucket, a batch of 4)
     and a 100x700 blank page through ``BatchedAdaptiveScalingInference``,
     fused: forwards at the batches and launches this input must give
     (MANY_BATCHES, MANY_LAUNCHES), each page's polygons equal single-page
     detect()'s (the same count, points within 1e-3), page_0 also against
     the JAX reference; then the fused forwards at B = 1 and B = 16, ms per
     page (CUDA events), the B = 16 ones traced;
     in phases 9-11 each forward of the path runs again on the input the
     path gave it (and the B = 16 forwards): every launch of the four
     kernels against its plain twin on the same inputs (relative error
     <= 1e-5, as in phases 3 and 3b), the fused forwards against the module
     path's (<= 1e-4, as in phase 5);
 12. the three fused wrappers (neck level 0, rough heads, precise heads)
     raise on the card, launching nothing, where a gradient is wanted;
 bf16. serving at compute_dtype="bfloat16": each kernel's bf16 entry
     against its bf16 plain twin at the main path's shapes (the block at
     every stage shape of both passes in its Pallas mode, bf16 in and out,
     and its module mode, f32 in and out, and at BF16_EXTRA_BLOCK_SHAPES,
     a ragged one and C = 1536; the neck and heads at the flagship's, with
     their launches by kernel name, and at BF16_CONV_INVARIANCE_CASES'
     batches equal bit for bit to their images run alone), the
     largest difference <= BF16_TOL of the largest plain value, max and
     median errors and each one's and the twin's error against f64 on the
     bf16-rounded operands printed, kernel, plain and bound ms (operations
     at the dense bf16 rate); the block's launches by kernel name (device
     ms from a torch.profiler trace), summed over the 36 blocks of both
     passes beside the time before its redesign (BF16_BLOCK_BEFORE_MS),
     and a cuBLAS bf16 torch.matmul of each of its GEMM shapes as a
     yardstick (on no path of the port); the block at BF16_INVARIANCE_CASES' batches equal bit for
     bit, in both modes, to its images run one at a time; detect()
     on page_0 at bf16 for the FPN flagship's module path and fused
     configuration and the UPerNeXt flagship's fused one, each against its
     JAX bf16 reference (tests/fixtures/torch_port/*_bf16_reference.npz:
     BF16_MASK_BAR, the rough height map bit for bit at
     BF16_HEIGHT_EQUAL_BAR or, for the fused FPN heads, closer than the f32
     run's, polygons at BF16_POLYGON_FLOOR; the share against
     BF16_POLYGON_BAR printed), exact bf16 launches, every launch of
     the path's forwards against its bf16 twin again; the flagship's rough
     and precise forwards at B = 1 and B = 16, f32 against bf16, module and
     fused (CUDA events, warm); detect_many at bf16 over phase 11's four
     pages against single-page bf16 detect() (MANY_BF16_POLYGON_BAR, points
     within MANY_POINT_TOL); adascale_torch.tools.bf16_drift's numbers for
     the flagship on page_0 in the fused configuration;
 widths. the neck and both heads kernels at the base and large backbones'
     widths (neck 512 / 768 -> 128 / 192, heads 256-258 / 384-386, split
     into slices of the kernels' tiles) on random weights against their
     plain twins, f32 at REL_TOL and bf16 at BF16_TOL, and both heads at
     the base widths at a tiled group's batch (WIDTH_GROUP: their
     workspace in several chunks of pixels); a fused detect() of a
     random-init base model on page_0, f32 and bf16, runs to the end with
     the neck and heads kernels launched.

Each run counts every kernel's launches from 0 just before a path and reads
them just after; a kernel that a path runs and that was not launched fails
the run. The kernels line gives each kernel's count on its main path
(``launches``: the default detect() for the block kernel, the fused one for
the neck and heads, the train step for the trainable block, the fused bf16
detect() for the bf16 entries, listed as "<name>_bf16") and on every path
(``launches_by_path``).

The second-to-last line is a JSON object describing each kernel, the last
line ``{"ok": true, "device": {...}}``. Any failure raises and the script
exits non-zero without those lines. Without a CUDA device it exits non-zero
at once.
"""
from __future__ import annotations

import contextlib
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
UPERNEXT_WEIGHTS = os.path.join(ROOT, "examples/flagship_upernext/flagship_upernext_params.f16.npz")
UPERNEXT_REFERENCE = os.path.join(FIXTURES, "flagship_upernext_reference.npz")
TILED_BAND_REFERENCE = os.path.join(FIXTURES, "flagship_fpn_tiled_band_reference.npz")
SHIFT_PAGES = [os.path.join(ROOT, f"tests/fixtures/shift_pages/page_{i}.npz") for i in range(3)]

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
# detect_many (phase 11): the three shift pages and a blank page; the
# forwards timed per page at B = 1 and at this batch.
BLANK_SHAPE = (100, 700, 3)
MANY_BATCH = 16
# Its forwards, in order: the shift pages share one rough bucket (3 pages
# padded to a batch of 4), the blank page is a group of its own, and each
# page's precise stack has a bucket of its own; 18 blocks a forward.
MANY_BATCHES = [("rough", 4), ("rough", 1)] + [("precise", 1)] * 4
MANY_LAUNCHES = {"convnext_block": 108, "fpn_neck_l0": 6, "fpn_heads": 2, "precise_heads": 4}
# Batched against single-page detect(): the same polygons, points within
# this (tests/test_batch_inference.py's bar).
MANY_POINT_TOL = 1e-3
PHASES = ("3", "3b", "4", "5", "6", "7", "8a", "8b", "8c", "9", "10", "11", "12", "bf16", "widths")
KERNEL_NAMES = ("convnext_block", "fpn_neck_l0", "fpn_heads", "precise_heads")
# bf16 serving (phase bf16): the dense bf16 tensor-core peak (H100 SXM, 700 W);
# each bf16 kernel against its bf16 plain twin, the largest difference over
# the largest |plain| (the twin rounds where the kernel rounds, so they part
# only where an f32 sum's order flips a bf16 rounding: one bf16 ulp, 2^-8).
PEAK_BF16_FLOPS = 989e12
BF16_TOL = 1e-2
# The bf16 block beyond the main path's shapes: a ragged one and the large
# preset's last stage (C = 1536, GEMM 2's K = 6144); and the batches whose
# every image must come out bit for bit as it does alone: B = 4 at the
# rough pass's stage shapes, and a tiled group's 6 tiles of 768 (a
# 192 x 192 level 0) at its four.
BF16_EXTRA_BLOCK_SHAPES = [RAGGED_SHAPE, (16, 12, 1536)]
BF16_INVARIANCE_CASES = [(4, shape) for shape, _ in STAGE_SHAPES] + [
    (6, (192 >> k, 192 >> k, 96 << k)) for k in range(4)
]
# The bf16 neck and heads at a batch, against each image run alone, bit for
# bit: B = 4 at the rough pass's level 0 and B = 16 at the precise pass's
# (detect_many's batches).
BF16_CONV_INVARIANCE_CASES = [(4, (240, 192)), (16, (256, 208))]
# The bf16 block's time on an NVIDIA H100 80GB HBM3 at 700 W before its
# Hopper redesign (the mma.sync design, both passes, 36 blocks, CUDA events
# of wrapper calls; PERF.md, Findings): printed beside the new one.
BF16_BLOCK_BEFORE_MS = {"pallas": 5.586, "module": 6.657}
# The bf16 detect()s against the JAX package's bf16 engine (tests/fixtures/
# torch_port/make_reference.py): (label, reference, weights, neck, fused).
FPN_BF16_REFERENCE = os.path.join(FIXTURES, "flagship_fpn_bf16_reference.npz")
FPN_FUSED_BF16_REFERENCE = os.path.join(FIXTURES, "flagship_fpn_fused_bf16_reference.npz")
UPERNEXT_BF16_REFERENCE = os.path.join(FIXTURES, "flagship_upernext_bf16_reference.npz")
BF16_DETECTS = [
    ("fpn_module", FPN_BF16_REFERENCE, WEIGHTS, "fpn", False),
    ("fpn_fused", FPN_FUSED_BF16_REFERENCE, WEIGHTS, "fpn", True),
    ("upernext_fused", UPERNEXT_BF16_REFERENCE, UPERNEXT_WEIGHTS, "upernext", True),
]
# The bf16 detect()s against their JAX references, which the JAX engine made
# under jax.disable_jit(), so that each operation rounds its bf16 result as
# the port does (tests/fixtures/torch_port/make_reference.py). What must
# hold: the rough mask agreement (BF16_MASK_BAR); where the rough heads are
# Flax modules (their logits bf16: the FPN module path, UPerNeXt), the share
# of the strided rough height map equal bit for bit to the reference's
# (BF16_HEIGHT_EQUAL_BAR; an f32 run gives 0 %); for the fused FPN heads
# (f32 out), a median height difference from the reference below the
# port's f32 run's; and polygons matched at IoU >= 0.5 both ways >=
# BF16_POLYGON_FLOOR, which catches a broken precise pass. The polygon bar
# that bf16 serving was asked to meet, BF16_POLYGON_BAR, is printed beside
# each and is not met: one rounding that another summation order flips
# moves a bf16 page's regions and so its polygons. On page_0 the JAX
# engine's own jit and eager runs of the FPN module path match 93.2 / 94.1 %
# of each other's polygons, and the port's f32 matches the bf16 references
# about as well as its bf16 does (PERF.md, Findings).
BF16_MASK_BAR, BF16_HEIGHT_EQUAL_BAR = 0.995, 0.85
BF16_POLYGON_BAR, BF16_POLYGON_FLOOR = 0.95, 0.80
# detect_many at bf16 against single-page bf16 detect(): polygons matched
# both ways, and the matched ones' points within MANY_POINT_TOL.
MANY_BF16_POLYGON_BAR = 0.99
# A bf16 fused forward against the same model's module path (the module
# path rounds the neck and heads where Flax does, the kernels where the
# Pallas kernels do): the whole-model bar of tests/test_torch_bf16.py.
BF16_FORWARD_TOL = 3e-2
# Widths phase: the base and large backbones' neck and head widths (C0, the
# neck's Cm = backbone group[-2], Co = Cm / 4, heads' F = (Cm + M) // 2), on
# random weights at B = 2 and a 64x48 level 0; the fused detect() of a
# random-init base model on page_0.
WIDTH_PRESETS = {"base": (128, 512), "large": (192, 768)}
WIDTH_BATCH, WIDTH_HW = 2, (64, 48)
# The heads of the base widths again at a tiled group's batch (8 tiles of
# 768, a 192x192 level 0), where the wide heads' workspace takes several
# chunks of pixels (kernels/fpn_heads.py::wide_chunk_pixels).
WIDTH_GROUP = ("base", 8, (192, 192))


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


def block_backward_bound_ms(npix: int, c: int):
    """(ops_ms, bytes_ms) for one block's backward as the trainable block
    computes it (``TrainableBlock.backward``: the forward recomputed, then
    both gradients of each projection and of the depthwise, three times the
    forward's products), at the rates of ``block_bound_ms``. Bytes: x, the
    parameters and the output's gradient read once, x's and the
    parameters' gradients written once."""
    mlp, dw = 3 * npix * 16 * c * c, 3 * npix * 2 * 49 * c
    nbytes = 4 * (3 * npix * c + 2 * (49 * c + 8 * c * c + 4 * c + 6 * c))
    return (3 * mlp / PEAK_TF32_FLOPS + dw / PEAK_F32_FLOPS) * 1e3, nbytes / PEAK_BYTES * 1e3


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


def kernel_device_ms(fn, reps: int = 10, once_a_call: bool = False, tries: int = 3):
    """Device ms per call of each kernel that ``fn`` runs on the card, by its
    name in a torch.profiler trace of ``reps`` warm calls. The profiler
    loses launches now and then (a run of every phase lost about half of
    phase bf16's; a trace may keep none), and this reads a trace as
    ``tools/kernel_ms.py`` does: ``once_a_call``, each kernel launches once
    a call, so its mean launch is its ms a call, which a partial loss does
    not bias; a trace that kept no launch is taken again, up to ``tries``
    times. A kernel whose launches in the trace are not a whole multiple
    of ``reps`` is printed, so that every loss shows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # Host-side entries carry their kernels' time too: device ones only.
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if events:
            break
        print(f"torch.profiler kept no launch of {reps} calls; tracing again", flush=True)
    ms = {}
    for event in events:
        if event.count % reps or (once_a_call and event.count > reps):
            print(f"torch.profiler kept {event.count} launches of {event.key[:80]} over {reps} calls",
                  flush=True)
        calls = event.count if once_a_call else reps
        ms[event.key] = ms.get(event.key, 0.0) + event.device_time_total / 1e3 / calls
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
    for key, ms in kernel_device_ms(lambda: K.convnext_block(x, p), reps, once_a_call=True).items():
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
    """Build the kernel libraries, one nvcc each, started together: the four
    kernels' f32 libraries (the neck's and heads' hold their bf16 entries
    too) and the block's two bf16 libraries (Pallas and module mode)."""
    from concurrent.futures import ThreadPoolExecutor

    from adascale_torch.kernels import _nvcc, convnext_block

    modules = kernel_modules()
    builds = {name: m.build for name, m in modules.items()}
    builds["convnext_block_bf16"] = lambda: convnext_block.build_bf16(False)
    builds["convnext_block_bf16_module"] = lambda: convnext_block.build_bf16(True)
    with ThreadPoolExecutor(len(builds)) as pool:
        for future in [pool.submit(build) for build in builds.values()]:
            future.result()
    for name in builds:
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
    + LN + GELU + u; step2: the 3x3 + LN + GELU; f32 or bf16), from a trace
    of 10 calls."""
    from adascale_torch.kernels import fpn_neck

    parts = {"step1": 0.0, "step2": 0.0}
    for key, ms in kernel_device_ms(lambda: fpn_neck.fused_neck_l0(f0, u, p), once_a_call=True).items():
        for part in parts:
            if f"neck_{part}_" in key:
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


def check_against_reference(result, ref, extra: str, mask_bar: float = 0.995,
                            polygon_bar: float = 0.95) -> None:
    """detect()'s output against the JAX package's stored output: rough mask
    agreement >= ``mask_bar`` (99.5 %) and >= ``polygon_bar`` (95 %) of
    polygons matched at IoU >= 0.5 both ways. Returns the two shares."""
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
    if agreement < mask_bar:
        raise AssertionError(f"rough mask agreement {agreement} < {mask_bar}")
    if ref_recall < polygon_bar or port_precision < polygon_bar:
        raise AssertionError(f"polygon match {ref_recall}/{port_precision} < {polygon_bar}")
    return ref_recall, port_precision


def fused_detect_checked(engine, image, ref, blocks_per_pass: int, min_chunks: int = 1):
    """One counted detect() of a ``use_pallas_neck_heads=True`` engine, held
    against a JAX reference; the launches of all four kernels must be exactly
    what its precise chunks need, and the chunk count the reference's.
    Returns the result and the launch counts."""
    result, launches = counted(lambda: engine.detect(image))
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
    "heads": ("heads_kernel", "heads_tma_kernel"),
    "neck_l0": ("neck_step1_", "neck_step2_"),
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
    totals = dict.fromkeys(("t_ops", "t_bytes", "bwd_ops", "bwd_bytes"), 0.0)
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
        bwd_ops, bwd_bytes = block_backward_bound_ms(TRAIN_BATCH * h * w, c)
        totals["bwd_ops"] += blocks * bwd_ops
        totals["bwd_bytes"] += blocks * bwd_bytes
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
        f"{max(totals['t_ops'], totals['t_bytes']):.4f}; backward bound_ms="
        f"{max(totals['bwd_ops'], totals['bwd_bytes']):.4f}; worst rel err {worst[0]:.3e} ({worst[1]})",
        flush=True,
    )
    return {
        "max_abs_err": max_abs,
        "max_rel_err": worst[0],
        "bound_ms": max(totals["t_ops"], totals["t_bytes"]),
        "bound_by": "operations" if totals["t_ops"] >= totals["t_bytes"] else "bytes",
        "bound_rate": "forward only: projections as 3 TF32 products at 495 TFLOP/s, depthwise at 67 TFLOP/s f32",
        "backward_bound_ms": max(totals["bwd_ops"], totals["bwd_bytes"]),
        "backward_bound_by": "operations" if totals["bwd_ops"] >= totals["bwd_bytes"] else "bytes",
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


def kernel_modules():
    """The four kernel wrappers' modules by the kernels line's names."""
    from adascale_torch.kernels import convnext_block, fpn_heads, fpn_neck, precise_heads

    return {
        "convnext_block": convnext_block,
        "fpn_neck_l0": fpn_neck,
        "fpn_heads": fpn_heads,
        "precise_heads": precise_heads,
    }


def counted(fn):
    """Run ``fn`` with every kernel's launch count (f32 and bf16) set to 0
    just before and read just after; returns its result and the counts (the
    f32 kernels' under their names, the bf16 ones' under "<name>_bf16")."""
    import torch

    modules = kernel_modules()
    for m in modules.values():
        m.LAUNCHES = m.LAUNCHES_BF16 = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {name: m.LAUNCHES for name, m in modules.items()}
    # The bf16 kernels' launches, under "<name>_bf16", where there were any.
    counts.update({f"{name}_bf16": m.LAUNCHES_BF16 for name, m in modules.items() if m.LAUNCHES_BF16})
    return out, counts


@contextlib.contextmanager
def recorded_forwards(engine):
    """Within: each ``engine._forward`` call appends its pass and a copy of
    its input to the yielded list, so that a path's forwards can be run
    again on the inputs the path gave them."""
    calls = []
    forward = engine._forward

    def recording(x, which):
        calls.append((which, x.clone()))
        return forward(x, which)

    engine._forward = recording
    try:
        yield calls
    finally:
        del engine._forward


@contextlib.contextmanager
def held_against_plain(worst: dict):
    """Within: every launch of the four kernels is held against its plain
    twin on the same inputs, with phase 3's and 3b's bar (the largest
    difference over the outputs <= REL_TOL of the largest plain value; a
    bf16 launch against its bf16 twin at BF16_TOL, gathered under
    "<name>_bf16").
    ``worst[name]`` gathers each kernel's launches, input shapes and largest
    relative error. The plain twins launch nothing, so the counts move as
    they would without the check."""
    import torch

    from adascale_torch.kernels import convnext_block, fpn_heads, fpn_neck, precise_heads

    def block_plain(x, p, module=None):
        if module is None:
            return convnext_block.convnext_block_plain(x, p)
        return convnext_block.convnext_block_plain_bf16(x, p, module)

    hooks = [
        ("convnext_block", convnext_block, "_launch", block_plain),
        ("convnext_block", convnext_block, "_launch_bf16", block_plain),
        ("fpn_neck_l0", fpn_neck, "fused_neck_l0", fpn_neck.fused_neck_l0_plain),
        ("fpn_heads", fpn_heads, "fused_rough_heads", fpn_heads.fused_rough_heads_plain),
        ("precise_heads", precise_heads, "fused_precise_heads", precise_heads.fused_precise_heads_plain),
    ]

    def checked(name, kernel, plain):
        def call(x, *args):
            got = kernel(x, *args)
            want = plain(x, *args)
            gs, ws = ([v] if torch.is_tensor(v) else list(v) for v in (got, want))
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(gs, ws))
            rel = err / (max(float(w.float().abs().max()) for w in ws) or 1.0)
            # A bf16 launch: the block's module mode takes an f32 x.
            bf16 = x.dtype == torch.bfloat16 or (name == "convnext_block" and len(args) > 1)
            key = f"{name}_bf16" if bf16 else name
            tol = BF16_TOL if bf16 else REL_TOL
            row = worst.setdefault(key, {"launches": 0, "shapes": set(), "rel": 0.0})
            row["launches"] += 1
            row["shapes"].add(tuple(x.shape))
            row["rel"] = max(row["rel"], rel)
            if not rel <= tol:
                raise AssertionError(f"{key} at {tuple(x.shape)}: relative error {rel} > {tol}")
            return got

        return call

    saved = [(module, attr, getattr(module, attr)) for _, module, attr, _ in hooks]
    for name, module, attr, plain in hooks:
        setattr(module, attr, checked(name, getattr(module, attr), plain))
    try:
        yield worst
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def check_path_forwards(label: str, engine, calls) -> dict:
    """A path's forwards run again on the inputs it gave them (``calls``, as
    ``recorded_forwards`` keeps them): every kernel launch held against its
    plain twin (``held_against_plain``), and where the engine runs an FPN
    model's neck level 0 and heads through their kernels, each output
    against the module path's (block kernel, module neck and heads) within
    FORWARD_REL_TOL, as in phase 5. Returns the kernels' worst errors."""
    import torch

    from adascale_torch.inference.engine import fused_neck_heads

    cfg = engine.config
    fused = fused_neck_heads(cfg)
    # In bf16 the fused and module forwards round at other points (the
    # whole-model bar of tests/test_torch_bf16.py).
    tol = FORWARD_REL_TOL if cfg.compute_dtype == "float32" else BF16_FORWARD_TOL
    worst = {}
    with torch.inference_mode():
        for which, x in calls:
            with held_against_plain(worst):
                got = engine._forward(x, which)
            if not fused:
                continue
            model = engine.model
            want = model.forward_rough(x) if which == "rough" else model.forward_precise(x)
            rels = [float((g.float() - w.float()).abs().max()) / float(w.float().abs().max()) for g, w in zip(got, want)]
            print(
                f"{label}: fused {which} forward {tuple(x.shape)}, outputs' rel err vs module path "
                + " ".join(f"{r:.3e}" for r in rels),
                flush=True,
            )
            if not max(rels) <= tol:
                raise AssertionError(f"{label} fused {which} {tuple(x.shape)}: rel err {rels} > {tol}")
    print(
        f"{label}: kernel launches against their plain twins: "
        + "; ".join(
            f"{k} {v['launches']} at {sorted(v['shapes'])} worst rel {v['rel']:.3e}" for k, v in worst.items()
        ),
        flush=True,
    )
    return worst


def conv_kernel_ms(fn, reps: int = 3):
    """Device ms per call of the library convolutions ``fn`` runs, by input
    and weight shape and by the kernel cuDNN chose, from a torch.profiler
    trace (``record_shapes``) of ``reps`` warm calls; FFT kernels are the
    ones whose name says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not getattr(e, "kernels", None):
            continue
        conv = e
        while conv is not None and conv.name != "aten::convolution":
            conv = conv.cpu_parent
        if conv is None:
            continue
        shapes = "x".join(str(tuple(s)) for s in conv.input_shapes[:2])
        for k in e.kernels:
            key = (shapes, k.name[:60])
            rows[key] = rows.get(key, 0.0) + k.duration / 1e3 / reps
    return sorted(((ms, shapes, name) for (shapes, name), ms in rows.items()), reverse=True)


def print_forward_profile(label: str, fn, top: int = 6) -> dict:
    """A forward's device ms by kernel group and its costliest library
    convolutions (shapes NCHW input x weight, with the kernel that took most
    of each); a convolution is on an FFT path when one of its kernels says
    so, and then all its kernels (transforms, complex products) count."""
    parts = forward_device_ms(fn)
    print(
        f"{label}, device ms a call by kernel (torch.profiler, 3 calls): "
        + ", ".join(f"{k}={v:.4f}" for k, v in parts.items()),
        flush=True,
    )
    convs = {}
    for ms, shapes, name in conv_kernel_ms(fn):
        convs.setdefault(shapes, []).append((ms, name))
    rows = sorted(
        ((sum(ms for ms, _ in ks), shapes, max(ks)[1], any("fft" in n.lower() for _, n in ks))
         for shapes, ks in convs.items()),
        reverse=True,
    )
    fft = [(ms, shapes) for ms, shapes, _, is_fft in rows if is_fft]
    print(
        f"{label}, costliest convolutions (device ms a call, input x weight, main kernel): "
        + "; ".join(f"{ms:.3f} {shapes}{' FFT' if is_fft else ''} {name}" for ms, shapes, name, is_fft in rows[:top])
        + f"; on an FFT path: {len(fft)} ({sum(ms for ms, _ in fft):.3f} ms"
        + "".join(f", {ms:.3f} {shapes}" for ms, shapes in fft) + ")",
        flush=True,
    )
    return {**parts, "fft_ms": sum(ms for ms, _ in fft)}


def forward_inputs(image, result, device):
    """The rough pass's input for ``image`` and the precise pass's input for
    ``result``'s (first) stack, as detect() builds them."""
    import torch

    from adascale_torch.inference.preprocess import compute_rough_shapes, preprocess_image

    resized_hw, padded_hw = compute_rough_shapes(*image.shape[:2])
    with torch.inference_mode():
        x_rough = preprocess_image(torch.from_numpy(image).to(device), resized_hw, padded_hw)
        stacked = result["stacked_image"]
        ph, pw = result["precise"].padded_image_shape
        x_precise = torch.nn.functional.pad(
            torch.from_numpy(stacked).to(device).float()[None],
            (0, 0, 0, pw - stacked.shape[1], 0, ph - stacked.shape[0]),
        )
    return x_rough, x_precise


def engine_for(params, **overrides):
    """An engine with the tiny flagship's config (``model`` and the engine
    fields in ``overrides``) on the card."""
    from adascale_torch import AdaptiveScalingConfig, AdaptiveScalingInference, AdaptiveScalingInferenceConfig

    model = AdaptiveScalingConfig(
        size=overrides.pop("size", "tiny"), neck_head_type=overrides.pop("neck_head_type", "fpn")
    )
    cfg = AdaptiveScalingInferenceConfig(model=model, **{"use_pallas_backbone": True, "device": "cuda", **overrides})
    return AdaptiveScalingInference(cfg, params=params)


def check_upernext(image) -> dict:
    """Phase 9: the UPerNeXt flagship's detect() in the fused configuration
    (module neck and heads, as the JAX engine routes UPerNeXt; the block
    kernel in the backbone) against its JAX reference; its launches; its
    forwards' ms and device ms by kernel."""
    import numpy as np

    from adascale_torch.utils.params import load_npz

    ref = np.load(UPERNEXT_REFERENCE)
    engine = engine_for(load_npz(UPERNEXT_WEIGHTS), neck_head_type="upernext", use_pallas_neck_heads=True)
    stamp("UPerNeXt engine built; detect() (counted)")
    with recorded_forwards(engine) as calls:
        result, launches = counted(lambda: engine.detect(image))
    chunks = result["num_precise_chunks"]
    check_against_reference(result, ref, f"LAUNCHES={launches}")
    blocks = sum(n for _, n in engine.config.model.backbone_spec())
    want = {"convnext_block": blocks * (1 + chunks), "fpn_neck_l0": 0, "fpn_heads": 0, "precise_heads": 0}
    if launches != want:
        raise AssertionError(f"UPerNeXt LAUNCHES {launches} != {want}")
    check_path_forwards("UPerNeXt", engine, calls)
    x_rough, x_precise = forward_inputs(image, result, engine.device)
    return {"launches": launches, **timed_forwards("UPerNeXt", engine, x_rough, x_precise)}


def timed_forwards(label: str, engine, x_rough, x_precise) -> dict:
    """Warm ms of an engine's rough and precise forwards (CUDA events), and
    their device ms by kernel."""
    import torch

    out = {}
    with torch.inference_mode():
        for which, x in (("rough", x_rough), ("precise", x_precise)):
            ms = cuda_ms(lambda: engine._forward(x, which), reps=3)
            print(f"{label} {which} forward {tuple(x.shape)}: {ms:.3f} ms (CUDA events, warm)", flush=True)
            out[which] = {"ms": ms, **print_forward_profile(f"{label} {which} forward", lambda: engine._forward(x, which))}
    return out


def check_tiled_band(params) -> dict:
    """Phase 10: the FPN flagship, fused, ``detect(tiled=True)`` with band
    recall on two shift pages side by side, against its JAX reference; the
    rough pass's blocks at B = 6 (the tiles), neck and heads 1 + 1 a chunk;
    every launch of its forwards against the plain twins, the fused forwards
    against the module path."""
    import numpy as np
    import torch

    ref = np.load(TILED_BAND_REFERENCE)
    image = np.concatenate([np.load(os.path.join(ROOT, str(p)))["image"] for p in ref["pages"]], axis=1)
    if image.shape != tuple(ref["image_shape"]):
        raise AssertionError(f"tiled page {image.shape} != {tuple(ref['image_shape'])}")
    engine = engine_for(
        params, use_pallas_neck_heads=True,
        precise_band_recall_center_dist_ratio=float(ref["precise_band_recall_center_dist_ratio"]),
    )
    wall = time.perf_counter()
    with recorded_forwards(engine) as calls:
        result, launches = counted(lambda: engine.detect(image, tiled=True))
    wall = (time.perf_counter() - wall) * 1e3
    chunks = result["num_precise_chunks"]
    rough = result["rough"]
    if rough.padded_image_shape != tuple(ref["rough_padded_image_shape"]):
        raise AssertionError(f"tiled padded shape {rough.padded_image_shape}")
    check_against_reference(result, ref, f"LAUNCHES={launches} wall {wall:.1f} ms (first call)")
    blocks = sum(n for _, n in engine.config.model.backbone_spec())
    want = {"convnext_block": blocks * (1 + chunks), "fpn_neck_l0": 1 + chunks, "fpn_heads": 1, "precise_heads": chunks}
    if launches != want:
        raise AssertionError(f"tiled LAUNCHES {launches} != {want}")
    tiles = [x for which, x in calls if which == "rough"]
    print(f"tiled rough pass: {[tuple(x.shape) for x in tiles]}", flush=True)
    if len(tiles) != 1 or tuple(tiles[0].shape) != (6, 768, 768, 3):
        raise AssertionError("the tiled rough pass is not one forward of 6 tiles of 768")
    check_path_forwards("tiled", engine, calls)
    tiles = tiles[0]
    with torch.inference_mode():
        ms = cuda_ms(lambda: engine._forward(tiles, "rough"), reps=3)
        print(f"tiled rough forward {tuple(tiles.shape)}: {ms:.3f} ms (CUDA events, warm)", flush=True)
        parts = print_forward_profile("tiled rough forward (B = 6)", lambda: engine._forward(tiles, "rough"))
    return {"launches": launches, "rough_ms": ms, "rough": parts}


def check_detect_many(params) -> dict:
    """Phase 11: ``detect_many`` (fused) over the three shift pages and a
    blank page: its forwards' batches and launches as MANY_BATCHES and
    MANY_LAUNCHES say, every launch of those forwards against the plain
    twins and the fused forwards against the module path, each page against
    single-page detect(), page_0 against the JAX reference too; then the
    fused forwards at B = MANY_BATCH checked the same way, and timed at
    B = 1 and B = MANY_BATCH, ms per page."""
    import numpy as np
    import torch

    from adascale_torch import BatchedAdaptiveScalingInference

    pages = [np.load(p)["image"] for p in SHIFT_PAGES] + [np.zeros(BLANK_SHAPE, np.uint8)]
    engine = engine_for(params, use_pallas_neck_heads=True)
    batched = BatchedAdaptiveScalingInference(engine)
    wall = time.perf_counter()
    with recorded_forwards(engine) as calls:
        results, launches = counted(lambda: batched.detect_many(pages))
    wall = (time.perf_counter() - wall) * 1e3
    batches = [(which, x.shape[0]) for which, x in calls]
    print(
        f"detect_many: {len(pages)} pages in {wall:.1f} ms (first call); forwards "
        + ", ".join(f"{which} {tuple(x.shape)}" for which, x in calls)
        + f"; LAUNCHES={launches}",
        flush=True,
    )
    if batches != MANY_BATCHES:
        raise AssertionError(f"detect_many forwards {batches} != {MANY_BATCHES}")
    if launches != MANY_LAUNCHES:
        raise AssertionError(f"detect_many LAUNCHES {launches} != {MANY_LAUNCHES}")
    check_path_forwards("detect_many", engine, calls)
    check_against_reference(results[0], np.load(REFERENCE), "(detect_many, page_0)")
    for k, (image, res) in enumerate(zip(pages, results)):
        single = engine.detect(image)
        vh, vw = single["rough"].resized_shape
        mask_diff = int((res["rough"].rough_char_mask[:vh, :vw] != single["rough"].rough_char_mask[:vh, :vw]).sum())
        ours, theirs = res["char_polygons"], single["char_polygons"]
        worst = max((float(np.abs(a.points - b.points).max()) for a, b in zip(ours, theirs)), default=0.0)
        print(
            f"detect_many page {k} {image.shape[:2]}: polygons batched={len(ours)} single={len(theirs)}, "
            f"worst point difference {worst:.3e}, rough mask pixels that differ {mask_diff}",
            flush=True,
        )
        if len(ours) != len(theirs) or not worst <= MANY_POINT_TOL:
            raise AssertionError(f"detect_many page {k} differs from detect(): {len(ours)} / {len(theirs)}, {worst}")

    # The fused forwards at B = 1 and B = MANY_BATCH, ms per page.
    x_rough, x_precise = forward_inputs(pages[0], results[0], engine.device)
    xs = (("rough", x_rough), ("precise", x_precise))
    with torch.inference_mode():
        xbs = [(which, x.expand(MANY_BATCH, *x.shape[1:]).contiguous()) for which, x in xs]
    check_path_forwards(f"fused forwards B={MANY_BATCH}", engine, xbs)
    per_page = {}
    with torch.inference_mode():
        for (which, x), (_, xb) in zip(xs, xbs):
            one = cuda_ms(lambda: engine._forward(x, which), reps=3)
            many = cuda_ms(lambda: engine._forward(xb, which), reps=3) / MANY_BATCH
            per_page[which] = {"b1_ms": one, f"b{MANY_BATCH}_ms_per_page": many}
            print(
                f"fused {which} forward, ms per page (CUDA events, warm): B=1 {one:.3f} "
                f"{tuple(x.shape)}; B={MANY_BATCH} {many:.3f} {tuple(xb.shape)}",
                flush=True,
            )
            per_page[which]["profile"] = print_forward_profile(
                f"fused {which} forward B={MANY_BATCH}", lambda: engine._forward(xb, which), top=4
            )
    return {"launches": launches, "forwards": per_page}


def bf16_values(t):
    """``t`` rounded to bf16, in f64: a bf16-rounded operand of the exact
    evaluations."""
    import torch

    return t.to(torch.bfloat16).double()


def check_bf16_kernel(label: str, kernel, plain, exact, args, work):
    """A bf16 kernel against its bf16 plain twin on the same inputs: the
    largest difference over the largest |plain| <= BF16_TOL (max and median
    differences printed), each of the two against ``exact()`` (the function
    in f64 on the bf16-rounded operands), kernel and plain ms (CUDA events,
    warm), and the bound: the operations at the dense bf16 rate against the
    bytes at the memory rate (``work`` = (bf16 flops, f32 flops, bytes))."""
    import torch

    got = kernel(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    ref = exact()
    got, want, ref = ([v] if torch.is_tensor(v) else list(v) for v in (got, want, ref))
    diffs = torch.cat([(g.float() - w.float()).abs().flatten() for g, w in zip(got, want)])
    err, med = float(diffs.max()), float(diffs.median())
    rel = err / max(float(w.float().abs().max()) for w in want)
    scale = max(float(e.abs().max()) for e in ref)
    rel64 = {
        which: max(float((v.double() - e).abs().max()) for v, e in zip(vals, ref)) / scale
        for which, vals in (("kernel", got), ("plain", want))
    }
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    flops16, flops32, nbytes = work
    t_ops = (flops16 / PEAK_BF16_FLOPS + flops32 / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    print(
        f"{label} bf16: max_abs_err={err:.3e} median_abs_err={med:.3e} rel={rel:.3e} "
        f"rel_vs_f64 kernel={rel64['kernel']:.3e} plain={rel64['plain']:.3e} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({by}, bf16)",
        flush=True,
    )
    if not rel <= BF16_TOL:
        raise AssertionError(f"{label} bf16: relative error {rel} > {BF16_TOL}")
    return {"max_abs_err": err, "median_abs_err": med, "ms": ms, "plain_ms": plain_ms, "t_ops": t_ops,
            "t_bytes": t_bytes, "rel64": rel64}


def block_work_bf16(npix: int, c: int, xbytes: int):
    """(bf16 flops, f32 flops, bytes) of one bf16 block: the projections at
    the bf16 rate, the depthwise at the f32 rate; x read and out written at
    ``xbytes`` an element, W1 and W2 in bf16, the taps and vectors in f32."""
    return npix * 16 * c * c, npix * 2 * 49 * c, 2 * npix * c * xbytes + 2 * 8 * c * c + 4 * (49 * c + 10 * c)


def short_kernel_name(key: str) -> str:
    """A kernel's name with its template arguments, without its namespace
    and argument list."""
    found = re.search(r"\w+_kernel(<[^>]*>)?", key)
    return found.group(0) if found else key


def block_bf16_launch_ms(x, p, reps: int = 10) -> dict:
    """Device ms per call of each launch of the bf16 block (by kernel name),
    from a torch.profiler trace of ``reps`` whole calls."""
    import torch

    from adascale_torch.kernels import convnext_block as K

    ms = {}
    for key, v in kernel_device_ms(lambda: K.convnext_block(x, p, torch.bfloat16), reps, once_a_call=True).items():
        name = short_kernel_name(key)
        ms[name] = ms.get(name, 0.0) + v
    if not ms:
        raise AssertionError("bf16 block launches missing from the trace")
    return ms


def cublas_gemm_ms(m: int, c: int, gen, device) -> tuple:
    """A yardstick on no path of the port: one cuBLAS bf16 torch.matmul of
    each of the block's two GEMM shapes, M x C . C x 4C and M x 4C . 4C x C
    (CUDA events, warm)."""
    import torch

    h = torch.randn(m, c, generator=gen).to(device, torch.bfloat16)
    u = torch.randn(m, 4 * c, generator=gen).to(device, torch.bfloat16)
    w1 = torch.randn(c, 4 * c, generator=gen).to(device, torch.bfloat16)
    w2 = torch.randn(4 * c, c, generator=gen).to(device, torch.bfloat16)
    return cuda_ms(lambda: torch.matmul(h, w1)), cuda_ms(lambda: torch.matmul(u, w2))


def check_bf16_block_invariance(gen, device) -> None:
    """Each image of a batch through the bf16 block equals the same image
    run alone, bit for bit, in both modes (BF16_INVARIANCE_CASES): every
    sum's order, split and chunking depends on H W and C only."""
    import torch

    from adascale_torch.kernels import convnext_block as K

    for b, (h, w, c) in BF16_INVARIANCE_CASES:
        p = random_block_params(c, gen, device)
        x32 = torch.randn(b, h, w, c, generator=gen).to(device)
        for module in (False, True):
            x = x32 if module else x32.to(torch.bfloat16)
            batched = K.convnext_block(x, p, torch.bfloat16)
            alone = torch.cat([K.convnext_block(x[i : i + 1], p, torch.bfloat16) for i in range(b)])
            torch.cuda.synchronize()
            differ = int((batched.view(torch.int16 if batched.dtype == torch.bfloat16 else torch.int32)
                          != alone.view(torch.int16 if alone.dtype == torch.bfloat16 else torch.int32)).sum())
            print(
                f"convnext_block bf16 {'module' if module else 'pallas'} mode, B={b} {h}x{w}x{c}: "
                f"{differ} of {batched.numel()} values differ bit for bit from the images run alone",
                flush=True,
            )
            if differ:
                raise AssertionError(f"bf16 block at B={b} {h}x{w}x{c} is not batch-invariant: {differ} differ")


def check_bf16_kernels(gen, device) -> dict:
    """The bf16 phase's kernel part: each bf16 kernel against its bf16 plain
    twin at the main path's shapes (the block at every stage shape of both
    passes, Pallas mode (bf16 x) and module mode (f32 x); the neck and heads
    at the flagship's). Returns the kernels line's bf16 entries."""
    import torch

    from adascale_torch.kernels import convnext_block as K
    from adascale_torch.kernels import fpn_heads, fpn_neck, precise_heads

    def total(rows, **extra):
        t_ops = sum(n * r["t_ops"] for r, n in rows)
        t_bytes = sum(n * r["t_bytes"] for r, n in rows)
        return {
            "max_abs_err": max(r["max_abs_err"] for r, _ in rows),
            "median_abs_err": max(r["median_abs_err"] for r, _ in rows),
            "ms": sum(n * r["ms"] for r, n in rows),
            "plain_ms": sum(n * r["plain_ms"] for r, n in rows),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_rate": "products at 989 TFLOP/s dense bf16 (the block's depthwise at 67 TFLOP/s f32)",
            "rel_vs_f64": {w: max(r["rel64"][w] for r, _ in rows) for w in ("kernel", "plain")},
            **extra,
        }

    out = {}
    rows = {True: [], False: []}
    # Each launch's device ms, summed over the 36 blocks, by mode; the
    # cuBLAS yardstick over the same 36 blocks' GEMM shapes.
    split = {True: {}, False: {}}
    cublas = [0.0, 0.0]
    cases = STAGE_SHAPES + PRECISE_STAGE_SHAPES + [(shape, 0) for shape in BF16_EXTRA_BLOCK_SHAPES]
    for (h, w, c), blocks in cases:
        p = random_block_params(c, gen, device)
        x32 = torch.randn(1, h, w, c, generator=gen).to(device)
        if blocks:
            gemm1, gemm2 = cublas_gemm_ms(h * w, c, gen, device)
            cublas[0] += blocks * gemm1
            cublas[1] += blocks * gemm2
            print(f"cuBLAS bf16 torch.matmul yardstick {h}x{w}x{c}: gemm1 {gemm1:.4f} ms, gemm2 {gemm2:.4f} ms",
                  flush=True)
        for module in (False, True):
            x = x32 if module else x32.to(torch.bfloat16)

            def exact(x=x, p=p, module=module):
                pr = {k: v.double() for k, v in p.items()}
                pr["mlp_up.weight"], pr["mlp_down.weight"] = (
                    bf16_values(p["mlp_up.weight"]), bf16_values(p["mlp_down.weight"]))
                if not module:
                    return K.convnext_block_plain(x.double(), pr)
                pr["dwconv.weight"] = bf16_values(p["dwconv.weight"])
                xin = bf16_values(x)
                return x.double() + (K.convnext_block_plain(xin, pr) - xin)

            label = f"convnext_block {h}x{w}x{c} {'module' if module else 'pallas'} mode"
            r = check_bf16_kernel(
                label,
                lambda x, p, module=module: K.convnext_block(x, p, torch.bfloat16),
                lambda x, p, module=module: K.convnext_block_plain_bf16(x, p, module),
                exact, (x, p), block_work_bf16(h * w, c, 4 if module else 2),
            )
            parts = block_bf16_launch_ms(x, p)
            print(f"{label} launches (device ms a call, torch.profiler): "
                  + ", ".join(f"{k}={v:.4f}" for k, v in parts.items()), flush=True)
            if blocks:
                rows[module].append((r, blocks))
                for k, v in parts.items():
                    split[module][k] = split[module].get(k, 0.0) + blocks * v
    for module, name in ((False, "pallas"), (True, "module")):
        print(
            f"convnext_block bf16 {name} mode, both passes (36 blocks): "
            f"kernel_ms={sum(n * r['ms'] for r, n in rows[module]):.4f} "
            f"(before the redesign: {BF16_BLOCK_BEFORE_MS[name]}) device ms by launch: "
            + ", ".join(f"{k}={v:.4f}" for k, v in split[module].items())
            + f"; cuBLAS yardstick gemm1 {cublas[0]:.4f} + gemm2 {cublas[1]:.4f} ms",
            flush=True,
        )
    module = total(rows[True])
    out["convnext_block_bf16"] = total(
        rows[False], module_mode_ms=module["ms"], module_mode_plain_ms=module["plain_ms"],
        module_mode_max_abs_err=module["max_abs_err"], module_mode_bound_ms=module["bound_ms"],
        launches_ms=split[False], module_mode_launches_ms=split[True],
        cublas_yardstick_ms={"gemm1": cublas[0], "gemm2": cublas[1]},
    )
    check_bf16_block_invariance(gen, device)

    def rounded(params, names):
        return {k: bf16_values(v) if k in names else v.double() for k, v in params.items()}

    rows = []
    neck_split = {"step1": 0.0, "step2": 0.0}
    for (h, w, c0, cm, co), calls in NECK_SHAPES[:2]:
        p = random_neck_params(c0, cm, co, gen, device)
        f0 = torch.randn(1, h, w, c0, generator=gen).to(device).to(torch.bfloat16)
        u = torch.randn(1, h, w, cm, generator=gen).to(device).to(torch.bfloat16)
        flops, _ = neck_work(1, h, w, c0, cm, co)
        nbytes = 2 * (h * w * (c0 + cm + co) + c0 * cm + 9 * cm * co) + 4 * 3 * (cm + co)
        label = f"fpn_neck_l0 {h}x{w} {c0}->{cm}->{co}"
        r = check_bf16_kernel(
            label, fpn_neck.fused_neck_l0, fpn_neck.fused_neck_l0_plain,
            lambda f0=f0, u=u, p=p: fpn_neck.fused_neck_l0_plain(
                f0.double(), u.double(), rounded(p, ("step1_0.conv.weight", "step2_0.conv.weight"))),
            (f0, u, p), (flops, 0, nbytes),
        )
        parts = neck_launch_ms(f0, u, p)
        print(f"{label} bf16 launches (device ms a call, torch.profiler): "
              + ", ".join(f"{k}={v:.4f}" for k, v in parts.items()), flush=True)
        for k, v in parts.items():
            neck_split[k] += calls * v
        rows.append((r, calls))
    out["fpn_neck_l0_bf16"] = total(rows, launches_ms=neck_split)

    from adascale_torch.ops.fused_upsample import heads_phase_form

    for name, module, (shape, calls), outs in (
        ("fpn_heads", fpn_heads, ROUGH_HEAD_SHAPES[0], (1, 1)),
        ("precise_heads", precise_heads, PRECISE_HEAD_SHAPES[0], PRECISE_OUT),
    ):
        h, w, c = shape
        heads = [random_head_params(c, m, gen, device) for m in outs]
        x = torch.randn(1, h, w, c, generator=gen).to(device).to(torch.bfloat16)
        flops, _ = heads_work(1, h, w, c, heads)
        fsum = sum(p["step1.conv.weight"].shape[0] for p in heads)
        nbytes = 2 * (h * w * c + 16 * c * fsum) + 4 * (4 * h * w * sum(outs))
        # In f64 on bf16 x and the bf16 collapsed taps (the precise heads'
        # GELU output and projection unrounded).
        exact = lambda x=x, heads=heads: heads_phase_form(  # noqa: E731
            x.double(), [{k: v.double() for k, v in p.items()} for p in heads], kernel=True)
        if module is fpn_heads:
            kernel, plain, args = fpn_heads.fused_rough_heads, fpn_heads.fused_rough_heads_plain, (x, *heads)
        else:
            kernel, plain = precise_heads.fused_precise_heads, precise_heads.fused_precise_heads_plain
            args = (x, heads)
        r = check_bf16_kernel(f"{name} {h}x{w}x{c}", kernel, plain, exact, args, (flops, 0, nbytes))
        split = {}
        for key, v in kernel_device_ms(lambda: kernel(*args), once_a_call=True).items():
            if "heads_" in key:
                split[short_kernel_name(key)] = split.get(short_kernel_name(key), 0.0) + calls * v
        print(f"{name} {h}x{w}x{c} bf16 launches (device ms a call, torch.profiler): "
              + ", ".join(f"{k}={v:.4f}" for k, v in split.items()), flush=True)
        if not split:
            raise AssertionError(f"{name} bf16 launches missing from the trace")
        out[f"{name}_bf16"] = total([(r, calls)], launches_ms=split)
    check_bf16_conv_invariance(gen, device)
    return out


def check_bf16_conv_invariance(gen, device) -> None:
    """The bf16 neck and heads at BF16_CONV_INVARIANCE_CASES' batches equal
    bit for bit to their images run one at a time: a pixel's sums run over
    its taps and chunks in one order wherever its tile falls."""
    import torch

    from adascale_torch.kernels import fpn_heads, fpn_neck, precise_heads

    def differ(batched, alone):
        return sum(
            int((g.contiguous().view(torch.int32 if g.dtype == torch.float32 else torch.int16)
                 != a.contiguous().view(torch.int32 if a.dtype == torch.float32 else torch.int16)).sum())
            for g, a in zip(batched, alone))

    # The batches' inputs are drawn on the card (B = 16 at 256x208 is ~0.9 G
    # values, seconds on the host).
    dgen = torch.Generator(device=device).manual_seed(int(torch.randint(1 << 30, (1,), generator=gen)))
    for b, (h, w) in BF16_CONV_INVARIANCE_CASES:
        p = random_neck_params(96, 384, 96, gen, device)
        f0, u, x = (torch.randn(b, h, w, c, generator=dgen, device=device).to(torch.bfloat16) for c in (96, 384, 384))
        cases = [
            ("fpn_neck_l0", lambda i, j: [fpn_neck.fused_neck_l0(f0[i:j], u[i:j], p)]),
        ]
        for name, module, outs in (("fpn_heads", fpn_heads, (1, 1)), ("precise_heads", precise_heads, PRECISE_OUT)):
            heads = [random_head_params(384, m, gen, device) for m in outs]
            if module is fpn_heads:
                cases.append((name, lambda i, j, heads=heads: list(fpn_heads.fused_rough_heads(x[i:j], *heads))))
            else:
                cases.append((name, lambda i, j, heads=heads: precise_heads.fused_precise_heads(x[i:j], heads)))
        for name, run in cases:
            batched = run(0, b)
            alone = [torch.cat(parts) for parts in zip(*(run(i, i + 1) for i in range(b)))]
            torch.cuda.synchronize()
            n = differ(batched, alone)
            print(f"{name} bf16, B={b} {h}x{w}: {n} of {sum(t.numel() for t in batched)} values differ bit "
                  "for bit from the images run alone", flush=True)
            if n:
                raise AssertionError(f"{name} bf16 at B={b} {h}x{w} is not batch-invariant: {n} differ")


def bf16_engines(params):
    """The FPN flagship's four serving engines on the card: f32 and bf16,
    module path and fused (``use_pallas_backbone`` and
    ``use_pallas_neck_heads``)."""
    return {
        (dtype, fused): engine_for(
            params, compute_dtype=dtype, use_pallas_backbone=fused, use_pallas_neck_heads=fused
        )
        for dtype in ("float32", "bfloat16") for fused in (False, True)
    }


def bf16_forward_times(engines, image, result) -> dict:
    """The flagship's rough and precise forwards on page_0's inputs at B = 1
    and B = MANY_BATCH, f32 against bf16, module path and fused: ms (CUDA
    events, warm; at B = MANY_BATCH the median of three single calls), per
    page at B = MANY_BATCH."""
    import torch

    x_rough, x_precise = forward_inputs(image, result, next(iter(engines.values())).device)
    out = {}
    with torch.inference_mode():
        for which, x in (("rough", x_rough), ("precise", x_precise)):
            xb = x.expand(MANY_BATCH, *x.shape[1:]).contiguous()
            for (dtype, fused), engine in engines.items():
                one = cuda_ms(lambda: engine._forward(x, which), reps=3)
                many = cuda_ms(lambda: engine._forward(xb, which), reps=1) / MANY_BATCH
                key = f"{which}_{'bf16' if dtype == 'bfloat16' else 'f32'}_{'fused' if fused else 'module'}"
                out[key] = {"b1_ms": one, f"b{MANY_BATCH}_ms_per_page": many}
                print(
                    f"{which} forward {dtype} {'fused' if fused else 'module path'}: B=1 {one:.3f} ms "
                    f"{tuple(x.shape)}; B={MANY_BATCH} {many:.3f} ms per page (CUDA events, warm)",
                    flush=True,
                )
    return out


def height_parity(result, ref) -> dict:
    """A detect()'s rough height score map against a bf16 reference's strided
    copy, over the pixels where either is valid: the share of values equal
    bit for bit, and the median absolute difference over the reference's
    median magnitude."""
    import numpy as np

    stride = int(ref["height_stride"])
    want = ref["rough_char_height_score_map_strided"]
    got = result["rough"].rough_char_height_score_map[::stride, ::stride]
    if got.shape != want.shape:
        raise AssertionError(f"strided height map {got.shape} != reference {want.shape}")
    valid = (got > 0) | (want > 0)
    diff = np.abs(got[valid].astype(np.float64) - want[valid])
    return {
        "equal": float((got[valid] == want[valid]).mean()),
        "median_rel": float(np.median(diff) / np.median(np.abs(want[valid]))),
    }


def check_bf16_detects(image) -> tuple:
    """detect() at bf16 on page_0 for the FPN flagship's module path and
    fused configuration and the UPerNeXt flagship's fused one, each against
    its JAX bf16 reference (BF16_MASK_BAR, BF16_POLYGON_FLOOR, and the rough
    height map bit for bit at BF16_HEIGHT_EQUAL_BAR where a Flax-module
    head makes it; the fused FPN heads' is checked by check_bf16 against
    the f32 run), with exact launch counts of the bf16 kernels (and no f32
    launch); every launch of the path's forwards held against its bf16
    plain twin again. Returns the launches, the results and each path's
    numbers against its reference."""
    import numpy as np

    from adascale_torch.utils.params import load_npz

    by_path, results, parity = {}, {}, {}
    for label, ref_path, weights, neck, fused in BF16_DETECTS:
        ref = np.load(ref_path)
        if str(ref["compute_dtype"]) != "bfloat16" or bool(ref["use_pallas_backbone"]) != fused:
            raise AssertionError(f"{ref_path} is not the {label} bf16 reference")
        engine = engine_for(
            load_npz(weights), neck_head_type=neck, compute_dtype="bfloat16",
            use_pallas_backbone=fused, use_pallas_neck_heads=fused,
        )
        wall = time.perf_counter()
        with recorded_forwards(engine) as calls:
            result, launches = counted(lambda: engine.detect(image))
        wall = (time.perf_counter() - wall) * 1e3
        chunks = result["num_precise_chunks"]
        blocks = sum(n for _, n in engine.config.model.backbone_spec())
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want["convnext_block_bf16"] = blocks * (1 + chunks)
        if fused and neck == "fpn":
            want.update(fpn_neck_l0_bf16=1 + chunks, fpn_heads_bf16=1, precise_heads_bf16=chunks)
        shares = check_against_reference(
            result, ref, f"bf16 {label} LAUNCHES={launches} wall {wall:.1f} ms (first call)",
            mask_bar=BF16_MASK_BAR, polygon_bar=BF16_POLYGON_FLOOR,
        )
        height = height_parity(result, ref)
        module_heads = not (fused and neck == "fpn")
        print(
            f"bf16 {label}: polygons {shares[0]:.4f} / {shares[1]:.4f} both ways "
            f"({'meets' if min(shares) >= BF16_POLYGON_BAR else 'below'} the {BF16_POLYGON_BAR:.0%} bar); "
            f"rough height map against the reference's: {height['equal']:.4f} equal bit for bit, "
            f"median difference {height['median_rel']:.3e} of its median",
            flush=True,
        )
        if module_heads and height["equal"] < BF16_HEIGHT_EQUAL_BAR:
            raise AssertionError(f"bf16 {label}: {height['equal']} of the height map equal < {BF16_HEIGHT_EQUAL_BAR}")
        parity[label] = {"polygons": list(shares), "height": height}
        if launches != want:
            raise AssertionError(f"bf16 {label} LAUNCHES {launches} != {want}")
        check_path_forwards(f"bf16 {label}", engine, calls)
        by_path[f"detect_bf16_{label}"] = launches
        results[label] = result
    return by_path, results, parity


def check_bf16_many(engine, single0=None) -> dict:
    """detect_many at bf16 (fused) over phase 11's four pages against
    single-page bf16 detect(): polygons matched at IoU >= 0.5 both ways >=
    MANY_BF16_POLYGON_BAR, the matched ones' points within MANY_POINT_TOL.
    ``single0``: page_0's single-page detect() with this configuration,
    where already run."""
    import numpy as np

    from adascale_torch import BatchedAdaptiveScalingInference
    from adascale_torch.inference.eval import match_polygons

    pages = [np.load(p)["image"] for p in SHIFT_PAGES] + [np.zeros(BLANK_SHAPE, np.uint8)]
    batched = BatchedAdaptiveScalingInference(engine)
    results, launches = counted(lambda: batched.detect_many(pages))
    print(f"bf16 detect_many: LAUNCHES={launches}", flush=True)
    for k, (image, res) in enumerate(zip(pages, results)):
        single = single0 if k == 0 and single0 is not None else engine.detect(image)
        ours, theirs = res["char_polygons"], single["char_polygons"]
        matches = match_polygons(ours, theirs, 0.5)
        worst = max((float(np.abs(ours[i].points - theirs[j].points).max()) for i, j, _ in matches), default=0.0)
        close = sum(float(np.abs(ours[i].points - theirs[j].points).max()) <= MANY_POINT_TOL for i, j, _ in matches)
        share = (len(matches) / len(theirs) if theirs else float(not ours),
                 len(matches) / len(ours) if ours else float(not theirs))
        print(
            f"bf16 detect_many page {k} {image.shape[:2]}: polygons batched={len(ours)} single={len(theirs)} "
            f"matched@0.5={len(matches)} ({share[0]:.4f} / {share[1]:.4f}), matched within "
            f"{MANY_POINT_TOL}: {close}, worst matched point difference {worst:.3e}",
            flush=True,
        )
        if min(share) < MANY_BF16_POLYGON_BAR or close < len(matches):
            raise AssertionError(f"bf16 detect_many page {k} differs from detect(): {share}, {close}/{len(matches)}")
    return launches


def check_bf16(params, image, gen, device) -> tuple:
    """Phase bf16: the kernels, the forwards' times, the three detect()s
    against their JAX bf16 references, detect_many and the drift numbers.
    Returns the kernels line's bf16 entries and the paths' launches."""
    import numpy as np

    from adascale_torch.tools.bf16_drift import drift, format_drift

    rows = check_bf16_kernels(gen, device)
    stamp("bf16: detect() against the JAX bf16 references")
    by_path, results, parity = check_bf16_detects(image)
    # page_0's fused bf16 detect() (the same configuration as the engines
    # below) serves the forwards' inputs, detect_many and the drift.
    fused = results["fpn_fused"]
    engines = bf16_engines(params)
    stamp("bf16: the flagship's forwards, f32 against bf16")
    rows["forwards"] = bf16_forward_times(engines, image, fused)
    stamp("bf16: detect_many against single-page detect()")
    by_path["detect_many_bf16"] = check_bf16_many(engines[("bfloat16", True)], fused)
    stamp("bf16: drift against f32 (adascale_torch.tools.bf16_drift)")
    page = np.load(SHIFT_PAGES[0])
    d = drift(params, engines[("float32", True)].config, page["image"], list(page["corners"]),
              results={"bfloat16": fused})
    print(f"bf16 drift, flagship on page_0, fused configuration: {format_drift(d)}", flush=True)
    rows["drift_fused"] = {k: v for k, v in d.items() if k != "results"}
    # The fused FPN heads' height map is f32 (no bf16 logit to match bit for
    # bit): the bf16 run must be nearer the bf16 reference than the f32 run.
    f32 = height_parity(d["results"]["float32"], np.load(FPN_FUSED_BF16_REFERENCE))
    parity["fpn_fused"]["height_f32"] = f32
    print(
        f"bf16 fpn_fused: rough height map median difference from the bf16 reference "
        f"{parity['fpn_fused']['height']['median_rel']:.3e} (bf16) against {f32['median_rel']:.3e} (f32)",
        flush=True,
    )
    if not parity["fpn_fused"]["height"]["median_rel"] < f32["median_rel"]:
        raise AssertionError(f"bf16 fpn_fused: no nearer the bf16 reference than f32: {parity['fpn_fused']}")
    rows["parity"] = parity
    return rows, by_path


def widths_bound_ms(name: str, b: int, h: int, w: int, c0: int, cm: int, co: int, heads, dtype):
    """(bound ms, what bounds it) of a neck or heads call of phase widths:
    the operations at the kernel's rate (f32: three TF32 products a product
    at the dense TF32 peak; bf16: the dense bf16 peak) against the bytes
    (each input read once, each output written once, activations and
    weights in the kernel's operand type, the vectors and the heads' f32
    maps) at the memory rate, as phases 3b and bf16 count them."""
    import torch

    npix = b * h * w
    if name == "fpn_neck_l0":
        flops, f32_bytes = neck_work(b, h, w, c0, cm, co)
        bf16_bytes = 2 * (npix * (c0 + cm + co) + c0 * cm + 9 * cm * co) + 4 * 3 * (cm + co)
    else:
        flops, f32_bytes = heads_work(b, h, w, cm, heads)
        fsum = sum(p["step1.conv.weight"].shape[0] for p in heads)
        outs = sum(p["step2.weight"].shape[0] for p in heads)
        bf16_bytes = 2 * (npix * cm + 16 * cm * fsum) + 4 * (4 * npix * outs)
    if dtype == torch.bfloat16:
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, bf16_bytes / PEAK_BYTES * 1e3
    else:
        t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS * 1e3, f32_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_widths(gen, device) -> dict:
    """Phase widths: the neck and both heads kernels at the base and large
    backbones' widths on random weights (B = 2, a 64x48 level 0) against
    their plain twins, f32 at REL_TOL and bf16 at BF16_TOL, and the heads at
    the base widths at a tiled group's batch (WIDTH_GROUP, several workspace
    chunks); then a fused
    detect() of a random-init base model on page_0, which must run to the
    end (its polygons are not checked: the weights are random). Returns the
    launches of that detect()."""
    import numpy as np
    import torch

    from adascale_torch.kernels import fpn_heads, fpn_neck, precise_heads
    from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
    from adascale_torch.utils.params import jax_from_state_dict

    runs = [(preset, WIDTH_BATCH, WIDTH_HW, False) for preset in WIDTH_PRESETS]
    runs.append((*WIDTH_GROUP, True))
    for preset, b, (h, w), heads_only in runs:
        c0, cm = WIDTH_PRESETS[preset]
        co = cm // 4
        if not heads_only:
            p = random_neck_params(c0, cm, co, gen, device)
            f0 = torch.randn(b, h, w, c0, generator=gen).to(device)
            u = torch.randn(b, h, w, cm, generator=gen).to(device)
        rough = [random_head_params(cm, 1, gen, device) for _ in range(2)]
        precise = [random_head_params(cm, m, gen, device) for m in PRECISE_OUT]
        x = torch.randn(b, h, w, cm, generator=gen).to(device)
        cases = [
            ("fpn_neck_l0", fpn_neck.fused_neck_l0, fpn_neck.fused_neck_l0_plain, lambda d: (f0.to(d), u.to(d), p)),
            ("fpn_heads", fpn_heads.fused_rough_heads, fpn_heads.fused_rough_heads_plain,
             lambda d: (x.to(d), *rough)),
            ("precise_heads", precise_heads.fused_precise_heads, precise_heads.fused_precise_heads_plain,
             lambda d: (x.to(d), precise)),
        ]
        for name, kernel, plain, args in cases[1:] if heads_only else cases:
            heads = rough if name == "fpn_heads" else precise
            fp = max(q["step1.conv.weight"].shape[0] for q in heads)
            tile = {"fpn_heads": 192, "precise_heads": 200}.get(name)
            chunks = (
                -(-b * h * w // fpn_heads.wide_chunk_pixels(len(heads), -(-fp // tile) * tile, b * h * w))
                if tile else None
            )
            if heads_only and not chunks > 1:
                raise AssertionError(f"widths group {name}: {chunks} workspace chunk(s), wanted several")
            for dtype, tol in ((torch.float32, REL_TOL), (torch.bfloat16, BF16_TOL)):
                a = args(dtype)
                got, launches = counted(lambda: kernel(*a))
                want = plain(*a)
                gs, ws = ([v] if torch.is_tensor(v) else list(v) for v in (got, want))
                err = max(float((g.float() - w_.float()).abs().max()) for g, w_ in zip(gs, ws))
                rel = err / max(float(w_.float().abs().max()) for w_ in ws)
                ms = cuda_ms(lambda: kernel(*a), reps=3)
                plain_ms = cuda_ms(lambda: plain(*a), reps=3)
                bound, by = widths_bound_ms(name, b, h, w, c0, cm, co, heads, dtype)
                print(
                    f"widths {preset} {name} {dtype} (C0 {c0}, Cm {cm}, Co {co}, heads F "
                    f"{[q['step1.conv.weight'].shape[0] for q in heads]}) "
                    f"at {tuple(a[0].shape)}: max_abs_err={err:.3e} rel={rel:.3e} kernel_ms={ms:.4f} "
                    f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({by}) "
                    f"workspace_chunks={chunks} LAUNCHES={launches}",
                    flush=True,
                )
                key = name if dtype == torch.float32 else f"{name}_bf16"
                if launches.get(key) != 1 or not rel <= tol:
                    raise AssertionError(f"widths {preset} {name} {dtype}: rel {rel} > {tol} or {launches}")

    stamp("widths: fused detect() of a random-init base model on page_0")
    torch.manual_seed(0)
    model = AdaptiveScaling(AdaptiveScalingConfig(size="base", neck_head_type="fpn"))
    params = jax_from_state_dict(model.state_dict())
    image = np.load(SHIFT_PAGES[0])["image"]
    out = {}
    for dtype in ("float32", "bfloat16"):
        engine = engine_for(params, size="base", compute_dtype=dtype, use_pallas_neck_heads=True)
        result, launches = counted(lambda: engine.detect(image))
        print(
            f"widths: fused detect() of a random-init base model ({dtype}): ran to the end, "
            f"{len(result['char_polygons'])} polygons, {len(result['regions'])} regions, LAUNCHES={launches}",
            flush=True,
        )
        suffix = "" if dtype == "float32" else "_bf16"
        if not launches.get(f"fpn_neck_l0{suffix}") or not launches.get(f"fpn_heads{suffix}"):
            raise AssertionError(f"base detect() ({dtype}) did not launch the neck and heads: {launches}")
        out[f"detect_base_random_{dtype}"] = launches
    return out


def check_grad_refusal(gen, device) -> None:
    """Phase 12: the three fused wrappers raise, launching nothing, where a
    gradient is wanted on the card (their kernels have no backward)."""
    import torch

    from adascale_torch.kernels import fpn_heads, fpn_neck, precise_heads

    (h, w, c0, cm, co), _ = NECK_SHAPES[-1]
    neck = random_neck_params(c0, cm, co, gen, device)
    f0 = torch.randn(1, h, w, c0, generator=gen).to(device)
    u = torch.randn(1, h, w, cm, generator=gen).to(device)
    x = torch.randn(1, h, w, 32, generator=gen).to(device)
    rough = [random_head_params(32, 1, gen, device) for _ in range(2)]
    precise = [random_head_params(32, m, gen, device) for m in PRECISE_OUT]
    cases = [
        ("fused_neck_l0", fpn_neck, lambda: fpn_neck.fused_neck_l0(f0, u, neck), neck["step2_0.conv.weight"]),
        ("fused_rough_heads", fpn_heads, lambda: fpn_heads.fused_rough_heads(x, *rough), x),
        ("fused_precise_heads", precise_heads, lambda: precise_heads.fused_precise_heads(x, precise),
         precise[2]["step2.bias"]),
    ]
    for name, module, call, needs_grad in cases:
        with torch.inference_mode():
            call()  # serving launches
        before = module.LAUNCHES
        needs_grad.requires_grad_()
        try:
            out = call()
        except RuntimeError as e:
            if name not in str(e) or module.LAUNCHES != before:
                raise
            print(f"{name} with a gradient on the card: RuntimeError: {e}", flush=True)
        else:
            raise AssertionError(f"{name} returned {type(out)} with a gradient wanted; it must raise")
        finally:
            needs_grad.requires_grad_(False)


def parse_phases(argv=None):
    """The phases to run: all of them, or those ``--phases`` lists (phases 1
    and 2, the device and the build, always run)."""
    import argparse

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    parser.add_argument(
        "--phases", default=",".join(PHASES),
        help=f"comma-separated phases to run after 1 and 2, of {','.join(PHASES)} (default: all)",
    )
    phases = [p.strip() for p in parser.parse_args(argv).phases.split(",") if p.strip()]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}")
    return set(phases)


def main() -> None:
    phases = parse_phases()
    # A hang ends as a traceback naming the phase, not as a cut run.
    faulthandler.dump_traceback_later(900, exit=True)
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
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)

    from adascale_torch.utils.params import load_npz

    stamp("phase 2: build")
    build_all()
    # A missing weight file or reference is an error, never a skipped phase.
    params = load_npz(WEIGHTS)
    gen = torch.Generator().manual_seed(0)
    ref = np.load(REFERENCE)
    image = np.load(os.path.join(ROOT, str(ref["page"])))["image"]
    rows, by_path = {}, {}

    if "3" in phases:
        stamp("phase 3: kernels against plain")
        rows["convnext_block"] = check_blocks(gen, device)

    if "3b" in phases:
        stamp("phase 3b: neck and head kernels against plain")
        rows["fpn_neck_l0"], rows["fpn_heads"], rows["precise_heads"] = check_neck_and_heads(gen, device)

    engine = engine_for(params)
    blocks_per_pass = sum(n for _, n in engine.config.model.backbone_spec())
    if "4" in phases:
        stamp("phase 4: detect() with the tiny/FPN flagship")
        result, launches = counted(lambda: engine.detect(image))
        chunks = result["num_precise_chunks"]
        stamp("detect() done; comparing with the JAX reference")
        check_against_reference(result, ref, f"LAUNCHES={launches}")
        want = {"convnext_block": blocks_per_pass * (1 + chunks), "fpn_neck_l0": 0, "fpn_heads": 0,
                "precise_heads": 0}
        if launches != want:
            raise AssertionError(f"LAUNCHES {launches} != {want}")
        by_path["detect"] = launches

        stamp("warm timings")
        x_rough, x_precise = forward_inputs(image, result, device)
        with torch.inference_mode():
            rough_ms = cuda_ms(lambda: engine.model.forward_rough(x_rough), reps=5)
            precise_ms = cuda_ms(lambda: engine.model.forward_precise(x_precise), reps=5)
        print(
            f"rough forward {tuple(x_rough.shape)}: {rough_ms:.3f} ms; precise forward "
            f"{tuple(x_precise.shape)}: {precise_ms:.3f} ms; detect() wall: "
            f"{detect_wall_ms(engine, image):.1f} ms per page (median of 3)",
            flush=True,
        )
        print_detect_steps(engine, image)

    fused = engine_for(params, use_pallas_neck_heads=True)
    if "5" in phases:
        stamp("phase 5: detect() with use_pallas_neck_heads=True")
        from adascale_torch.kernels import packing

        result, by_path["detect_fused"] = fused_detect_checked(fused, image, ref, blocks_per_pass)
        x_rough, x_precise = forward_inputs(image, result, device)

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

    if "6" in phases:
        stamp("phase 6: multi-chunk fused detect() (a small precise stack-area cap)")
        chunk_ref = np.load(MULTICHUNK_REFERENCE)
        chunked = engine_for(
            params, use_pallas_neck_heads=True,
            precise_stacked_image_max_area=int(chunk_ref["precise_stacked_image_max_area"]),
        )
        _, by_path["detect_fused_chunks"] = fused_detect_checked(
            chunked, np.load(os.path.join(ROOT, str(chunk_ref["page"])))["image"], chunk_ref,
            blocks_per_pass, min_chunks=2,
        )

    if "7" in phases:
        stamp("phase 7: fused detect() on a blank page")
        blank_ref = np.load(BLANK_REFERENCE)
        result, by_path["detect_fused_blank"] = fused_detect_checked(
            fused, np.zeros(tuple(blank_ref["image_shape"]), np.uint8), blank_ref, blocks_per_pass
        )
        if result["stacked_image"].shape != tuple(blank_ref["stacked_image_shape"]):
            raise AssertionError(
                f"blank page stack {result['stacked_image'].shape} != {tuple(blank_ref['stacked_image_shape'])}"
            )

    if "8a" in phases:
        stamp("phase 8a: the trainable block against autograd of the plain version")
        rows["convnext_block_trainable"] = check_trainable_block(gen, device)

    if "8b" in phases:
        stamp("phase 8b: the flagship's two-task step against the JAX reference")
        check_train_reference(params, device)

    if "8c" in phases:
        stamp("phase 8c: train steps with the flagship")
        trained = train_steps(params, device)
        by_path["train_step"] = {"convnext_block": trained["launches"]}
        rows.setdefault("convnext_block_trainable", {}).update(
            # Device ms of one traced B = 6 step's 36 block forwards (kernel;
            # plain version in the same place) and of their backward.
            launches=trained["launches"],
            ms=trained["split"]["blocks_forward_kernel"],
            plain_ms=trained["plain_forward_ms"],
            backward_ms=trained["split"]["blocks_backward_recompute"],
        )

    if "9" in phases:
        stamp("phase 9: detect() with the tiny/UPerNeXt flagship (fused configuration)")
        by_path["upernext_detect"] = check_upernext(image)["launches"]

    if "10" in phases:
        stamp("phase 10: tiled detect() with band recall on a 1024x1536 page")
        by_path["tiled_band_detect"] = check_tiled_band(params)["launches"]

    if "11" in phases:
        stamp("phase 11: detect_many over three shift pages and a blank page")
        by_path["detect_many"] = check_detect_many(params)["launches"]

    if "12" in phases:
        stamp("phase 12: the fused wrappers refuse a gradient on the card")
        check_grad_refusal(gen, device)

    if "bf16" in phases:
        stamp("phase bf16: bf16 serving (compute_dtype='bfloat16')")
        bf16_rows, bf16_paths = check_bf16(params, image, gen, device)
        rows.update({k: v for k, v in bf16_rows.items() if k.endswith("_bf16")})
        print("bf16 forwards and drift: " + json.dumps(
            {k: v for k, v in bf16_rows.items() if not k.endswith("_bf16")}), flush=True)
        by_path.update(bf16_paths)

    if "widths" in phases:
        stamp("phase widths: the neck and heads kernels at the base and large widths")
        by_path.update(check_widths(gen, device))

    # Every kernel a path runs was launched in that path's counted run.
    bf16_names = [f"{k}_bf16" for k in KERNEL_NAMES]
    path_kernels = {
        "detect": ["convnext_block"], "upernext_detect": ["convnext_block"],
        "train_step": ["convnext_block"],
        "detect_bf16_fpn_module": ["convnext_block_bf16"],
        "detect_bf16_upernext_fused": ["convnext_block_bf16"],
        "detect_bf16_fpn_fused": bf16_names, "detect_many_bf16": bf16_names,
        "detect_base_random_bfloat16": bf16_names,
    }
    for path, launches in by_path.items():
        missing = [k for k in path_kernels.get(path, KERNEL_NAMES) if not launches.get(k)]
        if missing:
            raise AssertionError(f"path {path}: kernels {missing} were not launched ({launches})")
    print("launches by path: " + json.dumps(by_path), flush=True)

    stamp("done")
    print(smi_line(), flush=True)
    sources = {
        "convnext_block": ("convnext_block.cu", "adascale/ops/pallas/convnext_block.py:290", "detect"),
        "fpn_neck_l0": ("fpn_neck_l0.cu", "adascale/ops/pallas/fpn_neck.py:185", "detect_fused"),
        "fpn_heads": ("fpn_heads.cu", "adascale/ops/pallas/fpn_heads.py:200", "detect_fused"),
        "precise_heads": ("precise_heads.cu", "adascale/ops/pallas/precise_heads.py:144", "detect_fused"),
        "convnext_block_trainable": ("convnext_block.cu", "adascale/ops/pallas/convnext_block.py:340", "train_step"),
        # The bf16 kernels, on the fused bf16 detect() (Pallas-mode blocks).
        "convnext_block_bf16": ("block_bf16.cuh", "adascale/ops/pallas/convnext_block.py:290", "detect_bf16_fpn_fused"),
        "fpn_neck_l0_bf16": ("fpn_neck_l0.cu", "adascale/ops/pallas/fpn_neck.py:185", "detect_bf16_fpn_fused"),
        "fpn_heads_bf16": ("fpn_head.cuh", "adascale/ops/pallas/fpn_heads.py:200", "detect_bf16_fpn_fused"),
        "precise_heads_bf16": ("fpn_head.cuh", "adascale/ops/pallas/precise_heads.py:144", "detect_bf16_fpn_fused"),
    }
    kernels = []
    for kernel, (source, replaces, main_path) in sources.items():
        kernel_name = "convnext_block" if kernel == "convnext_block_trainable" else kernel
        entry = {
            "name": kernel,
            "route": "cuda",
            "source": f"adascale_torch/kernels/csrc/{source}",
            "replaces": replaces,
            # The count of the main path's run; the other paths' beside it.
            "launches": by_path.get(main_path, {}).get(kernel_name),
            "launches_by_path": {
                path: c[kernel_name] for path, c in by_path.items()
                if kernel_name in c and (path == "train_step") == (main_path == "train_step")
            },
            **rows.get(kernel, {}),
            "library_ms": None,
        }
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
    faulthandler.cancel_dump_traceback_later()
