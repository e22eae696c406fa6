"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--phases 3,3b,4,5,6,7,8a,8b,8c,9,10,11,12,export,loop,mesh,bf16,widths,tf32,tools]

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
  8. training, the two-task train step with the flagship (B = 6 at the
     training shapes: 512x512 rough crops, 320x320 precise crops, 200 label
     points), f32 and bf16 (the flagships' own compute_dtype):
     8a. the trainable block (``TrainableBlock``: kernel forward, backward
         by recompute and autograd of the plain version) against autograd
         through the plain version at the 8 training stage shapes: forward
         and the gradients of x and the 9 parameters within 1e-5 relative;
         forward, plain forward and backward ms from CUDA events; a raw
         ``convnext_block`` call that needs a gradient goes through it; then
         the trainable bf16 block (``convnext_block(x, p, bfloat16)`` with
         an f32 x: ``TrainableBlockBF16``, the module-mode kernel forward,
         the recompute backward through the bf16 plain twin) against
         autograd through that twin at the same shapes and B: forward and
         the 10 gradients within BF16_TOL of the largest value; kernel, plain and bound ms of the forward and
         the backward (the bound at the dense bf16 rate, the backward 3x
         the forward's operations);
     8b. the flagship's two-task loss, gradients and one optimizer step at
         B = 2, deterministic, against the JAX package's stored step
         (tests/fixtures/torch_port/flagship_fpn_train_reference.npz, the
         batch regenerated and checked by checksum): losses and the global
         gradient norm within 1e-4 relative, each leaf's gradient norm and
         projection within 1e-3 of its norm and 64 strided elements of it
         within 1e-3 of its largest magnitude; the update's norm and
         projection within 1e-3 of its norm (its elements printed); then
         the same step at bf16 against the JAX package's bf16 step run
         eagerly (TRAIN_BF16_REFERENCE): losses and the global gradient norm
         within TRAIN_BF16_TOL relative and each nearer it than the f32
         step just taken, each leaf's gradient norm within
         TRAIN_BF16_LEAF_NORM_TOL; projections, elements and updates
         printed;
     8c. for f32, then bf16: 3 warm-up and 5 timed ``train_step`` calls with
         drop path on from a seeded generator: finite losses, every
         parameter moved, exactly 36 block-kernel launches a step (all of
         the step's dtype: the module-mode bf16 kernel at bf16); ms per
         step, samples/s, peak memory; one step's device time by part from
         a torch.profiler trace (cuDNN's FFT convolutions apart), which
         also shows that every depthwise convolution of the plain version
         ran inside the blocks' backward, and the plain version's block
         forwards traced in the same place (the kernels line's times); the
         two-task forward as the step runs it, the library ops taking the
         batch in one call (``per_image`` under grad), against the same
         with one image a call; the rough neck's level-0 3x3 alone at
         the step's shape, its cuDNN kernels named and FFT marked; one step
         with remat against one without (losses within 1e-6, 72 launches);
         f32 only: the fused forwards of the trained model against its
         module path (1e-4; the weight packs rebuilt).
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
 export. the block's registered operator (``torch.ops.adascale_torch.
     convnext_block``) in its three modes against the plain twins at the
     stage shapes of both passes (f32 at REL_TOL, the two bf16 modes at
     BF16_TOL; ms through the operator); the tiny/FPN flagship's module
     model exported by ``inference.export.export_program`` on the card
     with b, h and w symbolic (both passes; the manifest must say "b,h,w",
     each graph must call the operator once a block), saved, loaded back
     with ``load_program`` and run at page_0's rough input (1 x 960 x 768)
     and precise stack (1 x 1024 x 832) and at EXPORT_SECOND_SHAPE:
     exactly 18 block launches a pass, none of the neck and heads kernels,
     each output within EXPORT_REL_TOL of the eager model's largest value
     (bit-equality printed); the loaded programs against the eager
     forwards (CUDA events, warm) and no weight pack built; the same two
     programs loaded and run in a fresh interpreter (FRESH_PROGRAM_SCRIPT,
     no precision flag set before ``load_program``) at page_0's inputs,
     held against the eager outputs at EXPORT_REL_TOL, and the rough one
     run again inside ``matmul_precision("default")`` equal to its run
     outside bit for bit (a program computes at "highest" whatever the
     scope; that interpreter runs beside the two checks that follow); the
     tiny/UPerNeXt flagship exported, loaded and held likewise
     (its bilinear resizes and adaptive pools under symbolic H and W) at
     page_0's rough input, its own precise stack and EXPORT_SECOND_SHAPE;
     a one-block bf16 program run six times packs its weights once; then
     ``python -m adascale_torch detect`` (run in this process by
     ``runpy``) on page_0 written as a PNG by ``utils/png.py`` with the
     flagship's .npz and examples/flagship_training/model.json, held
     against the JAX reference as phase 4 holds detect() (its JSON's
     polygons too), 36 block launches; the phase's seconds;
 loop. the training loop (``training.loop.train``) with each flagship's own
     configs (examples/flagship_{training,upernext}/{dataset,epoch,model,
     steps}.json: tiny at full width, B = 6, 512x512 rough and 320x320
     precise crops of 768x768 native-rendered pages, 4 spawned generator
     processes, prefetch depth 3, sample reuse 2, compute_dtype bfloat16)
     from its weights through ``init_params_path``, as LOOP_RUNS cuts them:
     the FPN flagship at bf16 (2 epochs of 6 batches, 1 dev batch), the
     UPerNeXt flagship at bf16 (1 epoch of 3, 1 dev batch) and the FPN
     flagship cut to f32 (1 epoch of 2, 1 dev batch, its pages drawn in
     the trainer's process): the renderer's g++
     build seconds, a warm 4-process pool's pages/s; for each run each
     epoch's step ms (CUDA events), wall, prefetcher stall and losses, peak
     memory; every loss finite, exactly 36 block launches a step and a dev
     batch, all of the run's dtype (the module-mode bf16 kernel at bf16),
     a checkpoint an epoch; the last one restored into a new model and
     optimizer equal bit for bit to the file (parameters, all f32, and
     both moments), its step count and lr the run's; the first run's
     exported by ``export_inference_artifact`` (f32) and served by
     ``python -m adascale_torch detect`` on page_0 (36 f32 launches, the
     polygons equal to those of an engine built in-process from the
     checkpoint's params); the phase's seconds;
 mesh. data parallelism (``adascale_torch.parallel``) at world size 1, NCCL:
     a mesh made in this process by ``create_mesh("cuda")``; the FPN
     flagship's train step at B = 6 on the mesh against the mesh-less step
     from the same state and generator, f32 then bf16 (the losses, the grad
     norm and every parameter after one step equal bit for bit, cuDNN held
     to its deterministic algorithms for the two checked steps; 36 block
     launches of the step's dtype), then a warm step of each and MESH_STEPS
     more in turn, their ms from CUDA events; phase 11's detect_many (three shift
     pages and a blank page, fused f32) on the mesh against the mesh-less
     run (maps and polygons bit for bit, MANY_LAUNCHES), the steps' and
     detect_many's times beside
     ``python -m torch.distributed.run --standalone --nproc_per_node=1 -m
     adascale_torch train --mesh`` (started at the phase's start) on
     examples/synthetic_training's configs (the "python" render backend)
     cut to MESH_CLI_EPOCH: exit 0, finite losses, 36 block launches a
     step and a dev batch (read from the metrics it prints), its data
     stall share; the host ms a page of that page config with the
     "python" and the native render backend; the phase's seconds;
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
     widths (neck 512 / 768 -> 128 / 192, heads 256-258 / 384-386, wider
     than the kernels' tiles: the neck's step1 and the heads in slices on
     one thread-block cluster a pixel tile, the neck's step2 one CTA a tile
     with every feature) on random weights against their plain twins in
     all three precisions (f32 at REL_TOL; the single-pass TF32 entries
     inside matmul_precision("default") against their TF32 twins at
     TF32_TWIN_TOL, the neck stage by stage; bf16 at BF16_TOL), the neck
     also at the widths of its other routes (WIDTH_NECK_ROUTES), and both
     heads at the base widths at a tiled group's batch (WIDTH_GROUP); the
     neck and both heads at the base and large widths at the page shapes
     (WIDTH_PAGE_HW, the neck at both passes' level-0 shapes), timed with
     their bounds and the trace's kernel names (the heads one cluster
     kernel launch a call, the neck one launch a step, none of the
     two-pass designs'); each kernel at the base widths at B = 4 bit for
     bit against each image alone (TF32 and bf16); fused detect()s of a
     random-init base model on page_0 (f32, "default" and bf16) and of a
     random-init large model (bf16) run to the end with the neck and
     heads kernels launched; the kernels line carries the wide rows
     (<name>_wide[_tf32|_bf16], the base widths at the page shape, the
     neck at 240x192); the page shapes run in a fresh interpreter
     (WIDTH_PAGE_SCRIPT), whose torch.profiler keeps its traces;
 tf32. matmul_precision "default" / "high" (one TF32 pass a product): each
     f32 kernel's single-pass TF32 entry (inside
     ``utils.precision.matmul_precision("default")``) at the flagship's
     shapes and a ragged one against its TF32 plain twin at TF32_TWIN_TOL
     (the block and the neck stage by stage on the kernel's own
     intermediates, the end-to-end difference printed beside the twin's own
     spread, ``tf32_twin_spread``), against an f64 product of the
     unrounded operands (<= TF32_F64_BAR, >= TF32_PASS_RATIO times the
     3xTF32 entry's error), its ms beside the 3xTF32 entry's, the twin's
     and the bound (products at 495 TFLOP/s, the depthwise at 67, bytes at
     3.35 TB/s), the block's stages on its own h and u (its fused form
     keeps u on chip and writes it for this check through its store-u
     pointer) and its GELUs' floor on the f32 pipes printed beside its
     bound (an estimate, GELU_INSTRUCTIONS; not in the kernels line);
     TF32_INVARIANCE_CASES (the block at B = 4 on the rough pass's stage
     shapes, the precise and rough heads and the rough neck's level 0 at
     B = 4): each image bit for bit as alone;
     detect() on page_0 at "highest", "default" and "high" for the FPN
     module path, the FPN fused configuration and the UPerNeXt one
     (f32; "highest" reused from phases 4, 5 and 9 where they ran): exact
     launches (the TF32 entries only at "default"), an engine at "high"
     equal to one at "default" bit for bit in both passes, "default"
     against "highest" at TF32_MASK_BAR, TF32_POLYGON_BAR and TF32_F1_TOL
     (char F1 against page_0's ground truth), the fused rough and precise
     forwards at B = 16 at both precisions and their device ms by kernel at
     "default" (``tf32_trace``: the block's, heads' and neck's Hopper
     designs must be the kernels that ran); the fused bf16 detect() at
     "highest" (phase bf16's, where it ran) and
     "default" against the JAX bf16 reference (phase bf16's bars); phase
     6's chunked page, phase 10's tiled page and phase 11's detect_many,
     fused at "default", their launches counted (the TF32 entries alone);
     ``tools/eval_checkpoint.evaluate`` of the FPN flagship on
     TF32_EVAL_PAGES pages of its steps.json, fused, f32 and bf16;
 tools. ``python -m adascale_torch demo`` (run in this process by
     ``runpy``) on page_0 with the FPN flagship, fused (kernels 1-4), every
     launch held against its plain twin: its ten PNGs read back equal to
     ``inference.demo.visualisations`` of its result, its remapped polygons
     equal to phase 5's; ``tools/serve_profile --pallas`` and
     ``tools/kernel_sweep`` at B = 2 x 768x768 and ``tools/train_profile``
     at B = 2 (the training crops), each f32 and bf16, run once silent with
     every block's layer scale 1 (``unit_block_scale``: at the init's 1e-6 a
     block's output is its input) and every launch held against its twin,
     and then timed (TOOLS_ITERS calls a
     row, each row with the card's name and power limit; a serve_profile row
     under its roofline bound fails); ``tools.inspect.profile_forward`` at
     TOOLS_FORWARD with a trace directory whose Chrome traces must hold
     device kernels; the kernels each tool must launch (TOOLS_PATH_KERNELS);
     the phase's seconds.

Each run counts every kernel's launches from 0 just before a path and reads
them just after; a kernel that a path runs and that was not launched fails
the run. The kernels line gives each kernel's count on its main path
(``launches``: the default detect() for the block kernel, the fused one for
the neck and heads, the train step for the trainable block (the loop's
steps, "train_loop_steps", beside it; its dev batches, "train_loop_dev",
and its detect CLI beside the block kernel's), the bf16 train step for the
trainable bf16 block, "convnext_block_trainable_bf16" (the bf16 loops'
steps and dev batches beside it; the mesh steps and the mesh CLI run
beside the trainable rows), the loaded
programs of phase export for the block's registered operator,
"convnext_block_op", the fused bf16 detect() for the bf16 entries, listed
as "<name>_bf16", the fused f32 detect() at "default" for the single-pass
TF32 entries, listed as "<name>_tf32") and on every path
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
import math
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
# bf16 training (the flagships' own compute_dtype): the flagship step at
# B = 2 against the JAX package's bf16 step run eagerly (phase 8b;
# tests/fixtures/torch_port/make_reference.py train_bf16): losses and the
# global gradient norm within TRAIN_BF16_TOL relative, each nearer that
# reference than the port's f32 step is, each leaf's gradient norm within
# TRAIN_BF16_LEAF_NORM_TOL. Measured on an H100: the losses and grad norm
# 7.3e-5 at most (the f32 step 2.1e-3, 1.2e-4, 1.7e-4), the worst leaf norm
# 3.7e-3; with the FPN heads' gradient through the product form in place of
# Flax's per-phase convolutions, the grad norm 7.1e-4.
TRAIN_BF16_REFERENCE = os.path.join(FIXTURES, "flagship_fpn_train_bf16_reference.npz")
TRAIN_BF16_TOL = 1e-3
TRAIN_BF16_LEAF_NORM_TOL = 2e-2
# The neck's level-0 3x3 of the rough pass in a B = 6 step: input channels,
# output channels, height and width.
ROUGH_NECK_L0_CONV = (384, 96, 128, 128)
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
PHASES = ("3", "3b", "4", "5", "6", "7", "8a", "8b", "8c", "9", "10", "11", "12", "export", "loop", "mesh", "bf16",
          "widths", "tf32", "tools")
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
# random weights at B = 2 and a 64x48 level 0; the fused detect()s of
# random-init base and large models on page_0.
WIDTH_PRESETS = {"base": (128, 512), "large": (192, 768)}
WIDTH_BATCH, WIDTH_HW = 2, (64, 48)
# The heads of the base widths again at a tiled group's batch (8 tiles of
# 768, a 192x192 level 0).
WIDTH_GROUP = ("base", 8, (192, 192))
# The wide heads at the page shapes, B = 1 (page_0's rough level 0, and a
# precise stack of 1024x832), timed in each precision; and at B = 4 on a
# ragged map, bit for bit against each image alone.
WIDTH_PAGE_HW = {"fpn_heads": (240, 192), "precise_heads": (256, 208)}
WIDTH_INVARIANCE = (4, (60, 44))
# The wide heads' kernels (one launch a call: a pixel tile's feature slices
# on one thread-block cluster), and the two-pass design's, which they
# replaced and which must not run.
WIDE_HEADS_KERNELS = ("heads_cluster_tma_kernel", "heads_cluster_kernel")
STALE_WIDE_KERNELS = ("heads_sums_kernel", "heads_ln_kernel")
# The wide neck at both passes' level-0 shapes (page_0's rough pass, its
# 1024x832 precise stack), B = 1; its kernels, one launch a step (step1 on
# a cluster, step2 one CTA a tile), and the split design's (its pre-LN sums
# kernels and second pass), which must not run.
WIDTH_NECK_PAGE_HW = ((240, 192), (256, 208))
WIDE_NECK_STEP1 = ("neck_step1_cluster_tma_kernel", "neck_step1_cluster_kernel")
WIDE_NECK_STEP2 = ("neck_step2_wide_tma_kernel", "neck_step2_wide_kernel")
STALE_WIDE_NECK_KERNELS = ("ln_gelu_rows", "neck_step1_kernel<float, true", "neck_step1_kernel<__nv_bfloat16, true",
                           "neck_step2_kernel<float, true", "neck_step2_kernel<__nv_bfloat16, true")
# The neck at widths whose routes the base and large widths do not take
# (C0, Cm, Co; B = 2 at WIDTH_HW): W1 past every resident slice (bf16
# streamed, TF32 on conv_gemm.cuh's loop at one pass), a last slice of 8
# features, Co = 264 on a cluster of two; TF32 past the 256-wide resident
# W1 with step2 at N = 192 for Co = 136.
WIDTH_NECK_ROUTES = ((384, 520, 264), (256, 512, 136))


# Empty torch.profiler traces taken again (kernel_device_ms), by the phase
# that was running: printed at the end, so that a run that loses more
# traces than another shows where.
TRACE_RETRIES: dict = {}
PHASE = ["start"]


def stamp(phase: str) -> None:
    if phase.startswith("phase "):
        PHASE[0] = phase.split(":")[0][len("phase "):]
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


def kernel_device_ms(fn, reps: int = 10, once_a_call: bool = False, tries: int = 6, match: str = ""):
    """Device ms per call of each kernel that ``fn`` runs on the card, by its
    name in a torch.profiler trace of ``reps`` warm calls. The profiler
    loses launches now and then (a run of every phase lost about half of
    phase bf16's; a trace may keep none), and this reads a trace as
    ``tools/kernel_ms.py`` does: ``once_a_call``, each kernel launches once
    a call, so its mean launch is its ms a call, which a partial loss does
    not bias; a trace that kept no launch (none whose name holds ``match``,
    where given) is taken again, up to ``tries`` times (each counted in
    TRACE_RETRIES under the running phase). A kernel whose launches in the trace are not a whole multiple
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
        if any(match in e.key for e in events):
            break
        TRACE_RETRIES[PHASE[0]] = TRACE_RETRIES.get(PHASE[0], 0) + 1
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
    kernels' f32 libraries (the neck's and heads' hold their bf16 and TF32
    entries too), the block's TF32 library and its two bf16 libraries
    (Pallas and module mode)."""
    from concurrent.futures import ThreadPoolExecutor

    from adascale_torch.kernels import _nvcc, convnext_block

    modules = kernel_modules()
    builds = {name: m.build for name, m in modules.items()}
    builds["convnext_block_tf32"] = convnext_block.build_tf32
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
    "blocks": ("dw_ln_kernel", "gemm_3xtf32_kernel", "reduce_kernel", "dw_ln_pairs_kernel", "mlp_fused_kernel",
               "gemm_wgmma_kernel", "reduce_bf16_kernel", "mlp_fused_tf32_kernel", "gemm_tf32_wgmma_kernel"),
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


def block_bf16_backward_work(npix: int, c: int):
    """(bf16 flops, f32 flops, bytes) of one trainable bf16 block's backward
    (``TrainableBlockBF16.backward``: the forward recomputed, then both
    gradients of each projection and of the depthwise: three times the
    forward's operations, the projections at the bf16 rate): x, the
    parameters and the output's gradient read once, x's and the
    parameters' gradients written once, in f32."""
    mlp, dw, _ = block_work_bf16(npix, c, 4)
    params = 4 * (49 * c + 8 * c * c + 10 * c)
    return 3 * mlp, 3 * dw, 4 * 3 * npix * c + 2 * params


def bound_of(work) -> tuple:
    """(ops ms, bytes ms) of (bf16 flops, f32 flops, bytes) at the card's
    bf16 and f32 peaks and memory rate."""
    flops16, flops32, nbytes = work
    return (flops16 / PEAK_BF16_FLOPS + flops32 / PEAK_F32_FLOPS) * 1e3, nbytes / PEAK_BYTES * 1e3


def check_trainable_block_bf16(gen, device):
    """Phase 8a, bf16: the trainable bf16 block (``convnext_block(x, p,
    bfloat16)`` with an f32 x that needs a gradient: ``TrainableBlockBF16``,
    the module-mode kernel forward, the recompute backward) against autograd
    through its bf16 plain twin at the training stage shapes at B =
    TRAIN_BATCH, as the bf16 step launches it: the forward and the gradients
    of x and the 9 parameters within BF16_TOL of the largest value; kernel,
    plain and bound ms for the forward and the backward (CUDA events).
    Returns the kernels line's errors and bound (summed over one step's 36
    blocks; its times come from phase 8c's bf16 step)."""
    import torch

    from adascale_torch.kernels import convnext_block as K

    bf16 = torch.bfloat16
    names = ("x",) + K.PARAM_NAMES
    step = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    worst, max_abs = (0.0, ""), 0.0
    for (h, w, c), blocks in TRAIN_STAGE_SHAPES:
        p = {k: v.requires_grad_() for k, v in random_block_params(c, gen, device).items()}
        x = torch.randn(TRAIN_BATCH, h, w, c, generator=gen).to(device).requires_grad_()
        g = torch.randn(TRAIN_BATCH, h, w, c, generator=gen).to(device)
        inputs = [x] + [p[k] for k in K.PARAM_NAMES]
        before = K.LAUNCHES_BF16
        out = K.convnext_block(x, p, bf16)
        if "TrainableBlockBF16" not in type(out.grad_fn).__name__ or K.LAUNCHES_BF16 != before + 1:
            raise AssertionError(f"bf16 block with a gradient: grad_fn={out.grad_fn}, "
                                 f"{K.LAUNCHES_BF16 - before} launches")
        want = K.convnext_block_plain_bf16(x, p, True)
        errs = {"forward": rel_err(out.detach(), want.detach())}
        max_abs = max(max_abs, float((out - want).detach().abs().max()))
        got_grads = torch.autograd.grad(out, inputs, g, retain_graph=True)
        want_grads = torch.autograd.grad(want, inputs, g, retain_graph=True)
        errs.update({f"d{n}": rel_err(a, b) for n, a, b in zip(names, got_grads, want_grads)})
        bad = {k: v for k, v in errs.items() if not v <= BF16_TOL}
        if bad:
            raise AssertionError(f"trainable bf16 block {h}x{w}x{c}: relative errors {bad} > {BF16_TOL}")
        xd, pd = x.detach(), {k: v.detach() for k, v in p.items()}
        ms = cuda_ms(lambda: K.convnext_block(xd, pd, bf16))
        plain_ms = cuda_ms(lambda: K.convnext_block_plain_bf16(xd, pd, True))
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, inputs, g, retain_graph=True))
        plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(want, inputs, g, retain_graph=True))
        npix = TRAIN_BATCH * h * w
        fwd, bwd = bound_of(block_work_bf16(npix, c, 4)), bound_of(block_bf16_backward_work(npix, c))
        for key, (t_ops, t_bytes) in (("fwd", fwd), ("bwd", bwd)):
            step[key][0] += blocks * t_ops
            step[key][1] += blocks * t_bytes
        name, err = max(errs.items(), key=lambda kv: kv[1])
        worst = max(worst, (err, f"{h}x{w}x{c} {name}"))
        grads_only = {k: v for k, v in errs.items() if k != "forward"}
        print(
            f"trainable bf16 block B={TRAIN_BATCH} {h}x{w}x{c}: rel err forward={errs['forward']:.3e} "
            f"worst grad {max(grads_only, key=grads_only.get)}={max(grads_only.values()):.3e}; "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={max(fwd):.4f} ({'operations' if fwd[0] >= fwd[1] else 'bytes'}, bf16); "
            f"backward_ms={bwd_ms:.4f} (recompute + autograd of the bf16 plain twin) plain_backward_ms={plain_bwd_ms:.4f} "
            f"backward_bound_ms={max(bwd):.4f}; blocks_per_step={blocks}",
            flush=True,
        )
        del out, want, got_grads, want_grads
    print(
        f"trainable bf16 block, one B={TRAIN_BATCH} train step's 36 blocks: forward bound_ms="
        f"{max(step['fwd']):.4f}; backward bound_ms={max(step['bwd']):.4f}; worst rel err {worst[0]:.3e} ({worst[1]})",
        flush=True,
    )
    return {
        "max_abs_err": max_abs,
        "max_rel_err": worst[0],
        "bound_ms": max(step["fwd"]),
        "bound_by": "operations" if step["fwd"][0] >= step["fwd"][1] else "bytes",
        "bound_rate": "forward only: projections at the dense bf16 rate, 989 TFLOP/s; depthwise at 67 TFLOP/s f32",
        "backward_bound_ms": max(step["bwd"]),
        "backward_bound_by": "operations" if step["bwd"][0] >= step["bwd"][1] else "bytes",
    }


def flagship_model(params, device, dtype=None):
    import torch

    from adascale_torch import AdaptiveScaling, AdaptiveScalingConfig
    from adascale_torch.utils.params import state_dict_from_jax

    model = AdaptiveScaling(AdaptiveScalingConfig(size="tiny", neck_head_type="fpn"), dtype or torch.float32)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.to(device)


def check_train_reference(params, device, compute_dtype: str = "float32", f32=None) -> dict:
    """Phase 8b: the flagship's two-task loss, gradients and one optimizer
    step against the JAX package's stored step; at ``compute_dtype=
    "bfloat16"`` against its bf16 step (TRAIN_BF16_REFERENCE), at the bf16
    bars, ``f32`` being this phase's f32 result (the port's f32 step must
    lie farther from the bf16 reference than its bf16 step does)."""
    import numpy as np
    import torch

    from adascale_torch.training import (
        OptimizerConfig, TrainStepConfig, batch_checksum, build_optimizer, seeded_batches,
        two_task_loss, upcast_batch,
    )
    from adascale_torch.training.optimizer import global_norm
    from adascale_torch.utils.params import leaf_fingerprints, leaf_sample

    bf16 = compute_dtype == "bfloat16"
    ref = np.load(TRAIN_BF16_REFERENCE if bf16 else TRAIN_REFERENCE)
    if (str(ref["compute_dtype"]) if "compute_dtype" in ref else "float32") != compute_dtype:
        raise AssertionError(f"the reference is not a {compute_dtype} step")
    rough, precise, rough_box, precise_box = seeded_batches(int(ref["seed"]), int(ref["batch_size"]))
    checksum = batch_checksum(rough, precise)
    if checksum != str(ref["checksum"]):
        raise AssertionError(f"the regenerated batch differs from the reference's ({checksum})")
    model = flagship_model(params, device, torch.bfloat16 if bf16 else torch.float32)
    cfg = TrainStepConfig(rough_core_box=rough_box, precise_core_box=precise_box, compute_dtype=compute_dtype)
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
    values = {"rough_loss": r_loss.item(), "precise_loss": p_loss.item(), "grad_norm": norm,
              "leaf_norms": {k: float(v.double().norm()) for k, v in grads.items()}}
    if bf16:
        return check_bf16_step(ref, names, values, loss_errs, grad_prints, grad_elements, update_errs, f32)
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
            "worst_update_element": update_elements[worst_update_element], "values": values}


def check_bf16_step(ref, names, values, loss_errs, grad_prints, grad_elements, update_errs, f32) -> dict:
    """Phase 8b's bf16 bars (TRAIN_BF16_*): the losses and the global
    gradient norm near the JAX bf16 step and nearer it than the port's f32
    step; each leaf's gradient norm; the leaves' projections, sampled
    elements and updates printed."""
    f32_errs = {k: abs(f32["values"][k] - float(ref[k])) / abs(float(ref[k])) for k in loss_errs}
    leaf_norm = {k: abs(values["leaf_norms"][k] - n) / max(float(n), 1e-30)
                 for k, n in zip(names, ref["grad_norms"])}
    f32_leaf = {k: abs(f32["values"]["leaf_norms"][k] - n) / max(float(n), 1e-30)
                for k, n in zip(names, ref["grad_norms"])}
    worst = max(leaf_norm, key=leaf_norm.get)
    nearer = sum(leaf_norm[k] < f32_leaf[k] for k in names)
    worst_print = max(grad_prints, key=grad_prints.get)
    worst_element = max(grad_elements, key=grad_elements.get)
    worst_update = max(update_errs, key=update_errs.get)
    print(
        f"flagship two-task step at bf16 vs JAX bf16 (eager; B={int(ref['batch_size'])}, deterministic): "
        f"rough_loss={values['rough_loss']:.7f} (jax {float(ref['rough_loss']):.7f}) precise_loss="
        f"{values['precise_loss']:.7f} (jax {float(ref['precise_loss']):.7f}) grad_norm={values['grad_norm']:.6f} "
        f"(jax {float(ref['grad_norm']):.6f}); rel errs "
        + " ".join(f"{k}={v:.3e}" for k, v in loss_errs.items())
        + "; the port's f32 step against the same reference: "
        + " ".join(f"{k}={v:.3e}" for k, v in f32_errs.items())
        + f"; worst leaf gradient norm {worst} {leaf_norm[worst]:.3e} (f32 step {f32_leaf[worst]:.3e}); "
        f"{nearer} of {len(names)} leaf norms nearer than the f32 step's; no bar: the worst norm or projection "
        f"{worst_print} {grad_prints[worst_print]:.3e} of its norm, the worst sampled element {worst_element} "
        f"{grad_elements[worst_element]:.3e} of its "
        f"largest magnitude, the worst update {worst_update} {update_errs[worst_update]:.3e} of its norm",
        flush=True,
    )
    if not max(loss_errs.values()) <= TRAIN_BF16_TOL:
        raise AssertionError(f"bf16 losses / grad norm vs JAX bf16: {loss_errs} > {TRAIN_BF16_TOL}")
    farther = [k for k in loss_errs if not loss_errs[k] < f32_errs[k]]
    if farther:
        raise AssertionError(f"bf16 step not nearer the JAX bf16 step than the f32 step in {farther}: "
                             f"{loss_errs} vs {f32_errs}")
    if not leaf_norm[worst] <= TRAIN_BF16_LEAF_NORM_TOL:
        raise AssertionError(f"bf16 leaf gradient norm {worst}: {leaf_norm[worst]} > {TRAIN_BF16_LEAF_NORM_TOL}")
    return {"losses": loss_errs, "f32_losses": f32_errs, "worst_leaf_norm": leaf_norm[worst],
            "leaf_norms_nearer": nearer, "values": values}


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
    ``convnext_block_plain`` (``TrainableBlockBF16`` its bf16 twin) in place
    of the kernel, under a range, for this one measurement (no kernel
    launch, nothing counted, no update)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from adascale_torch.kernels import convnext_block as K
    from adascale_torch.training import two_task_loss, upcast_batch

    bf16 = cfg.compute_dtype == "bfloat16"
    name = "_launch_bf16" if bf16 else "_launch"

    def plain(x, p, *module):
        with torch.profiler.record_function("convnext_block.plain_forward"):
            return K.convnext_block_plain_bf16(x, p, *module) if bf16 else K.convnext_block_plain(x, p)

    launch = getattr(K, name)
    setattr(K, name, plain)
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
        setattr(K, name, launch)
    model.zero_grad()
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = sum(
        1 for e in events if e.device_type == DeviceType.CPU and e.name == "convnext_block.plain_forward"
    )
    if ranges != blocks_per_step:
        raise AssertionError(f"plain forward ranges {ranges} != {blocks_per_step}")
    return range_device_ms(events, "convnext_block.plain_forward")


def is_fft_kernel(name: str) -> bool:
    """A kernel of cuDNN's FFT convolution: an FFT, or the complex GEMM
    between the transforms (``..._cf32cf32_...``)."""
    return "fft" in name.lower() or "cf32" in name


def step_device_split(prof) -> dict:
    """One train step's device ms by part, from a torch.profiler trace: the
    block kernel's forwards (by kernel name), the blocks' backward (the
    kernels under ``convnext_block.backward``: recompute and autograd of the
    plain version), the optimizer (under ``optimizer.step``), the rest
    (stem, stage LNs, downsamples, neck and heads forward and backward
    through cuDNN and cuBLAS, losses) and the whole; of the rest, cuDNN's
    FFT convolutions apart (``fft``: ``is_fft_kernel``). Also checks that every
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
        "dw_ln_launches": sum(1 for e in kernels if "dw_ln_kernel" in e.name or "dw_ln_pairs_kernel" in e.name),
        # cuDNN's FFT convolutions: its FFT kernels and the complex GEMMs
        # between them (kernel names with "fft" or "cf32").
        "fft": sum(e.device_time_total for e in kernels if is_fft_kernel(e.name)) / 1e3,
    }


def train_steps(params, device, compute_dtype: str = "float32") -> dict:
    """Phase 8c: warm-up and timed train steps with drop path; the launch
    count, a traced step, the fused forwards after training (f32) and remat.
    At bf16 also what one image a library call would cost the step
    (``per_image``) and whether the rough neck's level-0 3x3 runs on cuDNN's
    FFT path."""
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

    bf16 = compute_dtype == "bfloat16"
    model = flagship_model(params, device, torch.bfloat16 if bf16 else torch.float32)
    rough, precise, rough_box, precise_box = seeded_batches(1, TRAIN_BATCH)
    cfg = TrainStepConfig(rough_core_box=rough_box, precise_core_box=precise_box, compute_dtype=compute_dtype)
    blocks_per_step = 2 * len(model.backbone.blocks())
    label = f"train step ({compute_dtype})"

    def block_launches():
        """This dtype's block launches; the other dtype's must be none."""
        mine, other = (K.LAUNCHES_BF16, K.LAUNCHES) if bf16 else (K.LAUNCHES, K.LAUNCHES_BF16)
        if other:
            raise AssertionError(f"{label}: {other} block launches of the other dtype")
        return mine
    x_rough = upcast_batch(rough, device)["image"]
    x_precise = upcast_batch(precise, device)["image"]

    def fused_forwards():
        with torch.inference_mode():
            return (
                forward_rough_from_features_fused(model, model.backbone(x_rough)),
                forward_precise_from_features_fused(model, model.backbone(x_precise)),
            )

    if not bf16:
        fused_forwards()  # weight packs for the weights before training
    opt, _ = build_optimizer(dict(model.named_parameters()), OptimizerConfig(), steps_per_epoch=1000)
    step = make_train_step(model, opt, cfg, device=str(device))
    gen = torch.Generator(device=device).manual_seed(0)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, launches = [], []

    def counted_step():
        K.LAUNCHES = K.LAUNCHES_BF16 = 0
        metrics.append(step(rough, precise, gen))
        launches.append(block_launches())

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
        f"{label}, warm-up and timed steps (B={TRAIN_BATCH}, drop path on): losses (rough, precise, grad norm) "
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
        f"{label}: {step_ms:.3f} ms a step (CUDA events over {TIMED_STEPS} steps, warm; host wall "
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
    print(f"{label}, device ms by part (torch.profiler, one step): "
          + ", ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}" for k, v in split.items()),
          flush=True)
    plain_ms = plain_forward_device_ms(model, rough, precise, cfg, device, blocks_per_step)
    print(f"{label}, the blocks' forwards by the plain version instead (torch.profiler, one "
          f"forward and backward): {plain_ms:.3f} device ms against the kernel's "
          f"{split['blocks_forward_kernel']:.3f}", flush=True)
    out = {"step_ms": step_ms, "samples_per_s": TRAIN_BATCH / step_ms * 1e3, "peak_bytes": peak,
           "launches": launches[-1], "split": split, "plain_forward_ms": plain_ms}
    out.update(step_conv_costs(model, rough, precise, cfg, device, model.dtype))
    out["remat"] = check_remat(model, rough, precise, cfg, device, blocks_per_step, block_launches)
    if bf16:
        return out

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
    return out


def check_remat(model, rough, precise, cfg, device, blocks_per_step: int, block_launches) -> float:
    """remat against no remat on one step's loss: the same losses
    (REMAT_TOL), twice the block forwards. Returns the relative error."""
    import torch

    from adascale_torch.kernels import convnext_block as K
    from adascale_torch.training import two_task_loss, upcast_batch

    remat_losses = []
    for remat in (False, True):
        model.zero_grad()
        K.LAUNCHES = K.LAUNCHES_BF16 = 0
        total, (r_loss, p_loss) = two_task_loss(
            model, upcast_batch(rough, device), upcast_batch(precise, device),
            dataclasses.replace(cfg, remat=remat), False, torch.Generator(device=device).manual_seed(5),
        )
        total.backward()
        remat_losses.append((float(r_loss.detach()), float(p_loss.detach()), block_launches()))
    model.zero_grad()
    (r0, p0, n0), (r1, p1, n1) = remat_losses
    remat_err = max(abs(r1 - r0) / abs(r0), abs(p1 - p0) / abs(p0))
    print(f"remat ({cfg.compute_dtype}): losses {r1:.7f}, {p1:.7f} vs {r0:.7f}, {p0:.7f} (rel err "
          f"{remat_err:.3e}); block launches {n1} vs {n0}", flush=True)
    if not remat_err <= REMAT_TOL or n1 != 2 * blocks_per_step or n0 != blocks_per_step:
        raise AssertionError(f"remat: rel err {remat_err}, launches {n1} / {n0}")
    return remat_err


@contextlib.contextmanager
def library_ops_one_image_a_call():
    """Within: the models' library ops take one image a call with grad
    enabled too (``per_image`` as serving runs it), to time what that would
    cost the step."""
    import torch

    from adascale_torch.models import convnext, fpn

    saved = convnext.per_image, fpn.per_image
    convnext.per_image = fpn.per_image = lambda fn, x: torch.cat([fn(x[i : i + 1]) for i in range(x.shape[0])])
    try:
        yield
    finally:
        convnext.per_image, fpn.per_image = saved


def step_conv_costs(model, rough, precise, cfg, device, dtype) -> dict:
    """What the step's library convolutions cost, in ``dtype``: the two-task
    forward at the step's batch, grad enabled, as it runs (the batch in one
    library call, ``models/convnext.py::per_image`` under grad) against the
    same with one image a call (``library_ops_one_image_a_call``), CUDA
    events, warm; and the kernels that cuDNN runs for the rough neck's
    level-0 3x3 (ROUGH_NECK_L0_CONV at B = TRAIN_BATCH) forward and backward
    alone, from a torch.profiler trace, FFT ones marked."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from adascale_torch.training import two_task_loss, upcast_batch

    r, q = upcast_batch(rough, device), upcast_batch(precise, device)

    def forward():
        model.zero_grad()
        return two_task_loss(model, r, q, cfg, True)[0]

    batched_ms = cuda_ms(forward, reps=3)
    with library_ops_one_image_a_call():
        per_image_ms = cuda_ms(forward, reps=3)
    model.zero_grad()
    cin, cout, h, w = ROUGH_NECK_L0_CONV
    x = torch.randn(TRAIN_BATCH, cin, h, w, device=device, dtype=dtype).to(
        memory_format=torch.channels_last).requires_grad_()
    weight = (torch.randn(cout, cin, 3, 3, device=device) * cin ** -0.5).to(dtype).requires_grad_()
    y = F.conv2d(x, weight, padding=1)
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        y = F.conv2d(x, weight, padding=1)
        y.backward(torch.ones_like(y))
        torch.cuda.synchronize()
    conv_kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            conv_kernels[e.name] = conv_kernels.get(e.name, 0.0) + e.device_time_total / 1e3
    fft = {k: v for k, v in conv_kernels.items() if is_fft_kernel(k)}
    print(f"train step ({cfg.compute_dtype}) forward at B={TRAIN_BATCH}, library ops one image a call (per_image, "
          f"as serving runs them): {per_image_ms:.3f} ms against the batch in one call (as the step runs): "
          f"{batched_ms:.3f} ms (CUDA events, warm); the rough neck's level-0 3x3 "
          f"({TRAIN_BATCH}x{cin}x{h}x{w} -> {cout}) forward and backward alone: "
          f"{sum(conv_kernels.values()):.3f} device ms, cuDNN's FFT path {'taken' if fft else 'not taken'} "
          f"(FFT kernels {sum(fft.values()):.3f} ms); its kernels: "
          + "; ".join(f"{k[:80]}={v:.3f}" for k, v in sorted(conv_kernels.items(), key=lambda kv: -kv[1])[:6]),
          flush=True)
    return {"per_image_forward_ms": per_image_ms, "batched_forward_ms": batched_ms,
            "neck_l0_conv_ms": sum(conv_kernels.values()), "neck_l0_conv_fft_ms": sum(fft.values())}


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
    """Run ``fn`` with every kernel's launch count (f32, bf16 and single-pass
    TF32) set to 0 just before and read just after; returns its result and
    the counts (the f32 kernels' under their names, the bf16 ones' under
    "<name>_bf16", the TF32 entries' under "<name>_tf32")."""
    import torch

    modules = kernel_modules()
    for m in modules.values():
        m.LAUNCHES = m.LAUNCHES_BF16 = m.LAUNCHES_TF32 = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {name: m.LAUNCHES for name, m in modules.items()}
    # The bf16 and TF32 entries' launches, under "<name>_bf16" and
    # "<name>_tf32", where there were any.
    counts.update({f"{name}_bf16": m.LAUNCHES_BF16 for name, m in modules.items() if m.LAUNCHES_BF16})
    counts.update({f"{name}_tf32": m.LAUNCHES_TF32 for name, m in modules.items() if m.LAUNCHES_TF32})
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
    "<name>_bf16"; a single-pass TF32 launch against its TF32 twin at
    TF32_HELD_TOL, under "<name>_tf32").
    ``worst[name]`` gathers each kernel's launches, input shapes and largest
    relative error. The plain twins launch nothing, so the counts move as
    they would without the check."""
    import torch

    from adascale_torch.kernels import convnext_block, fpn_heads, fpn_neck, precise_heads
    from adascale_torch.utils.precision import tf32_products

    def block_plain(x, p, tf32=False, workspace=None):
        return convnext_block.convnext_block_plain(x, p, tf32)

    # (name, module, function, plain twin, kind): kind "f32", "bf16", or
    # None where the input's dtype and the precision scope decide it.
    hooks = [
        ("convnext_block", convnext_block, "_launch", block_plain, "f32"),
        ("convnext_block", convnext_block, "_launch_bf16", convnext_block.convnext_block_plain_bf16, "bf16"),
        ("fpn_neck_l0", fpn_neck, "fused_neck_l0", fpn_neck.fused_neck_l0_plain, None),
        ("fpn_heads", fpn_heads, "fused_rough_heads", fpn_heads.fused_rough_heads_plain, None),
        ("precise_heads", precise_heads, "fused_precise_heads", precise_heads.fused_precise_heads_plain, None),
    ]

    def checked(name, kernel, plain, kind):
        def call(x, *args):
            got = kernel(x, *args)
            bf16 = kind == "bf16" or (kind is None and x.dtype == torch.bfloat16)
            if kind == "f32":
                tf32 = bool(args[1]) if len(args) > 1 else False
                want = plain(x, *args)
            else:
                tf32 = not bf16 and tf32_products()
                want = plain(x, *args, tf32=True) if tf32 else plain(x, *args)
            gs, ws = ([v] if torch.is_tensor(v) else list(v) for v in (got, want))
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(gs, ws))
            rel = err / (max(float(w.float().abs().max()) for w in ws) or 1.0)
            key = f"{name}_bf16" if bf16 else f"{name}_tf32" if tf32 else name
            tol = BF16_TOL if bf16 else TF32_HELD_TOL if tf32 else REL_TOL
            row = worst.setdefault(key, {"launches": 0, "shapes": set(), "rel": 0.0})
            row["launches"] += 1
            row["shapes"].add(tuple(x.shape))
            row["rel"] = max(row["rel"], rel)
            if not rel <= tol:
                raise AssertionError(f"{key} at {tuple(x.shape)}: relative error {rel} > {tol}")
            return got

        return call

    saved = [(module, attr, getattr(module, attr)) for _, module, attr, _, _ in hooks]
    for name, module, attr, plain, kind in hooks:
        setattr(module, attr, checked(name, getattr(module, attr), plain, kind))
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
    return {"launches": launches, "engine": engine, "result": result,
            **timed_forwards("UPerNeXt", engine, x_rough, x_precise)}


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
    Returns the kernels line's bf16 entries, the paths' launches and the
    fused FPN detect() of page_0."""
    import numpy as np

    from adascale_torch.tools.bf16_drift import drift, format_drift

    rows = check_bf16_kernels(gen, device)
    stamp("bf16: detect() against the JAX bf16 references")
    by_path, results, parity = check_bf16_detects(image)
    # page_0's fused bf16 detect() (the same configuration as the engines
    # below) serves the forwards' inputs and detect_many; the drift runs its
    # bf16 detect() at "default", as the JAX tool does.
    fused = results["fpn_fused"]
    engines = bf16_engines(params)
    stamp("bf16: the flagship's forwards, f32 against bf16")
    rows["forwards"] = bf16_forward_times(engines, image, fused)
    stamp("bf16: detect_many against single-page detect()")
    by_path["detect_many_bf16"] = check_bf16_many(engines[("bfloat16", True)], fused)
    stamp("bf16: drift against f32 (adascale_torch.tools.bf16_drift: f32 at \"highest\", bf16 at \"default\")")
    page = np.load(SHIFT_PAGES[0])
    d = drift(params, engines[("float32", True)].config, page["image"], list(page["corners"]))
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
    return rows, by_path, fused


def widths_bound_ms(name: str, b: int, h: int, w: int, c0: int, cm: int, co: int, heads, precision: str):
    """(bound ms, what bounds it) of a neck or heads call of phase widths:
    the operations at the kernel's rate (f32: three TF32 products a product
    at the dense TF32 peak; "tf32": one; bf16: the dense bf16 peak) against
    the bytes (each input read once, each output written once, activations
    and weights in the kernel's operand type, the vectors and the heads'
    f32 maps) at the memory rate, as phases 3b and bf16 count them."""
    npix = b * h * w
    if name == "fpn_neck_l0":
        flops, f32_bytes = neck_work(b, h, w, c0, cm, co)
        bf16_bytes = 2 * (npix * (c0 + cm + co) + c0 * cm + 9 * cm * co) + 4 * 3 * (cm + co)
    else:
        flops, f32_bytes = heads_work(b, h, w, cm, heads)
        fsum = sum(p["step1.conv.weight"].shape[0] for p in heads)
        outs = sum(p["step2.weight"].shape[0] for p in heads)
        bf16_bytes = 2 * (npix * cm + 16 * cm * fsum) + 4 * (4 * npix * outs)
    if precision == "bf16":
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, bf16_bytes / PEAK_BYTES * 1e3
    else:
        passes = 3 if precision == "f32" else 1
        t_ops, t_bytes = passes * flops / PEAK_TF32_FLOPS * 1e3, f32_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def widths_call(kernel, precision: str):
    """``kernel`` as phase widths calls it in ``precision``: f32 at
    "highest", "tf32" inside ``matmul_precision("default")`` (the
    single-pass TF32 entries), bf16 on bf16 inputs (the caller's)."""
    from adascale_torch.utils.precision import matmul_precision

    if precision != "tf32":
        return kernel

    def call(*a):
        with matmul_precision("default"):
            return kernel(*a)

    return call


def check_width_case(label: str, name: str, kernel, plain, a, precision: str, bound) -> dict:
    """One kernel call of phase widths against its plain twin in
    ``precision`` (f32 at REL_TOL; "tf32" against the TF32 twin at
    TF32_TWIN_TOL, the neck stage by stage on its own t as phase tf32 holds
    it; bf16 at BF16_TOL), launched once, counted under its entry's name;
    prints and returns the error and the kernel, plain and bound ms."""
    import torch

    call = widths_call(kernel, precision)
    twin = (lambda *v: plain(*v, tf32=True)) if precision == "tf32" else plain
    got, launches = counted(lambda: call(*a))
    want = twin(*a)
    gs, ws = ([v] if torch.is_tensor(v) else list(v) for v in (got, want))
    err = max(float((g.float() - w_.float()).abs().max()) for g, w_ in zip(gs, ws))
    rel = err / max(float(w_.float().abs().max()) for w_ in ws)
    staged = {}
    if precision == "tf32" and name == "fpn_neck_l0":
        staged = {stage: float((k - t_).abs().max()) / float(t_.abs().max()) for stage, k, t_ in neck_tf32_stages(*a)}
    ms = cuda_ms(lambda: call(*a), reps=3)
    plain_ms = cuda_ms(lambda: twin(*a), reps=3)
    t_bound, by = bound
    print(
        f"{label} {precision} at {tuple(a[0].shape)}: max_abs_err={err:.3e} rel={rel:.3e} "
        + " ".join(f"{k}={v:.3e}" for k, v in staged.items())
        + f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={t_bound:.4f} ({by}) "
        f"share_of_bound={t_bound / ms:.3f} LAUNCHES={launches}",
        flush=True,
    )
    key = {"f32": name, "tf32": f"{name}_tf32", "bf16": f"{name}_bf16"}[precision]
    tol = {"f32": REL_TOL, "tf32": TF32_TWIN_TOL, "bf16": BF16_TOL}[precision]
    worst = max(staged.values()) if staged else rel
    if launches.get(key) != 1 or not worst <= tol:
        raise AssertionError(f"{label} {precision}: rel {rel} {staged} > {tol} or {launches}")
    return {"max_abs_err": err, "rel": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bound, "bound_by": by}


def wide_heads_cases(x, rough, precise):
    """(name, kernel, plain, args of a dtype, heads) of both heads over x."""
    from adascale_torch.kernels import fpn_heads, precise_heads

    return [
        ("fpn_heads", fpn_heads.fused_rough_heads, fpn_heads.fused_rough_heads_plain,
         lambda d: (x.to(d), *rough), rough),
        ("precise_heads", precise_heads.fused_precise_heads, precise_heads.fused_precise_heads_plain,
         lambda d: (x.to(d), precise), precise),
    ]


def wide_neck_trace(call) -> dict:
    """The device ms a call of a wide neck call's kernels by name, from a
    torch.profiler trace of 3 calls (``kernel_device_ms``), taken again
    (counted in TRACE_RETRIES) while it kept no launch of step1 or of
    step2, up to 6 times."""
    for _ in range(6):
        traced = kernel_device_ms(call, reps=3, once_a_call=True, match="neck_")
        found = {short_kernel_name(k): v for k, v in traced.items() if "neck_" in k or "ln_gelu_rows" in k}
        if any(k.startswith(("neck_step1_", "ln_gelu")) for k in found) and any(k.startswith("neck_step2_")
                                                                                for k in found):
            return found
        TRACE_RETRIES[PHASE[0]] = TRACE_RETRIES.get(PHASE[0], 0) + 1
        print(f"torch.profiler kept a wide neck call's launches only in part ({list(found)}); tracing again",
              flush=True)
    return found


def widths_page(gen, device) -> tuple:
    """Both heads at the base and large widths at the page shapes
    (WIDTH_PAGE_HW, B = 1), and the neck at both passes' level-0 shapes
    (WIDTH_NECK_PAGE_HW), in each precision: ``check_width_case`` and the
    device ms a call by kernel name from a torch.profiler trace. Returns
    (the kernels line's rows, the base widths', by "<name>_wide[_tf32|_bf16]",
    the neck's at 240x192; the kernel names, by "preset|name|precision",
    the neck's name with its shape)."""
    import torch

    from adascale_torch.kernels import fpn_neck

    dtype_of = {"f32": torch.float32, "tf32": torch.float32, "bf16": torch.bfloat16}
    suffix_of = {"f32": "", "tf32": "_tf32", "bf16": "_bf16"}
    rows, names = {}, {}
    for preset, (c0, cm) in WIDTH_PRESETS.items():
        co = cm // 4
        p = random_neck_params(c0, cm, co, gen, device)
        for h, w in WIDTH_NECK_PAGE_HW:
            f0 = torch.randn(1, h, w, c0, generator=gen).to(device)
            u = torch.randn(1, h, w, cm, generator=gen).to(device)
            for precision in dtype_of:
                a = (f0.to(dtype_of[precision]), u.to(dtype_of[precision]), p)
                row = check_width_case(f"widths page {preset} fpn_neck_l0", "fpn_neck_l0", fpn_neck.fused_neck_l0,
                                       fpn_neck.fused_neck_l0_plain, a, precision,
                                       widths_bound_ms("fpn_neck_l0", 1, h, w, c0, cm, co, (), precision))
                found = wide_neck_trace(lambda: widths_call(fpn_neck.fused_neck_l0, precision)(*a))
                print(f"widths page {preset} fpn_neck_l0 {h}x{w} {precision}: device ms a call by kernel "
                      f"(torch.profiler, 3 calls): " + ", ".join(f"{k}={v:.4f}" for k, v in found.items()), flush=True)
                names[f"{preset}|fpn_neck_l0 {h}x{w}|{precision}"] = found
                if preset == "base" and (h, w) == WIDTH_NECK_PAGE_HW[0]:
                    rows[f"fpn_neck_l0_wide{suffix_of[precision]}"] = {
                        **row, "device_ms": sum(found.values()), "shape": [1, h, w, c0, cm, co]}
            del f0, u
        rough = [random_head_params(cm, 1, gen, device) for _ in range(2)]
        precise = [random_head_params(cm, m, gen, device) for m in PRECISE_OUT]
        for name in ("fpn_heads", "precise_heads"):
            h, w = WIDTH_PAGE_HW[name]
            x = torch.randn(1, h, w, cm, generator=gen).to(device)
            _, kernel, plain, args, heads = next(c for c in wide_heads_cases(x, rough, precise) if c[0] == name)
            for precision in dtype_of:
                a = args(dtype_of[precision])
                row = check_width_case(f"widths page {preset} {name}", name, kernel, plain, a, precision,
                                       widths_bound_ms(name, 1, h, w, 0, cm, 0, heads, precision))
                traced = kernel_device_ms(lambda: widths_call(kernel, precision)(*a), reps=3, once_a_call=True,
                                          match="heads_")
                found = {short_kernel_name(k): v for k, v in traced.items() if "heads_" in k}
                print(f"widths page {preset} {name} {precision}: device ms a call by kernel (torch.profiler, "
                      f"3 calls): " + ", ".join(f"{k}={v:.4f}" for k, v in found.items()), flush=True)
                names[f"{preset}|{name}|{precision}"] = found
                if preset == "base":
                    rows[f"{name}_wide{suffix_of[precision]}"] = {**row, "device_ms": sum(found.values()),
                                                                  "shape": [1, h, w, cm]}
            del x
    return rows, names


# widths_page in a fresh interpreter (argv[1]: the generator's seed): late
# in a run of every phase torch.profiler keeps almost no trace (once 30
# traces of one call in a row kept no launch), and a new process's keeps
# them. Its last line is WIDTH_PAGE and the result as JSON.
WIDTH_PAGE_SCRIPT = r"""
import json, sys
import torch
import chip_smoke as cs
from adascale_torch.utils.precision import pin_full_f32

pin_full_f32()
cs.PHASE[0] = "widths"
rows, names = cs.widths_page(torch.Generator().manual_seed(int(sys.argv[1])), torch.device("cuda", 0))
print("WIDTH_PAGE " + json.dumps({"rows": rows, "names": names, "retries": cs.TRACE_RETRIES}), flush=True)
"""


def widths_page_fresh(seed: int) -> tuple:
    """``widths_page`` run by WIDTH_PAGE_SCRIPT in a fresh interpreter
    within 300 s, its output printed here. Returns its (rows, names), the
    names keyed (preset, name, precision); its empty traces count in
    TRACE_RETRIES."""
    import sys

    proc = subprocess.run([sys.executable, "-c", WIDTH_PAGE_SCRIPT, str(seed)], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    lines = proc.stdout.splitlines()
    print("\n".join(line for line in lines if not line.startswith("WIDTH_PAGE ")), flush=True)
    result = [line for line in lines if line.startswith("WIDTH_PAGE ")]
    if proc.returncode or not result:
        print(proc.stderr[-8000:], flush=True)
        raise AssertionError(f"widths page: the fresh interpreter ended with exit code {proc.returncode}")
    out = json.loads(result[-1][len("WIDTH_PAGE "):])
    for phase, n in out["retries"].items():
        TRACE_RETRIES[phase] = TRACE_RETRIES.get(phase, 0) + n
    return out["rows"], {tuple(key.split("|")): found for key, found in out["names"].items()}


def check_widths(gen, device) -> dict:
    """Phase widths: the neck and both heads kernels at the base and large
    backbones' widths on random weights (B = 2, a 64x48 level 0), the neck
    at WIDTH_NECK_ROUTES, and the heads at the base widths at a tiled
    group's batch (WIDTH_GROUP), against their plain twins in all three
    precisions (``check_width_case``); the neck and both heads at the base
    and large widths at the page shapes (WIDTH_NECK_PAGE_HW, WIDTH_PAGE_HW,
    B = 1), timed, with the trace's kernel names (the wide heads' cluster
    kernels, one launch a call; the wide neck's, one launch a step; none of
    the split designs'); each kernel at the base widths at B = 4 bit for
    bit against each image alone (bf16 and TF32); then fused detect()s of
    random-init models on page_0
    (base at f32, "default" and bf16; large at bf16), each of which must run
    to the end (their polygons are not checked: the weights are random).
    Returns (the kernels line's wide rows, the detects' launches)."""
    import numpy as np
    import torch

    from adascale_torch.kernels import fpn_neck
    from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
    from adascale_torch.utils.params import jax_from_state_dict

    precisions = ("f32", "tf32", "bf16")
    dtype_of = {"f32": torch.float32, "tf32": torch.float32, "bf16": torch.bfloat16}
    runs = [(preset, WIDTH_BATCH, WIDTH_HW, False) for preset in WIDTH_PRESETS]
    runs.append((*WIDTH_GROUP, True))
    for preset, b, (h, w), heads_only in runs:
        c0, cm = WIDTH_PRESETS[preset]
        co = cm // 4
        rough = [random_head_params(cm, 1, gen, device) for _ in range(2)]
        precise = [random_head_params(cm, m, gen, device) for m in PRECISE_OUT]
        x = torch.randn(b, h, w, cm, generator=gen).to(device)
        cases = wide_heads_cases(x, rough, precise)
        if not heads_only:
            p = random_neck_params(c0, cm, co, gen, device)
            f0 = torch.randn(b, h, w, c0, generator=gen).to(device)
            u = torch.randn(b, h, w, cm, generator=gen).to(device)
            cases.insert(0, ("fpn_neck_l0", fpn_neck.fused_neck_l0, fpn_neck.fused_neck_l0_plain,
                             lambda d: (f0.to(d), u.to(d), p), ()))
        for name, kernel, plain, args, heads in cases:
            widths = [q["step1.conv.weight"].shape[0] for q in heads] or (c0, cm, co)
            for precision in precisions:
                check_width_case(f"widths {preset} {name} {widths}", name, kernel, plain, args(dtype_of[precision]),
                                 precision, widths_bound_ms(name, b, h, w, c0, cm, co, heads, precision))
    b, (h, w) = WIDTH_BATCH, WIDTH_HW
    for c0, cm, co in WIDTH_NECK_ROUTES:
        p = random_neck_params(c0, cm, co, gen, device)
        f0 = torch.randn(b, h, w, c0, generator=gen).to(device)
        u = torch.randn(b, h, w, cm, generator=gen).to(device)
        for precision in precisions:
            d = dtype_of[precision]
            routes = fpn_neck.plan(precision, c0, cm, co)
            check_width_case(f"widths routes fpn_neck_l0 {(c0, cm, co)} {routes}", "fpn_neck_l0",
                             fpn_neck.fused_neck_l0, fpn_neck.fused_neck_l0_plain, (f0.to(d), u.to(d), p), precision,
                             widths_bound_ms("fpn_neck_l0", b, h, w, c0, cm, co, (), precision))

    stamp("widths: the wide neck and heads at the page shapes, B = 1, in each precision (a fresh interpreter)")
    rows, names = widths_page_fresh(int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))
    # Every wide heads call ran one launch of a cluster kernel, every wide
    # neck call one launch of each step's wide kernel; none of the split
    # designs'.
    def wrong_names(name, found):
        if any(k.startswith(STALE_WIDE_KERNELS) or any(s_ in k for s_ in STALE_WIDE_NECK_KERNELS) for k in found):
            return True
        if name.startswith("fpn_neck_l0"):
            return len(found) != 2 or not all(any(k.startswith(step) for k in found)
                                              for step in (WIDE_NECK_STEP1, WIDE_NECK_STEP2))
        return len(found) != 1 or not any(k.startswith(WIDE_HEADS_KERNELS) for k in found)

    wrong = {key: list(found) for key, found in names.items() if wrong_names(key[1], found)}
    if wrong:
        raise AssertionError(f"widths page: wide calls not the cluster designs' launches: {wrong}")

    stamp("widths: the wide neck and heads at B = 4 against each image alone (base, bf16 and TF32)")
    b, (h, w) = WIDTH_INVARIANCE
    c0, cm = WIDTH_PRESETS["base"]
    rough = [random_head_params(cm, 1, gen, device) for _ in range(2)]
    precise = [random_head_params(cm, m, gen, device) for m in PRECISE_OUT]
    p = random_neck_params(c0, cm, cm // 4, gen, device)
    x = torch.randn(b, h, w, cm, generator=gen).to(device)
    f0 = torch.randn(b, h, w, c0, generator=gen).to(device)
    neck_case = ("fpn_neck_l0", lambda *a: [fpn_neck.fused_neck_l0(*a)], None,
                 lambda d: (f0.to(d), x.to(d), p), ())
    for name, kernel, _, args, _ in [neck_case] + wide_heads_cases(x, rough, precise):
        for precision in ("tf32", "bf16"):
            call = widths_call(kernel, precision)
            xb, *rest = args(dtype_of[precision])
            batch = [batch_out for batch_out in call(xb, *rest)]
            # Each image alone: every activation (the neck's f0 and u) cut to it.
            alone = [list(call(*(v[i : i + 1].contiguous() if torch.is_tensor(v) and v.dim() == 4 else v
                                 for v in (xb, *rest)))) for i in range(b)]
            same = all(torch.equal(y[i : i + 1], a_[k]) for i, a_ in enumerate(alone) for k, y in enumerate(batch))
            print(f"widths base {name} {precision} B={b} {h}x{w}: each image of the batch bit for bit as "
                  f"alone: {same}", flush=True)
            if not same:
                raise AssertionError(f"widths base {name} {precision} at B={b}: a batch's image differs")

    out = {}
    image = np.load(SHIFT_PAGES[0])["image"]
    # (dtype, matmul_precision or None for the config's own, the path's
    # name) of each size's detect().
    for size, runs_of in (("base", (("float32", None, "float32"), ("float32", "default", "default"),
                                    ("bfloat16", None, "bfloat16"))),
                          ("large", (("bfloat16", None, "bfloat16"),))):
        stamp(f"widths: fused detect() of a random-init {size} model on page_0")
        torch.manual_seed(0)
        model = AdaptiveScaling(AdaptiveScalingConfig(size=size, neck_head_type="fpn"))
        params = jax_from_state_dict(model.state_dict())
        del model
        for dtype, precision, label in runs_of:
            engine = engine_for(params, size=size, compute_dtype=dtype, use_pallas_neck_heads=True,
                                **({"matmul_precision": precision} if precision else {}))
            result, launches = counted(lambda: engine.detect(image))
            print(
                f"widths: fused detect() of a random-init {size} model ({dtype}, {label}): ran to the "
                f"end, {len(result['char_polygons'])} polygons, {len(result['regions'])} regions, "
                f"LAUNCHES={launches}",
                flush=True,
            )
            suffix = {"float32": "", "default": "_tf32", "bfloat16": "_bf16"}[label]
            if not launches.get(f"fpn_neck_l0{suffix}") or not launches.get(f"fpn_heads{suffix}"):
                raise AssertionError(f"{size} detect() ({dtype}, {precision}) did not launch the neck and heads: "
                                     f"{launches}")
            out[f"detect_{size}_random_{label}"] = launches
            del engine
        del params
        torch.cuda.empty_cache()
    return rows, out


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


# Phase export: the flagship's module model through torch.export with b, h
# and w symbolic (an example of 2 x 640 x 640), saved, loaded back from disk
# and run at page_0's rough input and precise stack and at
# EXPORT_SECOND_SHAPE, each output within EXPORT_REL_TOL of the eager
# model's largest value (cuDNN may pick other algorithms inside the program);
# then `python -m adascale_torch detect` on page_0 written as a PNG.
# Phase tf32: matmul_precision "default" / "high", one TF32 pass a product.
# Each TF32 entry against its TF32 plain twin (both operands rounded as the
# kernel rounds them, other summation orders), stage by stage on the
# kernel's own operands, at TF32_TWIN_TOL of the largest value (the f32
# kernels' bar): the heads end to end (their rounded operands are the
# call's inputs); the block's depthwise + LN, GEMM 1 on its h and GEMM 2 on
# its u (read from the kernel's workspace); the neck's step1 and its 3x3 on
# its t. End to end, an intermediate that differs from the twin's in its
# last bit can round to the neighbouring TF32 value, a 2^-11 step that the
# next product carries to the output: the twin itself moves by ~1e-4 of its
# largest value when only its intermediates' f32 rounding changes
# (``tf32_twin_spread``; the block at 240x192x96, H100 and CPU: 1.34e-4), so
# the end-to-end difference is printed beside that spread, not held to the
# bar. Against an f64 product of the unrounded operands: at most
# TF32_F64_BAR of the largest value, and at least TF32_PASS_RATIO times the
# 3xTF32 entry's error on the same inputs, so that it is one pass.
TF32_TWIN_TOL = 2e-5
TF32_F64_BAR = 1e-2
# A TF32 launch held against its TF32 twin on a path (``held_against_plain``):
# about 7 times the twin's own spread above.
TF32_HELD_TOL = 1e-3
TF32_PASS_RATIO = 10.0
# The TF32 entries' batch invariance at "default": each image of a B = 4
# batch bit for bit as it comes out alone, at the rough pass's stage shapes
# (the block), the precise and rough heads' shapes and the rough neck's
# level 0 (H, W, C0, Cm, Co).
TF32_INVARIANCE_CASES = [("convnext_block", (4, *shape)) for shape, _ in STAGE_SHAPES] + [
    ("precise_heads", (4, *shape)) for shape, _ in PRECISE_HEAD_SHAPES[:1]
] + [("fpn_heads", (4, *shape)) for shape, _ in ROUGH_HEAD_SHAPES[:1]] + [
    ("fpn_neck_l0", (4, *shape)) for shape, _ in NECK_SHAPES[:1]
]
# The block's exact-erf GELUs run on the f32 pipes, one a hidden unit (4C a
# pixel): an estimate of 20 instructions each (erff's branch-free
# polynomial, the GELU's multiplies, the bias and the TF32 rounding) at the
# H100 SXM's 33.5e12 f32 instructions a second (half the 67 TFLOP/s of
# fused multiply-adds). Printed beside the block's bound, which counts only
# its products and depthwise.
GELU_INSTRUCTIONS = 20


def tf32_twin_spread(name: str, args):
    """The TF32 plain twin of ``name`` ("convnext_block" or "fpn_neck_l0")
    on ``args`` with its f32 intermediates (the block's LN output, the
    neck's t) computed in f64 from the same rounded operands and cast to
    f32: the same values rounded to f32 otherwise than the twin rounds them,
    so that the two differ only where a last-bit difference flips a TF32
    rounding."""
    import torch.nn.functional as F

    from adascale_torch.kernels import convnext_block as K
    from adascale_torch.kernels import fpn_neck
    from adascale_torch.utils.precision import round_tf32 as r

    if name == "convnext_block":
        x, p = args
        c = x.shape[-1]
        q = {k: v.double() for k, v in p.items()}
        y = F.conv2d(x.double().permute(0, 3, 1, 2), q["dwconv.weight"], q["dwconv.bias"], padding=3,
                     groups=c).permute(0, 2, 3, 1)
        h = F.layer_norm(y, (c,), q["ln.weight"], q["ln.bias"], eps=K.EPS).float()
        u = F.gelu(F.linear(r(h), r(p["mlp_up.weight"]), p["mlp_up.bias"]), approximate="none")
        return x + F.linear(r(u), r(p["mlp_down.weight"]), p["mlp_down.bias"]) * p["block_scale"]
    f0, u, p = args
    q = {k: v.double() for k, v in p.items()}

    def ln_gelu(z, part):
        z = F.layer_norm(z, (z.shape[-1],), q[f"{part}.ln.weight"], q[f"{part}.ln.bias"], eps=fpn_neck.EPS)
        return F.gelu(z, approximate="none")

    a = ln_gelu(F.linear(r(f0).double(), r(p["step1_0.conv.weight"]).double(), q["step1_0.conv.bias"]),
                "step1_0")
    t = (a + u.double()).float()
    z = F.conv2d(r(t).permute(0, 3, 1, 2), r(p["step2_0.conv.weight"]), p["step2_0.conv.bias"], padding=1)
    return ln_gelu(z.permute(0, 2, 3, 1).double(), "step2_0").float()


def block_tf32_stages(x, p):
    """The block's TF32 entry run once with its workspace kept, and its
    stages against their TF32 twins on the kernel's own operands: (stage,
    kernel, twin) for the depthwise + LN (h), GEMM 1 (u = GELU(h W1 + b1))
    and GEMM 2 (the block's output)."""
    import torch
    import torch.nn.functional as F

    from adascale_torch.kernels import convnext_block as K
    from adascale_torch.utils.precision import matmul_precision
    from adascale_torch.utils.precision import round_tf32 as r

    b, h, w, c = x.shape
    m = b * h * w
    ws = torch.empty(K.tf32_workspace_floats(b, h, w, c, x.device, keep_u=True), device=x.device)
    with matmul_precision("default"):
        out = K._launch(x, p, True, ws)
    hk, uk = ws[: m * c].view(b, h, w, c), ws[m * c : 5 * m * c].view(b, h, w, 4 * c)
    y = F.conv2d(x.permute(0, 3, 1, 2), p["dwconv.weight"], p["dwconv.bias"], padding=3, groups=c)
    ln = F.layer_norm(y.permute(0, 2, 3, 1), (c,), p["ln.weight"], p["ln.bias"], eps=K.EPS)
    gemm1 = F.gelu(F.linear(r(hk), r(p["mlp_up.weight"]), p["mlp_up.bias"]), approximate="none")
    gemm2 = x + F.linear(r(uk), r(p["mlp_down.weight"]), p["mlp_down.bias"]) * p["block_scale"]
    return [("dw_ln", hk, ln), ("gemm1", uk, gemm1), ("gemm2", out, gemm2)]


def neck_tf32_stages(f0, u, p):
    """The neck's TF32 entry run once with its t kept, and its two steps
    against their TF32 twins on the kernel's own operands: (stage, kernel,
    twin) for step1 (t = GELU(LN(f0 W1 + b1)) + u) and the 3x3 (the
    output)."""
    import torch
    import torch.nn.functional as F

    from adascale_torch.kernels import fpn_neck
    from adascale_torch.utils.precision import matmul_precision
    from adascale_torch.utils.precision import round_tf32 as r

    t = torch.empty_like(u)
    with matmul_precision("default"):
        out = fpn_neck.fused_neck_l0(f0, u, p, t=t)
    step1 = fpn_neck._ln_gelu(F.linear(r(f0), r(p["step1_0.conv.weight"]), p["step1_0.conv.bias"]),
                              p["step1_0.ln.weight"], p["step1_0.ln.bias"]) + u
    z = F.conv2d(r(t).permute(0, 3, 1, 2), r(p["step2_0.conv.weight"]), p["step2_0.conv.bias"], padding=1)
    step2 = fpn_neck._ln_gelu(z.permute(0, 2, 3, 1), p["step2_0.ln.weight"], p["step2_0.ln.bias"])
    return [("step1", t, step1), ("step2", out, step2)]


def check_tf32_kernel(label: str, kernel, plain, args, exact_args, flops_tc: float, flops_simt: float,
                      nbytes: float, stages=None, spread=None, reps: int = 10, gelus: float = 0.0) -> dict:
    """A kernel's single-pass TF32 entry (``kernel`` called inside
    ``matmul_precision("default")``) against its TF32 plain twin
    (``plain(*args, tf32=True)``) and against ``plain`` on ``exact_args``
    (f64, unrounded), beside its 3xTF32 entry (``kernel`` outside the scope)
    on the same inputs. Held to TF32_TWIN_TOL: end to end, or, given
    ``stages``, each of the (stage, kernel, twin) that ``stages(*args)``
    returns (the end-to-end difference then printed beside the twin's own
    spread, ``spread(args)``); and to TF32_F64_BAR and TF32_PASS_RATIO.
    Prints and returns the errors, the TF32 entry's, the 3xTF32 entry's and
    the twin's ms, and the bound's two parts (``flops_tc`` products at the
    dense TF32 rate plus ``flops_simt`` at the f32 SIMT rate; ``nbytes`` at
    the memory rate); beside them, where the kernel takes ``gelus`` exact
    GELUs, their floor on the f32 pipes (GELU_INSTRUCTIONS each)."""
    import torch

    from adascale_torch.utils.precision import matmul_precision

    def listed(v):
        return [v] if torch.is_tensor(v) else list(v)

    def rel_err_of(got, want):
        return max(float((g - w_).abs().max()) for g, w_ in zip(got, want)) / max(
            float(w_.abs().max()) for w_ in want)

    with matmul_precision("default"):
        got = listed(kernel(*args))
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kernel(*args), reps)
    got3 = listed(kernel(*args))
    ms3 = cuda_ms(lambda: kernel(*args), reps)
    twin = listed(plain(*args, tf32=True))
    plain_ms = cuda_ms(lambda: plain(*args, tf32=True), reps)
    exact = listed(plain(*exact_args))
    err = max(float((g - w_).abs().max()) for g, w_ in zip(got, twin))
    rel = rel_err_of(got, twin)
    staged = {name: rel_err_of([k], [t_]) for name, k, t_ in stages(*args)} if stages else {"end_to_end": rel}
    rel_spread = rel_err_of(listed(spread(args)), twin) if spread else 0.0
    scale = max(float(e.abs().max()) for e in exact)
    rel64 = max(float((g.double() - e).abs().max()) for g, e in zip(got, exact)) / scale
    rel64_3 = max(float((g.double() - e).abs().max()) for g, e in zip(got3, exact)) / scale
    t_ops = (flops_tc / PEAK_TF32_FLOPS + flops_simt / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    gelu_ms = gelus * GELU_INSTRUCTIONS / (PEAK_F32_FLOPS / 2) * 1e3
    print(
        f"{label} TF32: against its TF32 twin "
        + " ".join(f"{name}={v:.3e}" for name, v in staged.items())
        + (f" (end to end {rel:.3e}, the twin's own spread {rel_spread:.3e})" if stages else "")
        + f" max_abs_err={err:.3e} rel_vs_f64 tf32={rel64:.3e} 3xtf32={rel64_3:.3e} "
        f"ratio={rel64 / max(rel64_3, 1e-30):.1f} kernel_ms={ms:.4f} kernel_3xtf32_ms={ms3:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={max(t_ops, t_bytes):.4f} "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}, 1 TF32 pass)"
        + (f" gelu_simt_floor_ms={gelu_ms:.4f}" if gelus else ""),
        flush=True,
    )
    worst = max(staged.values())
    if not worst <= TF32_TWIN_TOL:
        raise AssertionError(f"{label} TF32: relative error against its twin {staged} > {TF32_TWIN_TOL}")
    if not rel64 <= TF32_F64_BAR:
        raise AssertionError(f"{label} TF32: relative error {rel64} against f64 > {TF32_F64_BAR}")
    if not rel64 >= TF32_PASS_RATIO * rel64_3:
        raise AssertionError(
            f"{label} TF32: error against f64 {rel64} < {TF32_PASS_RATIO} x the 3xTF32 entry's {rel64_3}")
    return {"max_abs_err": err, "rel": worst, "end_to_end": rel, "twin_spread": rel_spread, "ms": ms,
            "ms_3xtf32": ms3, "plain_ms": plain_ms, "t_ops": t_ops, "t_bytes": t_bytes, "rel64": rel64,
            "rel64_3xtf32": rel64_3, "gelu_ms": gelu_ms}


def check_tf32_kernels(gen, device) -> dict:
    """Phase tf32, its kernels: each f32 kernel's single-pass TF32 entry at
    the flagship's shapes (the block at every stage shape of both passes,
    the neck at both passes' level 0, the heads at theirs) and a ragged one
    each, by ``check_tf32_kernel``. Returns the kernels line's entries
    ("<name>_tf32"): times and bounds summed over one one-chunk detect()'s
    calls, the errors the worst."""
    import torch

    from adascale_torch.kernels import convnext_block as K
    from adascale_torch.kernels import fpn_heads, fpn_neck, precise_heads

    def double(params):
        return {k: v.double() for k, v in params.items()}

    def total(rows):
        t_ops = sum(n * r["t_ops"] for r, n in rows)
        t_bytes = sum(n * r["t_bytes"] for r, n in rows)
        return {
            "max_abs_err": max(r["max_abs_err"] for r, _ in rows),
            **{k: sum(n * r[k] for r, n in rows) for k in ("ms", "plain_ms", "ms_3xtf32")},
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_rate": "1 TF32 product a product at 495 TFLOP/s (the block's depthwise at 67 TFLOP/s f32)",
            **{k: max(r[k] for r, _ in rows) for k in ("rel", "end_to_end", "twin_spread")},
            "rel_vs_f64": {"tf32": max(r["rel64"] for r, _ in rows),
                           "3xtf32": max(r["rel64_3xtf32"] for r, _ in rows)},
        }

    rows = {}
    block_rows = []
    for (h, w, c), blocks in STAGE_SHAPES + PRECISE_STAGE_SHAPES + [(RAGGED_SHAPE, 0)]:
        p = random_block_params(c, gen, device)
        x = torch.randn(1, h, w, c, generator=gen).to(device)
        npix = h * w
        nbytes = 4 * (2 * npix * c + 49 * c + 8 * c * c + 4 * c + 6 * c)
        block_rows.append((check_tf32_kernel(
            f"convnext_block {h}x{w}x{c}", K.convnext_block, K.convnext_block_plain, (x, p),
            (x.double(), double(p)), npix * 16 * c * c, npix * 2 * 49 * c, nbytes, stages=block_tf32_stages,
            spread=lambda a: tf32_twin_spread("convnext_block", a), gelus=npix * 4 * c), blocks))
    rows["convnext_block_tf32"] = total(block_rows)
    # An estimate (GELU_INSTRUCTIONS), kept out of the kernels line, whose
    # numbers are measured or, for bound_ms, computed from the work.
    gelu_ms = sum(n * r["gelu_ms"] for r, n in block_rows if n)
    print(f"convnext_block TF32, one one-chunk detect()'s {sum(n for _, n in block_rows)} calls: "
          f"kernel_ms={rows['convnext_block_tf32']['ms']:.4f} bound_ms={rows['convnext_block_tf32']['bound_ms']:.4f} "
          f"gelu_simt_floor_ms={gelu_ms:.4f} (an estimate: {GELU_INSTRUCTIONS} f32 instructions a GELU)", flush=True)

    neck_rows = []
    for (h, w, c0, cm, co), calls in NECK_SHAPES:
        p = random_neck_params(c0, cm, co, gen, device)
        f0 = torch.randn(1, h, w, c0, generator=gen).to(device)
        u = torch.randn(1, h, w, cm, generator=gen).to(device)
        flops, nbytes = neck_work(1, h, w, c0, cm, co)
        neck_rows.append((check_tf32_kernel(
            f"fpn_neck_l0 {h}x{w} {c0}->{cm}->{co}", fpn_neck.fused_neck_l0, fpn_neck.fused_neck_l0_plain,
            (f0, u, p), (f0.double(), u.double(), double(p)), flops, 0.0, nbytes, stages=neck_tf32_stages,
            spread=lambda a: tf32_twin_spread("fpn_neck_l0", a)), calls))
    rows["fpn_neck_l0_tf32"] = total(neck_rows)

    for name, shapes, outs in (("fpn_heads", ROUGH_HEAD_SHAPES, (1, 1)),
                               ("precise_heads", PRECISE_HEAD_SHAPES, PRECISE_OUT)):
        head_rows = []
        for (h, w, c), calls in shapes:
            heads = [random_head_params(c, m, gen, device) for m in outs]
            x = torch.randn(1, h, w, c, generator=gen).to(device)
            if name == "fpn_heads":
                kernel, plain = fpn_heads.fused_rough_heads, fpn_heads.fused_rough_heads_plain
                args, exact_args = (x, *heads), (x.double(), *map(double, heads))
            else:
                kernel, plain = precise_heads.fused_precise_heads, precise_heads.fused_precise_heads_plain
                args, exact_args = (x, heads), (x.double(), [double(p) for p in heads])
            flops, nbytes = heads_work(1, h, w, c, heads)
            head_rows.append((check_tf32_kernel(f"{name} {h}x{w}x{c}", kernel, plain, args, exact_args, flops,
                                                0.0, nbytes), calls))
        rows[f"{name}_tf32"] = total(head_rows)
    return rows


def check_tf32_invariance(gen, device) -> None:
    """TF32_INVARIANCE_CASES at "default": each image of the batch bit for
    bit as the TF32 entry gives it alone (the block's split plan and the
    heads' and the neck's tile walks do not move with B)."""
    import torch

    from adascale_torch.kernels import convnext_block as K
    from adascale_torch.kernels import fpn_heads, fpn_neck, precise_heads
    from adascale_torch.utils.precision import matmul_precision

    for name, (b, h, w, c, *widths) in TF32_INVARIANCE_CASES:
        xs = [torch.randn(b, h, w, c, generator=gen).to(device)]
        if name == "convnext_block":
            p = random_block_params(c, gen, device)
            run = lambda t: [K.convnext_block(t, p)]  # noqa: E731
        elif name == "fpn_neck_l0":
            cm, co = widths
            p = random_neck_params(c, cm, co, gen, device)
            xs.append(torch.randn(b, h, w, cm, generator=gen).to(device))
            run = lambda f0, u: [fpn_neck.fused_neck_l0(f0, u, p)]  # noqa: E731
        elif name == "fpn_heads":
            heads = [random_head_params(c, m, gen, device) for m in (1, 1)]
            run = lambda t: list(fpn_heads.fused_rough_heads(t, *heads))  # noqa: E731
        else:
            heads = [random_head_params(c, m, gen, device) for m in PRECISE_OUT]
            run = lambda t: precise_heads.fused_precise_heads(t, heads)  # noqa: E731
        with matmul_precision("default"):
            batch = run(*xs)
            alone = [run(*(x[i : i + 1].contiguous() for x in xs)) for i in range(b)]
        same = all(torch.equal(y[i : i + 1], a[k]) for i, a in enumerate(alone) for k, y in enumerate(batch))
        shape = "x".join(map(str, (h, w, c, *widths)))
        print(f"tf32 {name} B={b} {shape}: each image of the batch bit for bit as alone: {same}", flush=True)
        if not same:
            raise AssertionError(f"tf32 {name} at B={b}, {shape}: a batch's image differs from the image alone")


def tf32_trace(engine, image, result) -> dict:
    """The fused engine's rough and precise forwards at "default" on
    page_0's inputs: device ms a call by kernel name (torch.profiler, 3
    calls), printed; every TF32 launch must be the Hopper designs' (in both
    passes the block's mlp_fused_tf32_kernel and gemm_tf32_wgmma_kernel, no
    gemm_tf32_kernel; the heads' heads_tma_kernel on f32, 192 wide in the
    rough pass and 200 in the precise, no heads_kernel; the neck's
    neck_step1_tma_kernel and neck_step2_tma_kernel on f32, no
    neck_step1_kernel or neck_step2_kernel)."""
    import torch

    from adascale_torch.utils.precision import matmul_precision

    x_rough, x_precise = forward_inputs(image, result, engine.device)
    out = {}
    for which, x in (("rough", x_rough), ("precise", x_precise)):
        def forward(x=x, which=which):
            with torch.inference_mode(), matmul_precision("default"):
                return engine._forward(x, which)

        ms = kernel_device_ms(forward, reps=3)
        names = {}
        for key, v in ms.items():
            if kernel_group(key):  # the kernel's name and template arguments
                name = re.search(r"\w+_kernel(<[^>]*>)?", key).group(0)
                names[name] = names.get(name, 0.0) + v
        print(f"tf32 fused {which} forward at default, device ms a call by kernel (torch.profiler, 3 calls): "
              + ", ".join(f"{k}={v:.4f}" for k, v in sorted(names.items(), key=lambda kv: -kv[1])), flush=True)
        found = " ".join(names)
        wanted = ("mlp_fused_tf32_kernel", "gemm_tf32_wgmma_kernel",
                  f"heads_tma_kernel<float, {192 if which == 'rough' else 200}",
                  "neck_step1_tma_kernel<float", "neck_step2_tma_kernel<float")
        missing = [k for k in wanted if k not in found]
        stale = [k for k in ("gemm_tf32_kernel", "heads_kernel", "neck_step1_kernel", "neck_step2_kernel")
                 if k in found]
        if missing or stale:
            raise AssertionError(f"tf32 fused {which} forward: kernels {missing} missing, {stale} present")
        out[which] = names
    return out


# detect() on page_0 at "default" against "highest" (f32): the rough mask
# agreement, the polygons matched both ways at IoU >= 0.5 and each run's
# char F1 against the page's ground-truth corners, apart by at most
# TF32_F1_TOL; "high" equal to "default" bit for bit. (label, weights, neck,
# fused neck and heads.)
TF32_MASK_BAR, TF32_POLYGON_BAR, TF32_F1_TOL = 0.995, 0.90, 0.02
TF32_DETECTS = (
    ("fpn_module", WEIGHTS, "fpn", False),
    ("fpn_fused", WEIGHTS, "fpn", True),
    ("upernext_fused", UPERNEXT_WEIGHTS, "upernext", True),
)
# eval_checkpoint.evaluate on the FPN flagship's .npz: pages of its
# steps.json, fused, at f32 ("highest") and bf16 ("default").
TF32_EVAL_PAGES = 2


def same_detect(a, b) -> bool:
    """Two detect() results equal bit for bit: the rough maps and every
    polygon's points."""
    import numpy as np

    return (
        np.array_equal(a["rough"].rough_char_mask, b["rough"].rough_char_mask)
        and np.array_equal(a["rough"].rough_char_height_score_map, b["rough"].rough_char_height_score_map)
        and len(a["char_polygons"]) == len(b["char_polygons"])
        and all(np.array_equal(p.points, q.points) for p, q in zip(a["char_polygons"], b["char_polygons"]))
    )


def tf32_forward_ms(label: str, engines, image, result) -> dict:
    """The rough and precise forwards of each of ``engines`` (by precision)
    on page_0's inputs at B = MANY_BATCH inside its precision's scope: ms per
    call (CUDA events, warm, the median of three single calls)."""
    import torch

    from adascale_torch.utils.precision import matmul_precision

    x_rough, x_precise = forward_inputs(image, result, next(iter(engines.values())).device)
    out = {}
    with torch.inference_mode():
        for which, x in (("rough", x_rough), ("precise", x_precise)):
            xb = x.expand(MANY_BATCH, *x.shape[1:]).contiguous()
            for precision, engine in engines.items():
                with matmul_precision(precision):
                    out[f"{which}_{precision}_ms"] = cuda_ms(lambda: engine._forward(xb, which), reps=1)
            print(
                f"tf32 {label} {which} forward B={MANY_BATCH} {tuple(xb.shape[1:3])}: "
                + ", ".join(f"{p} {out[f'{which}_{p}_ms']:.3f} ms" for p in engines)
                + " (CUDA events, warm)",
                flush=True,
            )
    return out


def with_precision(engine, precision: str):
    """A copy of ``engine`` (the same model and weights) whose config asks
    ``precision``: what an engine built with it computes."""
    import copy

    other = copy.copy(engine)
    other.config = dataclasses.replace(engine.config, matmul_precision=precision)
    return other


def same_passes(a, b, image, stacked) -> bool:
    """Two engines' rough pass on ``image`` and precise pass on ``stacked``
    equal bit for bit (every map each pass brings back)."""
    import numpy as np

    ra, rb = a.rough_infer(image), b.rough_infer(image)
    pa, pb = a.precise_infer(stacked), b.precise_infer(stacked)
    return all(np.array_equal(getattr(x, f.name), getattr(y, f.name))
               for x, y in ((ra, rb), (pa, pb)) for f in dataclasses.fields(x))


def check_tf32_detects(image, highest: dict) -> tuple:
    """Phase tf32, its paths: detect() on page_0 at "default" for each of
    TF32_DETECTS (f32; "highest" as an earlier phase ran it, in ``highest``,
    else run here) with exact launches, the TF32 entries only; "default"
    against "highest" at TF32_MASK_BAR, TF32_POLYGON_BAR and TF32_F1_TOL
    (the F1 against page_0's ground truth); an engine at "high" equal to the
    one at "default" bit for bit in both passes; the fused FPN forwards at
    B = MANY_BATCH at both precisions. Then the fused bf16 detect() at
    "highest" (phase bf16's, where it ran) and "default", each against the
    JAX bf16 reference at phase bf16's bars (its height map nearer the
    reference than the f32 fused run's at the same precision). Returns the
    launches by path, the numbers and the fused FPN engine at "default"."""
    import numpy as np

    from adascale_torch.inference.eval import evaluate_char_detection, match_polygons
    from adascale_torch.utils.params import load_npz

    page = np.load(SHIFT_PAGES[0])
    if not np.array_equal(page["image"], image):
        raise AssertionError(f"{SHIFT_PAGES[0]} is not the page of the references")
    corners = list(page["corners"])
    by_path, numbers, f32_fused = {}, {}, {}
    for label, weights, neck, fused in TF32_DETECTS:
        if label in highest:
            engine, hi = highest[label]
        else:
            engine = engine_for(load_npz(weights), neck_head_type=neck, use_pallas_neck_heads=fused)
            hi = engine.detect(image)
        default = with_precision(engine, "default")
        de, launches = counted(lambda: default.detect(image))
        chunks = de["num_precise_chunks"]
        blocks = sum(n for _, n in engine.config.model.backbone_spec())
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want["convnext_block_tf32"] = blocks * (1 + chunks)
        if neck == "fpn" and fused:
            want.update(fpn_neck_l0_tf32=1 + chunks, fpn_heads_tf32=1, precise_heads_tf32=chunks)
        if launches != want:
            raise AssertionError(f"tf32 {label} at default: LAUNCHES {launches} != {want}")
        if not same_passes(with_precision(engine, "high"), default, image, de["stacked_image"]):
            raise AssertionError(f"tf32 {label}: \"high\" differs from \"default\"")
        agreement = float((hi["rough"].rough_char_mask == de["rough"].rough_char_mask).mean())
        matched = len(match_polygons(de["char_polygons"], hi["char_polygons"], 0.5))
        shares = (matched / max(len(hi["char_polygons"]), 1), matched / max(len(de["char_polygons"]), 1))
        f1 = {p: evaluate_char_detection(r["char_polygons"], corners, iou_thr=0.5).f1
              for p, r in (("highest", hi), ("default", de))}
        equal_height = float((hi["rough"].rough_char_height_score_map
                              == de["rough"].rough_char_height_score_map).mean())
        print(
            f"tf32 {label}: \"default\" against \"highest\": rough mask agreement {agreement:.6f}, height map "
            f"equal {equal_height:.4f}, polygons {len(de['char_polygons'])} / {len(hi['char_polygons'])}, "
            f"matched@0.5 {matched} ({shares[0]:.4f} of highest's, {shares[1]:.4f} of default's); char F1 "
            f"against page_0's ground truth default {f1['default']:.4f} highest {f1['highest']:.4f}; \"high\" "
            f"equal to \"default\" bit for bit (both passes); LAUNCHES default {launches}",
            flush=True,
        )
        if agreement < TF32_MASK_BAR or min(shares) < TF32_POLYGON_BAR:
            raise AssertionError(f"tf32 {label}: mask {agreement}, polygons {shares}")
        if abs(f1["default"] - f1["highest"]) > TF32_F1_TOL:
            raise AssertionError(f"tf32 {label}: F1 {f1}")
        by_path[f"detect_tf32_{label}"] = launches
        numbers[label] = {"mask_agreement": agreement, "polygons_matched": list(shares), "f1": f1,
                          "height_equal": equal_height}
        if label == "fpn_fused":
            numbers[label].update(tf32_forward_ms(label, {"highest": engine, "default": default}, image, hi))
            numbers[label]["device_ms_by_kernel"] = tf32_trace(default, image, hi)
        if label == "fpn_fused":
            f32_fused, fused_default = {"highest": hi, "default": de}, default

    ref = np.load(FPN_FUSED_BF16_REFERENCE)
    engine = engine_for(load_npz(WEIGHTS), compute_dtype="bfloat16", use_pallas_backbone=True,
                        use_pallas_neck_heads=True)
    bf16 = {"highest": highest.get("bf16_fused")}
    for precision in ("highest", "default"):
        if bf16.get(precision) is not None:
            continue
        bf16[precision], launches = counted(lambda: with_precision(engine, precision).detect(image))
        chunks = bf16[precision]["num_precise_chunks"]
        want = dict.fromkeys(KERNEL_NAMES, 0)
        blocks = sum(n for _, n in engine.config.model.backbone_spec())
        want.update(convnext_block_bf16=blocks * (1 + chunks), fpn_neck_l0_bf16=1 + chunks, fpn_heads_bf16=1,
                    precise_heads_bf16=chunks)
        if launches != want:
            raise AssertionError(f"tf32 bf16 fused at {precision}: LAUNCHES {launches} != {want}")
        if precision == "default":
            by_path["detect_tf32_bf16_fused"] = launches
    for precision, result in bf16.items():
        shares = check_against_reference(result, ref, f"bf16 fused at {precision}",
                                         mask_bar=BF16_MASK_BAR, polygon_bar=BF16_POLYGON_FLOOR)
        height, height_f32 = height_parity(result, ref), height_parity(f32_fused[precision], ref)
        print(
            f"tf32 bf16 fused at {precision}: polygons {shares[0]:.4f} / {shares[1]:.4f} of the JAX bf16 "
            f"reference's; rough height map median difference {height['median_rel']:.3e} (f32 fused at "
            f"{precision}: {height_f32['median_rel']:.3e})",
            flush=True,
        )
        if not height["median_rel"] < height_f32["median_rel"]:
            raise AssertionError(f"tf32 bf16 fused at {precision}: no nearer the bf16 reference than f32")
    a, b = bf16["highest"], bf16["default"]
    numbers["bf16_fused_default_vs_highest"] = {
        "mask_agreement": float((a["rough"].rough_char_mask == b["rough"].rough_char_mask).mean()),
        "height_equal": float((a["rough"].rough_char_height_score_map
                               == b["rough"].rough_char_height_score_map).mean()),
        "equal": same_detect(a, b),
    }
    print(f"tf32 bf16 fused, \"default\" against \"highest\": {json.dumps(numbers['bf16_fused_default_vs_highest'])}",
          flush=True)
    return by_path, numbers, fused_default


def check_tf32_paths(engine) -> dict:
    """Phase tf32, three more fused paths at "default", counted, through
    ``engine`` (the fused FPN flagship's at "default", its weights packed by
    check_tf32_detects): phase 6's page with its precise stack cut into
    chunks, phase 10's tiled page and phase 11's detect_many, each launching
    the TF32 entries alone, as many times as the path launches the f32 ones
    at "highest". Returns the launches by path."""
    import copy

    import numpy as np

    from adascale_torch import BatchedAdaptiveScalingInference

    chunk_ref, tiled_ref = np.load(MULTICHUNK_REFERENCE), np.load(TILED_BAND_REFERENCE)
    blocks = sum(n for _, n in engine.config.model.backbone_spec())

    def variant(**fields):  # the same model and weights, other engine fields (read at call time)
        other = copy.copy(engine)
        other.config = dataclasses.replace(engine.config, **fields)
        return other

    def want(chunks):
        out = dict.fromkeys(KERNEL_NAMES, 0)
        out.update(convnext_block_tf32=blocks * (1 + chunks), fpn_neck_l0_tf32=1 + chunks, fpn_heads_tf32=1,
                   precise_heads_tf32=chunks)
        return out

    by_path = {}
    chunked = variant(precise_stacked_image_max_area=int(chunk_ref["precise_stacked_image_max_area"]))
    result, by_path["detect_tf32_fused_chunks"] = counted(
        lambda: chunked.detect(np.load(os.path.join(ROOT, str(chunk_ref["page"])))["image"]))
    chunks = result["num_precise_chunks"]
    if chunks < 2 or by_path["detect_tf32_fused_chunks"] != want(chunks):
        raise AssertionError(f"tf32 chunked detect: {chunks} chunks, LAUNCHES {by_path['detect_tf32_fused_chunks']}")
    tiled = variant(precise_band_recall_center_dist_ratio=float(tiled_ref["precise_band_recall_center_dist_ratio"]))
    image = np.concatenate([np.load(os.path.join(ROOT, str(p)))["image"] for p in tiled_ref["pages"]], axis=1)
    result, by_path["tiled_tf32_band_detect"] = counted(lambda: tiled.detect(image, tiled=True))
    if by_path["tiled_tf32_band_detect"] != want(result["num_precise_chunks"]):
        raise AssertionError(f"tf32 tiled detect: LAUNCHES {by_path['tiled_tf32_band_detect']}")
    pages = [np.load(p)["image"] for p in SHIFT_PAGES] + [np.zeros(BLANK_SHAPE, np.uint8)]
    _, by_path["detect_many_tf32"] = counted(lambda: BatchedAdaptiveScalingInference(engine).detect_many(pages))
    many = dict.fromkeys(KERNEL_NAMES, 0)
    many.update({f"{k}_tf32": v for k, v in MANY_LAUNCHES.items()})
    if by_path["detect_many_tf32"] != many:
        raise AssertionError(f"tf32 detect_many: LAUNCHES {by_path['detect_many_tf32']} != {many}")
    print(f"tf32 fused paths at default, launches: {json.dumps(by_path)}", flush=True)
    return by_path


def check_tf32_eval() -> dict:
    """Phase tf32, the evaluation tool: ``eval_checkpoint.evaluate`` of the
    FPN flagship's .npz on TF32_EVAL_PAGES pages of its steps.json, fused,
    f32 (at "highest") and bf16 (at "default"): every rate in [0, 1].
    Returns the two JSON objects."""
    from adascale_torch.tools.eval_checkpoint import evaluate

    out = {}
    for dtype in ("float32", "bfloat16"):
        t = time.perf_counter()
        out[dtype] = evaluate(WEIGHTS, MODEL_JSON, steps_json=os.path.join(FLAGSHIP_DIR, "steps.json"),
                              num_pages=TF32_EVAL_PAGES, compute_dtype=dtype, pallas=True)
        print(f"tf32 eval_checkpoint ({dtype}, {TF32_EVAL_PAGES} pages, fused, {time.perf_counter() - t:.2f} s): "
              f"{json.dumps(out[dtype])}", flush=True)
        rates = [v for k, v in out[dtype].items() if k.startswith(("char_", "direct_char_", "rough_mask"))]
        if not rates or not all(0.0 <= v <= 1.0 for v in rates):
            raise AssertionError(f"eval_checkpoint ({dtype}): rates out of [0, 1]: {out[dtype]}")
    return out


EXPORT_EXAMPLE_HW = (640, 640)
EXPORT_SECOND_SHAPE = (2, 512, 704, 3)
EXPORT_REL_TOL = 1e-5
MODEL_JSON = os.path.join(ROOT, "examples/flagship_training/model.json")


def check_block_op(gen, device) -> dict:
    """The block's registered operator (``torch.ops.adascale_torch.
    convnext_block``), which every block calls, eager or in an exported
    program, in its three modes against the plain twins at the stage shapes
    of both passes: f32 against ``convnext_block_plain`` at REL_TOL; the
    bf16 Pallas mode (bf16 in and out) and module mode (f32 in and out)
    against ``convnext_block_plain_bf16`` at BF16_TOL, phase bf16's bar.
    ms through the operator, plain ms and the bound (bf16: products at the
    bf16 rate), summed over the 36 blocks of a one-chunk page. Returns the
    kernels-line entry: f32's numbers, the bf16 modes' beside them."""
    import torch

    from adascale_torch.kernels import convnext_block as K

    op = torch.ops.adascale_torch.convnext_block
    modes = {"f32": K.MODE_F32, "bf16": K.MODE_BF16, "bf16_module": K.MODE_BF16_MODULE}
    totals = {label: dict.fromkeys(("ms", "plain_ms", "t_ops", "t_bytes", "max_abs_err"), 0.0) for label in modes}
    for (h, w, c), blocks in STAGE_SHAPES + PRECISE_STAGE_SHAPES:
        p = random_block_params(c, gen, device)
        params = [p[name] for name in K.PARAM_NAMES]
        x32 = torch.randn(1, h, w, c, generator=gen).to(device)
        for label, mode in modes.items():
            x = x32.to(torch.bfloat16) if mode == K.MODE_BF16 else x32
            if mode == K.MODE_F32:
                tol, (t_ops, t_bytes, _) = REL_TOL, block_bound_ms(h * w, c)

                def plain(x=x, p=p):
                    return K.convnext_block_plain(x, p)
            else:
                flops16, flops32, nbytes = block_work_bf16(h * w, c, 4 if mode == K.MODE_BF16_MODULE else 2)
                tol = BF16_TOL
                t_ops = (flops16 / PEAK_BF16_FLOPS + flops32 / PEAK_F32_FLOPS) * 1e3
                t_bytes = nbytes / PEAK_BYTES * 1e3

                def plain(x=x, p=p, module=mode == K.MODE_BF16_MODULE):
                    return K.convnext_block_plain_bf16(x, p, module)

            def kernel(x=x, mode=mode):
                return op(x, *params, mode)

            with torch.inference_mode():
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
                err = float((got.float() - want.float()).abs().max())
                rel = err / float(want.float().abs().max())
                ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            print(
                f"convnext_block operator {label} {h}x{w}x{c}: max_abs_err={err:.3e} rel={rel:.3e} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={max(t_ops, t_bytes):.4f}",
                flush=True,
            )
            if got.dtype != x.dtype or not rel <= tol:
                raise AssertionError(
                    f"convnext_block operator {label} {h}x{w}x{c}: {got.dtype}, relative error {rel} > {tol}")
            total = totals[label]
            total["max_abs_err"] = max(total["max_abs_err"], err)
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("t_ops", t_ops), ("t_bytes", t_bytes)):
                total[key] += blocks * v
    rows = {
        label: {
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t["t_ops"], t["t_bytes"]),
            "bound_by": "operations" if t["t_ops"] >= t["t_bytes"] else "bytes",
        }
        for label, t in totals.items()
    }
    return {**rows["f32"], "modes": {label: rows[label] for label in ("bf16", "bf16_module")}}


def check_bf16_program_packs(params, device) -> None:
    """A loaded program that calls the block operator in bf16 (the Pallas
    mode; one flagship block, exported with static shapes) over and over
    packs the block's weights once, in and out of inference mode, and
    equals the eager block bit for bit."""
    import tempfile

    import torch

    from adascale_torch.kernels import convnext_block as K
    from adascale_torch.kernels import packing
    from adascale_torch.models.convnext import ConvNeXtBlock
    from adascale_torch.utils.params import state_dict_from_jax

    block = ConvNeXtBlock(96, 0.0, torch.bfloat16, torch.bfloat16)
    sd = state_dict_from_jax(params["backbone"]["stage0"]["layer0"])
    block.load_state_dict(sd)
    block = block.to(device).eval()
    x = (torch.randn(1, 240, 192, 96, generator=torch.Generator().manual_seed(2)) * 0.5).to(device, torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix=".export-", dir=ROOT) as out:
        with torch.no_grad():
            program = torch.export.export(block, (x,))
        torch.export.save(program, os.path.join(out, "block.pt2"))
        loaded = torch.export.load(os.path.join(out, "block.pt2")).module()
    packs, launches = packing.PACKS, K.LAUNCHES_BF16
    outs = [loaded(x) for _ in range(3)]
    with torch.inference_mode():
        outs += [loaded(x) for _ in range(3)]
    torch.cuda.synchronize()
    built, ran = packing.PACKS - packs, K.LAUNCHES_BF16 - launches
    with torch.no_grad():  # the eager block's own parameters: a pack of its own
        want = block(x)
    equal = all(torch.equal(o, want) for o in outs)
    print(f"bf16 block program: 6 calls, {ran} bf16 launches, {built} weight packs, equal to eager: {equal}",
          flush=True)
    if built != 1 or ran != 6 or not equal:
        raise AssertionError(f"bf16 block program: packs {built} (want 1), launches {ran} (want 6), equal {equal}")


# Run by check_export in a fresh interpreter from the checkout's root:
# loads the FPN programs in FOLDER (argv[1]) with nothing set beforehand,
# runs each at the input saved beside it, and saves the outputs, the block
# launches, the precision flags before and after load_program, and the
# rough program's outputs run inside matmul_precision("default") (TF32 let
# back into cuDNN and cuBLAS, the kernels' TF32 entries chosen): a program
# computes at "highest" whatever the scope.
FRESH_PROGRAM_SCRIPT = r"""
import sys

import torch

flags_before = [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]
from adascale_torch.inference.export import load_program
from adascale_torch.kernels import convnext_block as K
from adascale_torch.utils.precision import matmul_precision

folder, outputs, launches = sys.argv[1], {}, {}
for which in ("rough", "precise"):
    module = load_program(f"{folder}/forward_{which}.pt2").module()
    x = torch.load(f"{folder}/x_{which}.pt")
    count = K.LAUNCHES
    with torch.inference_mode():
        outputs[which] = [t.cpu() for t in module(x)]
    launches[which] = K.LAUNCHES - count
    if which == "rough":
        rough, x_rough = module, x
flags_after = [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]
count = K.LAUNCHES
with torch.inference_mode(), matmul_precision("default"):
    outputs["rough_tf32"] = [t.cpu() for t in rough(x_rough)]
launches["rough_tf32"] = K.LAUNCHES - count
torch.save({"outputs": outputs, "launches": launches, "flags_before": flags_before,
            "flags_after": flags_after}, f"{folder}/fresh.pt")
"""


def export_checked(label: str, params, engine, inputs, out_dir: str) -> dict:
    """``export_program`` of ``engine``'s model (its config, ``params``) on
    the card into ``out_dir``, each pass loaded back and run on each
    ``(which, x)`` of ``inputs`` against the eager model: b,h,w in the
    manifest, one operator call a block in each graph, exactly one block
    launch a block and no neck or heads launch a run, each output within
    EXPORT_REL_TOL. Returns the loaded modules, the seconds, the launches by
    run, those of the B = 1 runs summed, and the eager outputs by run."""
    import torch

    from adascale_torch.inference.export import export_program, load_program

    blocks_per_pass = sum(n for _, n in engine.config.model.backbone_spec())
    t = time.perf_counter()
    manifest = export_program(params, engine.config.model, out_dir, example_hw=EXPORT_EXAMPLE_HW,
                              device=str(engine.device))
    export_s = time.perf_counter() - t
    sizes = {k: os.path.getsize(os.path.join(out_dir, v["path"])) for k, v in manifest.items()}
    print(f"{label} export_program: {export_s:.2f} s; manifest {json.dumps(manifest)}; bytes {sizes}", flush=True)
    if any(v["symbolic_axes"] != "b,h,w" for v in manifest.values()):
        raise AssertionError(f"{label} export: not b,h,w: {manifest}")
    t = time.perf_counter()
    programs = {
        which: load_program(os.path.join(out_dir, manifest[f"forward_{which}"]["path"]))
        for which in ("rough", "precise")
    }
    modules = {which: program.module() for which, program in programs.items()}
    load_s = time.perf_counter() - t
    ops = {
        which: sum(n.target == torch.ops.adascale_torch.convnext_block.default for n in program.graph.nodes)
        for which, program in programs.items()
    }
    print(f"{label} load_program: {load_s:.2f} s for both; block operator calls in the graphs {ops}", flush=True)
    if set(ops.values()) != {blocks_per_pass}:
        raise AssertionError(f"{label} export: block operator calls {ops}, want {blocks_per_pass} a pass")
    launches, program_launches, eager = {}, 0, {}
    want_counts = {k: blocks_per_pass if k == "convnext_block" else 0 for k in KERNEL_NAMES}
    with torch.inference_mode():
        for which, x in inputs:
            run = f"{which} {tuple(x.shape)}"
            got, counts = counted(lambda: modules[which](x))
            want = getattr(engine.model, f"forward_{which}")(x)
            rels = [rel_err(g, w_) for g, w_ in zip(got, want)]
            equal = all(torch.equal(g, w_) for g, w_ in zip(got, want))
            print(
                f"{label} loaded program {run}: rel err vs eager per output "
                + " ".join(f"{r:.3e}" for r in rels) + f" (bit-equal: {equal}); launches {counts}",
                flush=True,
            )
            if counts != want_counts:
                raise AssertionError(f"{label} loaded program {run}: launches {counts} != {want_counts}")
            if not max(rels) <= EXPORT_REL_TOL:
                raise AssertionError(f"{label} loaded program {run}: rel err {max(rels)} > {EXPORT_REL_TOL}")
            launches[run], eager[run] = counts["convnext_block"], want
            if x.shape[0] == 1:
                program_launches += counts["convnext_block"]
    return {"modules": modules, "export_s": export_s, "load_s": load_s, "launches": launches,
            "program_launches": program_launches, "eager": eager}


def start_fresh_process(folder: str, x_rough, x_precise):
    """Starts loading and running the FPN programs in ``folder`` in a fresh
    interpreter (FRESH_PROGRAM_SCRIPT) at page_0's rough input and precise
    stack; ``check_fresh_process`` waits for it."""
    import sys
    import tempfile

    import torch

    for which, x in (("rough", x_rough), ("precise", x_precise)):  # loaded back onto the card
        torch.save(x, os.path.join(folder, f"x_{which}.pt"))
    log = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", FRESH_PROGRAM_SCRIPT, folder], cwd=ROOT,
                            stdout=log, stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter(), log


def check_fresh_process(proc, t, log, folder: str, x_rough, x_precise, eager, blocks_per_pass: int) -> dict:
    """The fresh interpreter of ``start_fresh_process`` ends within 300 s:
    each output within EXPORT_REL_TOL of ``eager``'s (by run, as
    ``export_checked`` keys them), ``blocks_per_pass`` launches a pass, TF32
    off after ``load_program``; the rough program run inside
    ``matmul_precision("default")`` equal bit for bit to its run outside,
    with ``blocks_per_pass`` 3xTF32 launches. Returns the errors."""
    import torch

    inputs = {"rough": x_rough, "precise": x_precise}
    try:
        proc.wait(timeout=max(300 - (time.perf_counter() - t), 1.0))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t
    if proc.returncode:
        log.seek(0)
        print(log.read()[-8000:], flush=True)
        raise AssertionError(f"fresh interpreter: exit code {proc.returncode}")
    fresh = torch.load(os.path.join(folder, "fresh.pt"))
    rels = {}
    for which, x in inputs.items():
        want = eager[f"{which} {tuple(x.shape)}"]
        rels[which] = [rel_err(g.to(w_.device), w_) for g, w_ in zip(fresh["outputs"][which], want)]
    tf32 = [rel_err(g.to(w_.device), w_)
            for g, w_ in zip(fresh["outputs"]["rough_tf32"], eager[f"rough {tuple(x_rough.shape)}"])]
    scoped_equal = all(torch.equal(a, b) for a, b in zip(fresh["outputs"]["rough_tf32"], fresh["outputs"]["rough"]))
    print(
        f"fresh interpreter ({seconds:.2f} s): flags (cudnn, matmul allow_tf32) before load_program "
        f"{fresh['flags_before']}, after {fresh['flags_after']}; block launches {fresh['launches']}; rel err vs "
        "eager per output " + "; ".join(f"{k} " + " ".join(f"{r:.3e}" for r in v) for k, v in rels.items())
        + "; rough inside matmul_precision(\"default\") " + " ".join(f"{r:.3e}" for r in tf32)
        + f" (equal bit for bit to the run outside: {scoped_equal}; block launches "
        f"{fresh['launches']['rough_tf32']})",
        flush=True,
    )
    if any(fresh["flags_after"]):
        raise AssertionError(f"fresh interpreter: TF32 still allowed after load_program {fresh['flags_after']}")
    if not scoped_equal:
        raise AssertionError("fresh interpreter: the rough program inside a \"default\" scope differs")
    if set(fresh["launches"].values()) != {blocks_per_pass}:
        raise AssertionError(f"fresh interpreter: block launches {fresh['launches']}, want {blocks_per_pass} a pass")
    worst = max(max(v) for v in rels.values())
    if not worst <= EXPORT_REL_TOL:
        raise AssertionError(f"fresh interpreter: rel err {worst} > {EXPORT_REL_TOL}")
    return {"seconds": seconds, "rel_err": rels, "rel_err_tf32": tf32}


def check_export(params, image, ref, device) -> dict:
    """Phase export (module docstring). Returns the block operator's
    launches through the loaded FPN programs on page_0 (both passes), the
    CLI's launches, and the times."""
    import runpy
    import shutil
    import sys
    import tempfile

    import numpy as np
    import torch

    from adascale_torch import AdaptiveScalingInference
    from adascale_torch.data.geometry import Polygon
    from adascale_torch.inference.eval import match_polygons
    from adascale_torch.kernels import packing
    from adascale_torch.utils.params import load_npz
    from adascale_torch.utils.png import write_png

    engine = engine_for(params)
    blocks_per_pass = sum(n for _, n in engine.config.model.backbone_spec())
    out_dir = tempfile.mkdtemp(prefix=".export-", dir=ROOT)
    fresh_proc = None
    try:
        result = engine.detect(image)
        x_rough, x_precise = forward_inputs(image, result, device)
        x2 = (torch.rand(EXPORT_SECOND_SHAPE, generator=torch.Generator().manual_seed(1)) * 255).to(device)
        packs = packing.PACKS
        fpn_dir = os.path.join(out_dir, "fpn")
        fpn = export_checked("FPN", params, engine, [
            ("rough", x_rough), ("precise", x_precise), ("rough", x2), ("precise", x2)], fpn_dir)
        modules = fpn["modules"]
        times = {}
        with torch.inference_mode():
            for which, x in (("rough", x_rough), ("precise", x_precise)):
                eager = getattr(engine.model, f"forward_{which}")
                times[which] = {"eager_ms": cuda_ms(lambda: eager(x), reps=5),
                                "program_ms": cuda_ms(lambda: modules[which](x), reps=5)}
        print(f"forward ms, eager module model against the loaded program (CUDA events, warm): {json.dumps(times)}",
              flush=True)
        if packing.PACKS != packs:
            raise AssertionError(f"the f32 programs built {packing.PACKS - packs} weight packs")
        # The fresh interpreter runs beside the bf16 and UPerNeXt checks
        # below (none of them timed but their export and load walls).
        fresh_proc = start_fresh_process(fpn_dir, x_rough, x_precise)
        out = {k: fpn[k] for k in ("program_launches", "launches", "export_s", "load_s")}
        fpn_eager = fpn["eager"]
        del fpn, modules
        check_bf16_program_packs(params, device)

        stamp("export: the UPerNeXt flagship")
        upernext = engine_for(load_npz(UPERNEXT_WEIGHTS), neck_head_type="upernext")
        _, x_precise_u = forward_inputs(image, upernext.detect(image), device)
        up = export_checked("UPerNeXt", load_npz(UPERNEXT_WEIGHTS), upernext, [
            ("rough", x_rough), ("precise", x_precise_u), ("rough", x2), ("precise", x2)],
            os.path.join(out_dir, "upernext"))
        out["upernext"] = {k: up[k] for k in ("program_launches", "launches", "export_s", "load_s")}
        del upernext, up
        fresh = check_fresh_process(*fresh_proc, fpn_dir, x_rough, x_precise, fpn_eager, blocks_per_pass)
        fresh_proc = None
        shutil.rmtree(fpn_dir)

        stamp("export: python -m adascale_torch detect on page_0 as a PNG")
        png, out_json = os.path.join(out_dir, "page_0.png"), os.path.join(out_dir, "detect.json")
        write_png(png, image)
        captured = []
        detect = AdaptiveScalingInference.detect

        def recording(self, *args, **kwargs):
            captured.append(detect(self, *args, **kwargs))
            return captured[-1]

        argv = sys.argv
        sys.argv = ["adascale_torch", "detect", "--checkpoint", WEIGHTS, "--image", png,
                    "--model-config", MODEL_JSON, "--output", out_json]
        AdaptiveScalingInference.detect = recording
        try:
            t = time.perf_counter()
            _, cli_launches = counted(lambda: runpy.run_module("adascale_torch", run_name="__main__"))
            cli_s = time.perf_counter() - t
        finally:
            AdaptiveScalingInference.detect, sys.argv = detect, argv
        with open(out_json) as fin:
            written = json.load(fin)
        print(f"detect CLI: {cli_s:.2f} s, {written['num_chars']} chars, launches {cli_launches}", flush=True)
        check_against_reference(captured[0], ref, f"CLI LAUNCHES={cli_launches}")
        polygons = [Polygon(np.asarray(p)) for p in written["char_polygons"]]
        theirs = [Polygon(p) for p in ref["char_polygons"]]
        matched = len(match_polygons(polygons, theirs, 0.5))
        if written["num_chars"] != len(polygons) or min(matched / len(theirs), matched / len(polygons)) < 0.95:
            raise AssertionError(f"detect CLI JSON: {matched} of {len(polygons)} / {len(theirs)} polygons matched")
        want = {k: 2 * blocks_per_pass if k == "convnext_block" else 0 for k in KERNEL_NAMES}
        if cli_launches != want:
            raise AssertionError(f"detect CLI: launches {cli_launches} != {want}")
    finally:
        if fresh_proc is not None and fresh_proc[0].poll() is None:
            fresh_proc[0].kill()
            fresh_proc[0].wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    return {**out, "cli_launches": cli_launches, "cli_s": cli_s, "times": times, "fresh": fresh}


FLAGSHIP_DIR = os.path.join(ROOT, "examples/flagship_training")
UPERNEXT_DIR = os.path.join(ROOT, "examples/flagship_upernext")
# Phase loop's runs of each flagship's own {dataset,epoch,model,steps}.json
# from its weights: (label, folder, weights, epochs, train batches, dev
# batches, epoch config overrides). Cuts: the depth (the files: 40 epochs of
# 1000 batches, 8 dev batches); the last run's dtype (the files ask bf16: the
# f32 loop stays a path); where the pages are drawn: a spawned pool's start
# costs ~15-20 s (PR 17 calls 22-25), so only the first run's training
# batches come from a 4-process pool, as the files ask, and every other
# page (the dev batches, the later runs) is drawn in the trainer's process.
# The first run is the main one (restore, export and the detect CLI on its
# checkpoint); every run restores its last checkpoint.
IN_PROCESS = {"train_num_processes": 0, "dev_num_processes": 0}
LOOP_RUNS = (
    ("fpn_bf16", FLAGSHIP_DIR, WEIGHTS, 2, 6, 1, {"dev_num_processes": 0}),
    ("upernext_bf16", UPERNEXT_DIR, UPERNEXT_WEIGHTS, 1, 2, 1, IN_PROCESS),
    ("fpn_f32", FLAGSHIP_DIR, WEIGHTS, 1, 2, 1, {"compute_dtype": "float32", **IN_PROCESS}),
)
# Each run's launch paths: its steps' and its dev batches'.
LOOP_PATHS = {
    "fpn_bf16": ("train_loop_steps_bf16", "train_loop_dev_bf16"),
    "upernext_bf16": ("train_loop_upernext_bf16", "train_loop_upernext_dev_bf16"),
    "fpn_f32": ("train_loop_steps", "train_loop_dev"),
}
LOOP_POOL_RUNS = 12  # pages timed through a warm 4-process pool
LOOP_CHECKPOINT = re.compile(r"state_(\d+)(_not_best)?")
# Paths whose block launches are the trainable blocks' (rows 1' and 1b').
TRAIN_PATHS = ("train_step", "train_step_bf16", "mesh_train_step", "mesh_train_step_bf16", "mesh_cli_train",
               "tools_train_profile", "tools_train_profile_bf16") + tuple(p for pair in LOOP_PATHS.values() for p in pair)


def loop_run(label: str, folder: str, weights: str, epochs: int, batches: int, dev_batches: int,
             overrides: dict, out_dir: str, device) -> dict:
    """One ``training.loop.train`` of a flagship's own configs (LOOP_RUNS),
    cut to ``epochs`` x ``batches`` and ``dev_batches``: every loss finite,
    exactly one block launch a block in every step and dev batch, all of
    the run's dtype (the module-mode bf16 kernel at bf16), the checkpoints
    one an epoch; the last one restored into a new model and optimizer
    equal bit for bit to the file, its step count and lr the run's."""
    import torch

    from adascale_torch.kernels import convnext_block as K
    from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
    from adascale_torch.training import OptimizerConfig, build_optimizer
    from adascale_torch.training.checkpoint import latest_checkpoint_path, restore_checkpoint
    from adascale_torch.training.loop import train
    from adascale_torch.utils.config import load_config

    def config_json(name):
        with open(os.path.join(folder, name)) as fin:
            return json.load(fin)

    smi = smi_line()
    steps_path = os.path.join(folder, "steps.json")
    dataset = config_json("dataset.json")
    dataset["train_adaptive_scaling_dataset_steps_jsons"] = [steps_path]
    dataset["dev_adaptive_scaling_dataset_steps_json"] = steps_path
    epoch = dict(config_json("epoch.json"), num_epochs=epochs, train_num_batches=batches,
                 dev_num_batches=dev_batches, **overrides)
    bf16 = epoch["compute_dtype"] == "bfloat16"
    model_json = os.path.join(folder, "model.json")
    model_config = load_config(model_json, AdaptiveScalingConfig)
    batch = epoch["train_batch_size"]
    print(f"loop {label}: epoch config {json.dumps(epoch)}", flush=True)

    run_dir = os.path.join(out_dir, label)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = K.LAUNCHES_BF16 = 0
    t = time.perf_counter()
    metrics = train(json.dumps(dataset), run_dir, epoch_config_json=json.dumps(epoch),
                    model_config_json=model_json, init_params_path=weights, device=str(device))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches, other = (K.LAUNCHES_BF16, K.LAUNCHES) if bf16 else (K.LAUNCHES, K.LAUNCHES_BF16)
    peak = torch.cuda.max_memory_allocated()
    epochs_out = metrics["epochs"]
    step_launches = [n for e in epochs_out for n in e["step_launches"]]
    dev_launches = [n for e in epochs_out for n in e["dev_launches"]]
    blocks = 2 * sum(n for _, n in model_config.backbone_spec())
    for e in epochs_out:
        print(f"loop {label}: epoch {e['epoch']}: wall {e['wall_s']:.2f} s, data stall {e['data_stall_s']:.3f} s "
              f"({100 * e['data_stall_s'] / e['wall_s']:.1f} %), step ms (CUDA events) "
              + ", ".join(f"{v:.1f}" for v in e["step_ms"])
              + f"; train losses (window means) rough {e['train_rough_loss']:.5f} precise "
              f"{e['train_precise_loss']:.5f}; checkpoint {e['checkpoint'] and os.path.basename(e['checkpoint'])}",
              flush=True)
    warm = epochs_out[-1]
    step_ms = statistics.median(warm["step_ms"][1:] if epochs == 1 else warm["step_ms"])
    stall = warm["data_stall_s"] / warm["wall_s"]
    print(f"loop {label}: train() {train_s:.2f} s; step (epoch {warm['epoch']}, median"
          f"{' but the first' if epochs == 1 else ''}, CUDA events) {step_ms:.3f} ms, "
          f"{batch / step_ms * 1e3:.2f} samples/s; epoch wall {warm['wall_s']:.3f} s = "
          f"{batch * batches / warm['wall_s']:.2f} samples/s end to end; prefetcher stall share "
          f"{100 * stall:.2f} %; peak memory {peak / 2**30:.3f} GiB; dev losses rough "
          f"{metrics['dev_rough_loss']:.5f} precise {metrics['dev_precise_loss']:.5f}; "
          f"{'bf16 module-mode' if bf16 else 'f32'} block launches a step {sorted(set(step_launches))}, "
          f"a dev batch {sorted(set(dev_launches))}, {launches} in all ({smi})", flush=True)

    losses = [metrics["dev_rough_loss"], metrics["dev_precise_loss"]] + [
        v for e in epochs_out for v in (e["train_rough_loss"], e["train_precise_loss"])]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"loop {label}: a loss is not finite: {losses}")
    if (step_launches != [blocks] * (epochs * batches) or dev_launches != [blocks] * (epochs * dev_batches)
            or launches != sum(step_launches) + sum(dev_launches) or other):
        raise AssertionError(f"loop {label}: block launches: steps {step_launches}, dev {dev_launches}, "
                             f"all {launches}, of the other dtype {other}")
    names = sorted(n for n in os.listdir(run_dir) if LOOP_CHECKPOINT.fullmatch(n))
    written = [os.path.basename(e["checkpoint"]) for e in epochs_out if e["checkpoint"]]
    last = latest_checkpoint_path(run_dir)
    if (names != sorted(written) or names[0] != "state_0" or len(names) != epochs
            or os.path.basename(last) not in (f"state_{epochs - 1}", f"state_{epochs - 1}_not_best")):
        raise AssertionError(f"loop {label}: checkpoints {os.listdir(run_dir)}, written {written}, latest {last}")

    payload = torch.load(last, map_location="cpu", weights_only=True)
    model = AdaptiveScaling(model_config).to(device)
    optimizer, schedule = build_optimizer(dict(model.named_parameters()), OptimizerConfig(), batches)
    restored = restore_checkpoint(last, model, optimizer)
    differ = [k for k, v in model.state_dict().items() if not torch.equal(v.cpu(), payload["params"][k])]
    differ += [f"{w}:{k}" for w in ("mu", "nu") for k, v in getattr(optimizer, w).items()
               if not torch.equal(v.cpu(), payload["opt_state"][w][k])]
    not_f32 = [k for k, v in payload["params"].items() if v.dtype != torch.float32]
    lr = schedule(optimizer.count)
    print(f"loop {label}: restored {os.path.basename(last)}: epoch {restored['epoch_idx']}, step count "
          f"{optimizer.count}, lr {lr:.6e} (the run's next {warm['lr_next_step']:.6e}), "
          f"{len(payload['params'])} parameters (not f32: {len(not_f32)}) and {2 * len(optimizer.mu)} moments, "
          f"{len(differ)} differ", flush=True)
    if (differ or not_f32 or restored["epoch_idx"] != epochs - 1 or optimizer.count != epochs * batches
            or lr != warm["lr_next_step"]):
        raise AssertionError(f"loop {label}: restore: {differ[:5]}, not f32 {not_f32[:5]}, epoch "
                             f"{restored['epoch_idx']}, count {optimizer.count}, lr {lr}")
    steps_path_name, dev_path_name = LOOP_PATHS[label]
    kernel = "convnext_block_bf16" if bf16 else "convnext_block"
    return {"paths": {steps_path_name: {kernel: sum(step_launches)}, dev_path_name: {kernel: sum(dev_launches)}},
            "step_ms": step_ms, "stall_share": stall, "peak_bytes": peak, "train_s": train_s,
            "last": last, "model_json": model_json, "model_config": model_config, "blocks": blocks}


def check_loop(image, device) -> dict:
    """Phase loop (module docstring): ``training.loop.train`` on each
    flagship's own configs (LOOP_RUNS), the checkpoints and a restore each;
    the main run's checkpoint exported and served by ``python -m
    adascale_torch detect``."""
    import runpy
    import shutil
    import sys
    import tempfile

    from adascale_torch import AdaptiveScalingInference, AdaptiveScalingInferenceConfig, native
    from adascale_torch.data.dataset import GeneratorPool, SynthPipelineConfig
    from adascale_torch.training.loop import export_inference_artifact
    from adascale_torch.utils.config import load_config
    from adascale_torch.utils.params import load_params
    from adascale_torch.utils.png import write_png

    smi = smi_line()
    phase_t = time.perf_counter()
    cached = os.path.exists(native.library_path())
    t = time.perf_counter()
    native.load_library()
    print(f"loop: native renderer build {time.perf_counter() - t:.2f} s (g++; cached {cached}) ({smi})", flush=True)

    with open(os.path.join(FLAGSHIP_DIR, "epoch.json")) as fin:
        processes = json.load(fin)["train_num_processes"]
    pipeline = load_config(os.path.join(FLAGSHIP_DIR, "steps.json"), SynthPipelineConfig)
    pool = GeneratorPool(pipeline, rng_seed=1, num_processes=processes)
    try:
        t = time.perf_counter()
        pool.run()
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(LOOP_POOL_RUNS):
            pool.run()
        pages_per_s = LOOP_POOL_RUNS / (time.perf_counter() - t)
    finally:
        pool.cleanup()
    print(f"loop: generator pool ({processes} spawned processes, "
          f"{pipeline.page.page_height}x{pipeline.page.page_width} pages): "
          f"first page {first_s:.2f} s (start included), then {pages_per_s:.2f} pages/s over "
          f"{LOOP_POOL_RUNS} pages ({smi})", flush=True)

    out_dir = tempfile.mkdtemp(prefix=".loop-", dir=ROOT)
    paths, runs = {}, {}
    try:
        for label, folder, weights, epochs, batches, dev_batches, overrides in LOOP_RUNS:
            stamp(f"loop: {label}")
            runs[label] = loop_run(label, folder, weights, epochs, batches, dev_batches, overrides, out_dir,
                                   device)
            paths.update(runs[label]["paths"])

        main = runs[LOOP_RUNS[0][0]]
        stamp(f"loop: export {LOOP_RUNS[0][0]}'s checkpoint and serve it with python -m adascale_torch detect")
        artifact = export_inference_artifact(main["last"], os.path.join(out_dir, "artifact"), main["model_json"])
        png, out_json = os.path.join(out_dir, "page_0.png"), os.path.join(out_dir, "detect.json")
        write_png(png, image)
        argv = sys.argv
        sys.argv = ["adascale_torch", "detect", "--checkpoint", os.path.join(artifact, "params.npz"), "--image",
                    png, "--model-config", os.path.join(artifact, "model_config.json"), "--output", out_json,
                    "--device", device.type]
        try:
            _, cli_launches = counted(lambda: runpy.run_module("adascale_torch", run_name="__main__"))
        finally:
            sys.argv = argv
        with open(out_json) as fin:
            served = json.load(fin)["char_polygons"]
        model_config = main["model_config"]
        params = load_params(main["last"], model_config)
        engine = AdaptiveScalingInference(AdaptiveScalingInferenceConfig(model=model_config, device=device.type),
                                          params=params)
        direct = [p.points.tolist() for p in engine.detect(image)["char_polygons"]]
        import numpy as np

        with np.load(os.path.join(artifact, "params.npz")) as flat:
            not_f32 = [k for k in flat.files if flat[k].dtype != np.float32]
        print(f"loop: detect CLI on the exported artifact ({'f32' if not not_f32 else 'NOT f32'}): {len(served)} "
              f"polygons, launches {cli_launches}; an engine from the checkpoint's params: {len(direct)} polygons, "
              f"equal {served == direct}", flush=True)
        want = {k: main["blocks"] if k == "convnext_block" else 0 for k in KERNEL_NAMES}
        if cli_launches != want or served != direct or not_f32:
            raise AssertionError(f"exported artifact: launches {cli_launches} != {want}, polygons "
                                 f"{len(served)} / {len(direct)}, not f32 {not_f32[:5]}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"phase loop: {time.perf_counter() - phase_t:.2f} s", flush=True)
    return {"paths": paths, "cli_launches": cli_launches, "pages_per_s": pages_per_s,
            "runs": {k: {m: v[m] for m in ("step_ms", "stall_share", "peak_bytes", "train_s")} for k, v in runs.items()}}


MESH_STEPS = 3  # warm steps timed for each of the plain and the mesh step (after one checked step each)
SYNTH_DIR = os.path.join(ROOT, "examples/synthetic_training")
# The CLI run's cut of examples/synthetic_training/epoch.json (3 epochs of
# 150 batches, 8 dev batches).
MESH_CLI_EPOCH = {"num_epochs": 1, "train_num_batches": 2, "dev_num_batches": 1}
MESH_CLI_TIMEOUT_S = 240


def mesh_step_checked(params, device, mesh, compute_dtype: str) -> dict:
    """Phase mesh: the flagship's step at B = TRAIN_BATCH on a world-size-1
    mesh against the mesh-less step from the same state and generator:
    losses, grad norm and every parameter after one step equal bit for bit
    (cuDNN's deterministic algorithms for the two checked steps), one block
    launch a block of the step's dtype; then warm steps of each, timed with
    CUDA events in turn."""
    import torch

    from adascale_torch.kernels import convnext_block as K
    from adascale_torch.training import OptimizerConfig, TrainStepConfig, build_optimizer, make_train_step
    from adascale_torch.training import seeded_batches

    bf16 = compute_dtype == "bfloat16"
    rough, precise, rough_box, precise_box = seeded_batches(1, TRAIN_BATCH)
    cfg = TrainStepConfig(rough_core_box=rough_box, precise_core_box=precise_box, compute_dtype=compute_dtype)
    runs = {}
    for label, use in (("plain", None), ("mesh", mesh)):
        model = flagship_model(params, device, torch.bfloat16 if bf16 else torch.float32)
        opt, _ = build_optimizer(dict(model.named_parameters()), OptimizerConfig(), steps_per_epoch=1000)
        runs[label] = (model, make_train_step(model, opt, cfg, device=str(device), mesh=use),
                       torch.Generator(device=device).manual_seed(0))
    blocks = 2 * len(runs["plain"][0].backbone.blocks())
    out = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        for label, (model, step, gen) in runs.items():
            K.LAUNCHES = K.LAUNCHES_BF16 = 0
            metrics = step(rough, precise, gen)
            torch.cuda.synchronize()
            out[label] = ({k: v.clone() for k, v in metrics.items()}, K.LAUNCHES, K.LAUNCHES_BF16)
    (plain, _, _), (meshed, f32_launches, bf16_launches) = out["plain"], out["mesh"]
    launches, other = (bf16_launches, f32_launches) if bf16 else (f32_launches, bf16_launches)
    differ = [k for k, v in runs["plain"][0].state_dict().items() if not torch.equal(v, runs["mesh"][0].state_dict()[k])]
    unequal = [k for k in plain if not torch.equal(plain[k], meshed[k])]
    print(f"mesh step ({compute_dtype}, B={TRAIN_BATCH}, world size 1, NCCL): losses (rough, precise, grad norm) "
          f"mesh {float(meshed['rough_loss']):.7f}, {float(meshed['precise_loss']):.7f}, "
          f"{float(meshed['grad_norm']):.7f}; plain {float(plain['rough_loss']):.7f}, "
          f"{float(plain['precise_loss']):.7f}, {float(plain['grad_norm']):.7f}; metrics that differ {unequal}; "
          f"parameters that differ after the step {len(differ)} of {len(runs['plain'][0].state_dict())}; "
          f"block launches {launches} (the other dtype's {other})", flush=True)
    if unequal or differ or launches != blocks or other:
        raise AssertionError(f"mesh step ({compute_dtype}): metrics {unequal}, parameters {differ[:5]}, "
                             f"launches {launches} / {blocks}, of the other dtype {other}")

    times = {"plain": [], "mesh": []}
    for _, step, gen in runs.values():
        step(rough, precise, gen)  # warm: the first step out of cuDNN's deterministic algorithms
    for _ in range(MESH_STEPS):
        for label, (_, step, gen) in runs.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(rough, precise, gen)
            end.record()
            end.synchronize()
            times[label].append(start.elapsed_time(end))
    ms = {k: statistics.median(v) for k, v in times.items()}
    print(f"mesh step ({compute_dtype}): {ms['mesh']:.3f} ms against the plain step's {ms['plain']:.3f} ms "
          f"(median of {MESH_STEPS} steps each after a warm one, in turn, CUDA events; mesh "
          + ", ".join(f"{v:.1f}" for v in times["mesh"]) + "; plain "
          + ", ".join(f"{v:.1f}" for v in times["plain"]) + f") ({smi_line()})", flush=True)
    kernel = "convnext_block_bf16" if bf16 else "convnext_block"
    return {"launches": {kernel: launches}, "ms": ms}


def mesh_detect_many_checked(params, mesh) -> dict:
    """Phase mesh: phase 11's detect_many (the three shift pages and a blank
    page, fused f32) on the world-size-1 mesh against the mesh-less run:
    every page's maps and polygons equal bit for bit, the launches
    MANY_LAUNCHES; both runs' wall ms."""
    import numpy as np

    from adascale_torch import BatchedAdaptiveScalingInference

    pages = [np.load(p)["image"] for p in SHIFT_PAGES] + [np.zeros(BLANK_SHAPE, np.uint8)]
    engine = engine_for(params, use_pallas_neck_heads=True)
    t = time.perf_counter()
    want = BatchedAdaptiveScalingInference(engine).detect_many(pages)
    plain_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    got, launches = counted(lambda: BatchedAdaptiveScalingInference(engine, mesh=mesh).detect_many(pages))
    mesh_ms = (time.perf_counter() - t) * 1e3
    differ = []
    for k, (g, w) in enumerate(zip(got, want)):
        arrays = [(g["rough"].rough_char_mask, w["rough"].rough_char_mask),
                  (g["rough"].rough_char_height_score_map, w["rough"].rough_char_height_score_map),
                  (g["precise"].precise_char_prob_score_map, w["precise"].precise_char_prob_score_map),
                  (g["precise"].precise_np_char_corner_distance, w["precise"].precise_np_char_corner_distance)]
        if not all(np.array_equal(a, b) for a, b in arrays):
            differ.append(f"page {k} maps")
        if [p.points.tolist() for p in g["char_polygons"]] != [p.points.tolist() for p in w["char_polygons"]]:
            differ.append(f"page {k} polygons")
    print(f"mesh detect_many (fused f32, world size 1): {len(pages)} pages, polygons "
          f"{[len(r['char_polygons']) for r in got]}, {mesh_ms:.1f} ms wall (the mesh-less run {plain_ms:.1f} ms, "
          f"its first); differ {differ}; LAUNCHES={launches} ({smi_line()})", flush=True)
    if differ or launches != MANY_LAUNCHES:
        raise AssertionError(f"mesh detect_many: {differ}, launches {launches} != {MANY_LAUNCHES}")
    return {"launches": launches, "ms": mesh_ms, "plain_ms": plain_ms}


def mesh_cli_start(out_dir: str):
    """Phase mesh: starts ``python -m torch.distributed.run --standalone
    --nproc_per_node=1 -m adascale_torch train --mesh`` on
    examples/synthetic_training's configs (the "python" render backend), cut
    to MESH_CLI_EPOCH; ``mesh_cli_finish`` waits for it."""
    import sys

    def config_json(name):
        with open(os.path.join(SYNTH_DIR, name)) as fin:
            return json.load(fin)

    steps = os.path.join(SYNTH_DIR, "steps.json")
    dataset = dict(config_json("dataset.json"), train_adaptive_scaling_dataset_steps_jsons=[steps],
                   dev_adaptive_scaling_dataset_steps_json=steps)
    epoch = dict(config_json("epoch.json"), **MESH_CLI_EPOCH)
    paths = {}
    for name, obj in (("dataset", dataset), ("epoch", epoch)):
        paths[name] = os.path.join(out_dir, f"{name}.json")
        with open(paths[name], "w") as fout:
            json.dump(obj, fout)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1", "-m",
           "adascale_torch", "train", "--mesh", "--dataset-config", paths["dataset"], "--epoch-config",
           paths["epoch"], "--model-config", os.path.join(SYNTH_DIR, "model.json"), "--output",
           os.path.join(out_dir, "run")]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, epoch, time.perf_counter()


def mesh_cli_finish(proc, epoch, t0) -> dict:
    """Phase mesh: the torchrun CLI run ends within MESH_CLI_TIMEOUT_S with
    exit 0, finite losses and one block launch a block in every step and dev
    batch (from the metrics it prints)."""
    from adascale_torch.models.adaptive_scaling import AdaptiveScalingConfig
    from adascale_torch.utils.config import load_config

    try:
        out, err = proc.communicate(timeout=max(MESH_CLI_TIMEOUT_S - (time.perf_counter() - t0), 1.0))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun train --mesh exited {proc.returncode}:\n{out[-3000:]}\n{err[-6000:]}")
    metrics = json.loads(out.strip().splitlines()[-1])
    record = metrics["epochs"][0]
    losses = [metrics["dev_rough_loss"], metrics["dev_precise_loss"], record["train_rough_loss"],
              record["train_precise_loss"]]
    model_config = load_config(os.path.join(SYNTH_DIR, "model.json"), AdaptiveScalingConfig)
    blocks = 2 * sum(n for _, n in model_config.backbone_spec())
    stall = record["data_stall_s"]
    stall_text = "no prefetcher" if stall is None else (
        f"{stall:.3f} s of the epoch's {record['wall_s']:.2f} s wall ({100 * stall / record['wall_s']:.1f} %)")
    print(f"mesh CLI: torchrun --standalone --nproc_per_node=1 -m adascale_torch train --mesh on "
          f"examples/synthetic_training (epoch config {json.dumps(epoch)}): exit 0 in {seconds:.2f} s; losses "
          f"(dev rough, dev precise, train rough, train precise) {losses}; step ms "
          + ", ".join(f"{v:.1f}" for v in record["step_ms"])
          + f"; data stall {stall_text}; block launches a step {record['step_launches']}, a dev batch "
          f"{record['dev_launches']}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"mesh CLI: a loss is not finite: {losses}")
    if record["step_launches"] + record["dev_launches"] != [blocks] * (MESH_CLI_EPOCH["train_num_batches"]
                                                                       + MESH_CLI_EPOCH["dev_num_batches"]):
        raise AssertionError(f"mesh CLI: launches {record['step_launches']} {record['dev_launches']} != {blocks}")
    return {"launches": {"convnext_block": sum(record["step_launches"]) + sum(record["dev_launches"])},
            "seconds": seconds}


RENDER_PAGES = 8  # pages a backend, timed after one warm page


def render_page_ms() -> dict:
    """Phase mesh: host ms a page of examples/synthetic_training's page
    config with the "python" render backend (the CLI run's) and the native
    one, on the same seeds, one process."""
    import numpy as np

    from adascale_torch.data.synth import SynthPageConfig, generate_page

    with open(os.path.join(SYNTH_DIR, "steps.json")) as fin:
        page = json.load(fin)["page"]
    out = {}
    for backend in ("python", "native"):
        config = SynthPageConfig(**dict(page, render_backend=backend))
        generate_page(config, np.random.default_rng(0))
        t = time.perf_counter()
        for seed in range(1, RENDER_PAGES + 1):
            generate_page(config, np.random.default_rng(seed))
        out[backend] = 1e3 * (time.perf_counter() - t) / RENDER_PAGES
    print(f"render backends on examples/synthetic_training's {page['page_height']}x{page['page_width']} pages "
          f"(host, one process, {RENDER_PAGES} pages): python {out['python']:.1f} ms a page, native "
          f"{out['native']:.1f} ms a page ({smi_line()})", flush=True)
    return out


def check_mesh(params, device) -> dict:
    """Phase mesh (module docstring): a world-size-1 NCCL mesh in this
    process (``parallel.create_mesh``) for the step at f32 and bf16 and for
    detect_many, ended after; then the torchrun CLI run."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from adascale_torch.parallel import create_mesh, mesh_size

    phase_t = time.perf_counter()
    if dist.is_initialized():
        raise AssertionError("phase mesh: a process group exists already")
    mesh = create_mesh("cuda")
    paths, ms = {}, {}
    out_dir = tempfile.mkdtemp(prefix=".mesh-", dir=ROOT)
    cli = None
    try:
        if mesh_size(mesh) != 1 or dist.get_backend() != "nccl":
            raise AssertionError(f"phase mesh: {mesh_size(mesh)} ranks over {dist.get_backend()}")
        # The CLI run (mostly host work: its start-up, then pages drawn in
        # numpy) beside the steps and detect_many, whose times share the
        # machine with it.
        cli = mesh_cli_start(out_dir)
        for dtype, suffix in (("float32", ""), ("bfloat16", "_bf16")):
            stepped = mesh_step_checked(params, device, mesh, dtype)
            paths["mesh_train_step" + suffix], ms["train_step" + suffix] = stepped["launches"], stepped["ms"]
        many = mesh_detect_many_checked(params, mesh)
        paths["mesh_detect_many"], ms["detect_many"] = many["launches"], {"mesh": many["ms"], "plain": many["plain_ms"]}
        dist.destroy_process_group()
        cli = mesh_cli_finish(*cli)
        render_ms = render_page_ms()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if isinstance(cli, tuple) and cli[0].poll() is None:
            cli[0].kill()
            cli[0].communicate()
        shutil.rmtree(out_dir, ignore_errors=True)
    paths["mesh_cli_train"] = cli["launches"]
    print(f"phase mesh: {time.perf_counter() - phase_t:.2f} s", flush=True)
    return {"paths": paths, "ms": ms, "cli_s": cli["seconds"], "render_ms": render_ms}


# Phase tools: the demo CLI on page_0 (fused f32) and the profilers at a
# small batch and a few iterations, each in f32 and bf16.
TOOLS_SERVE_ARGS = ["--batch", "2", "--hw", "768", "--pallas"]
TOOLS_SWEEP_ARGS = ["--batch", "2", "--hw", "768"]
TOOLS_TRAIN_ARGS = ["--batch", "2"]  # the flagship's 512x512 rough and 320x320 precise crops
TOOLS_ITERS = "3"
TOOLS_FORWARD = {"resolution": 640, "batch": 1, "iters": 5}
# The kernels each tool's timed run must launch (by counted()'s names).
TOOLS_PATH_KERNELS = {
    "tools_demo_cli": list(KERNEL_NAMES),
    "tools_serve_profile": ["convnext_block"],
    "tools_serve_profile_bf16": ["convnext_block_bf16"],
    "tools_kernel_sweep": ["convnext_block", "convnext_block_tf32", "convnext_block_bf16", "fpn_neck_l0", "fpn_heads",
                           "precise_heads"],
    "tools_kernel_sweep_bf16": ["convnext_block", "convnext_block_tf32"] + [f"{k}_bf16" for k in KERNEL_NAMES],
    "tools_train_profile": ["convnext_block"],
    "tools_train_profile_bf16": ["convnext_block_bf16"],
    "tools_profile_forward": ["convnext_block"],
}


def check_demo_cli(params, image, ref, fused_result, out_dir: str, worst: dict) -> dict:
    """``python -m adascale_torch demo`` (run in this process by ``runpy``)
    on page_0 with the FPN flagship's .npz and model.json, fused, every
    kernel launch held against its plain twin: the ten PNGs read back equal
    to ``inference.demo.visualisations`` of its result, its remapped
    polygons equal to phase 5's fused detect(). Returns its launches."""
    import runpy
    import sys

    import numpy as np

    from adascale_torch.inference import demo
    from adascale_torch.utils.png import read_image

    with open(os.path.join(ROOT, "examples/flagship_training/model.json")) as f:
        model = json.load(f)
    config = os.path.join(out_dir, "infer.json")
    with open(config, "w") as f:
        json.dump({"checkpoint": WEIGHTS, "model": model, "use_pallas_backbone": True,
                   "use_pallas_neck_heads": True}, f)
    results, original, argv = [], demo.infer, sys.argv
    demo.infer = lambda *a, **k: results.append(original(*a, **k)) or results[-1]
    sys.argv = ["adascale_torch", "demo", "--config", config, "--image", os.path.join(ROOT, str(ref["page"])),
                "--output", os.path.join(out_dir, "demo")]
    t = time.perf_counter()
    try:
        with held_against_plain(worst):
            _, launches = counted(lambda: runpy.run_module("adascale_torch", run_name="__main__"))
    finally:
        demo.infer, sys.argv = original, argv
    seconds = time.perf_counter() - t
    result = results[0]
    want = demo.visualisations(engine_for(params, use_pallas_neck_heads=True), image, result)
    for stem in demo.STEMS:
        got = read_image(os.path.join(out_dir, "demo", f"{stem}.png"))
        if got.shape != want[stem].shape or not np.array_equal(got, want[stem]):
            raise AssertionError(f"demo {stem}.png: {got.shape} differs from its visualisation {want[stem].shape}")
    ours, theirs = result["char_polygons"], fused_result["char_polygons"]
    if len(ours) != len(theirs) or not all(np.array_equal(a.points, b.points) for a, b in zip(ours, theirs)):
        raise AssertionError(f"demo: {len(ours)} remapped polygons differ from the fused detect()'s {len(theirs)}")
    print(
        f"demo CLI: {len(demo.STEMS)} PNGs read back equal to their visualisations, {len(ours)} remapped polygons "
        f"equal to the fused detect()'s, {seconds:.2f} s (the twins' checks inside), launches {launches}",
        flush=True,
    )
    return launches


@contextlib.contextmanager
def unit_block_scale():
    """Within: the profilers' models (``tools.train_profile.build``) come
    with every ConvNeXt block's layer scale at 1. At the init's 1e-6 a
    block returns its input plus 1e-6 of the kernel's work, and holding
    that output against the twin's would measure the input."""
    import torch

    from adascale_torch.tools import train_profile

    build = train_profile.build

    def unit(*args, **kwargs):
        model, specs = build(*args, **kwargs)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("block_scale"):
                    p.fill_(1.0)
        return model, specs

    train_profile.build = unit
    try:
        yield
    finally:
        train_profile.build = build


def check_tools(params, image, ref, device, fused_result=None) -> dict:
    """Phase tools (module docstring). Each profiler runs twice a dtype:
    once silent at one timed call, every kernel launch held against its
    plain twin, then timed and printed (rows with the card's name and power
    limit; serve_profile raises on a row under its bound), its launches
    counted. Returns the launches by path."""
    import contextlib
    import io
    import shutil
    import tempfile

    from adascale_torch.tools import inspect as tool_inspect
    from adascale_torch.tools import kernel_sweep, serve_profile, train_profile

    phase_t = time.perf_counter()
    paths, worst = {}, {}
    out_dir = tempfile.mkdtemp(prefix=".tools-", dir=ROOT)
    try:
        if fused_result is None:
            fused_result = engine_for(params, use_pallas_neck_heads=True).detect(image)
        paths["tools_demo_cli"] = check_demo_cli(params, image, ref, fused_result, out_dir, worst)

        for main, args in ((serve_profile, TOOLS_SERVE_ARGS), (kernel_sweep, TOOLS_SWEEP_ARGS),
                           (train_profile, TOOLS_TRAIN_ARGS)):
            tool = main.__name__.rsplit(".", 1)[1]
            for dtype, suffix in (("f32", ""), ("bf16", "_bf16")):
                argv = args + ["--dtype", dtype]
                t = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()), unit_block_scale(), held_against_plain(worst):
                    main.main(argv + ["--iters", "1"])
                held_s = time.perf_counter() - t
                stamp(f"tools: {tool} {' '.join(argv)}")
                t = time.perf_counter()
                _, paths[f"tools_{tool}{suffix}"] = counted(lambda: main.main(argv + ["--iters", TOOLS_ITERS]))
                print(f"{tool} {dtype}: {time.perf_counter() - t:.2f} s timed, {held_s:.2f} s held against the "
                      f"twins; launches {paths[f'tools_{tool}{suffix}']}", flush=True)

        traces = os.path.join(out_dir, "traces")
        forward, paths["tools_profile_forward"] = counted(
            lambda: tool_inspect.profile_forward(trace_dir=traces, device="cuda", **TOOLS_FORWARD)
        )
        kernels = {}
        for name in forward:
            with open(os.path.join(traces, f"{name}.json")) as f:
                events = json.load(f)["traceEvents"]
            kernels[name] = sum(1 for e in events if e.get("cat") == "kernel")
            if not kernels[name]:
                raise AssertionError(f"profile_forward's {name} trace holds no device kernel")
        print(
            "profile_forward (tiny/FPN, random init, "
            + ", ".join(f"{k}={v}" for k, v in TOOLS_FORWARD.items())
            + "): " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in forward.items())
            + f"; trace kernels {kernels} [{smi_line()}]",
            flush=True,
        )
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(
        "tools: kernel launches against their plain twins: "
        + "; ".join(f"{k} {v['launches']} at {len(v['shapes'])} shapes worst rel {v['rel']:.3e}"
                    for k, v in worst.items()),
        flush=True,
    )
    for path, launches in paths.items():
        missing = [k for k in TOOLS_PATH_KERNELS[path] if not launches.get(k)]
        if missing:
            raise AssertionError(f"path {path}: kernels {missing} were not launched ({launches})")
    print(f"phase tools: {time.perf_counter() - phase_t:.2f} s", flush=True)
    return paths


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
    from adascale_torch.utils.precision import pin_full_f32

    pin_full_f32()
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
    # page_0's detect() at "highest" by configuration, where a phase ran it
    # (phase tf32 holds "default" against it): (engine, result), bf16 the
    # result alone.
    highest = {}

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
        highest["fpn_module"] = (engine, result)
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
    fused_result = None
    if "5" in phases:
        stamp("phase 5: detect() with use_pallas_neck_heads=True")
        from adascale_torch.kernels import packing

        result, by_path["detect_fused"] = fused_detect_checked(fused, image, ref, blocks_per_pass)
        highest["fpn_fused"] = (fused, result)
        fused_result = result
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
        stamp("phase 8a, bf16: the trainable bf16 block against autograd of its bf16 plain twin")
        rows["convnext_block_trainable_bf16"] = check_trainable_block_bf16(gen, device)

    if "8b" in phases:
        stamp("phase 8b: the flagship's two-task step against the JAX reference")
        step_f32 = check_train_reference(params, device)
        stamp("phase 8b, bf16: the flagship's two-task step at bf16 against the JAX bf16 reference")
        check_train_reference(params, device, "bfloat16", step_f32)

    if "8c" in phases:
        for dtype, suffix in (("float32", ""), ("bfloat16", "_bf16")):
            stamp(f"phase 8c: train steps with the flagship ({dtype})")
            phase_t = time.perf_counter()
            trained = train_steps(params, device, dtype)
            kernel = "convnext_block" + suffix
            by_path["train_step" + suffix] = {kernel: trained["launches"]}
            rows.setdefault("convnext_block_trainable" + suffix, {}).update(
                # Device ms of one traced B = 6 step's 36 block forwards
                # (kernel; plain version in the same place) and of their
                # backward.
                launches=trained["launches"],
                ms=trained["split"]["blocks_forward_kernel"],
                plain_ms=trained["plain_forward_ms"],
                backward_ms=trained["split"]["blocks_backward_recompute"],
            )
            print(f"phase 8c ({dtype}): {time.perf_counter() - phase_t:.2f} s", flush=True)

    if "9" in phases:
        stamp("phase 9: detect() with the tiny/UPerNeXt flagship (fused configuration)")
        upernext = check_upernext(image)
        by_path["upernext_detect"] = upernext["launches"]
        highest["upernext_fused"] = (upernext["engine"], upernext["result"])

    if "10" in phases:
        stamp("phase 10: tiled detect() with band recall on a 1024x1536 page")
        by_path["tiled_band_detect"] = check_tiled_band(params)["launches"]

    if "11" in phases:
        stamp("phase 11: detect_many over three shift pages and a blank page")
        by_path["detect_many"] = check_detect_many(params)["launches"]

    if "12" in phases:
        stamp("phase 12: the fused wrappers refuse a gradient on the card")
        check_grad_refusal(gen, device)

    if "export" in phases:
        stamp("phase export: torch.export of the flagship, loaded back, and the detect CLI")
        phase_t = time.perf_counter()
        rows["convnext_block_op"] = check_block_op(gen, device)
        exported = check_export(params, image, ref, device)
        by_path["exported_program"] = {"convnext_block": exported["program_launches"]}
        by_path["exported_program_upernext"] = {"convnext_block": exported["upernext"]["program_launches"]}
        by_path["detect_cli"] = exported["cli_launches"]
        print(f"phase export: {time.perf_counter() - phase_t:.2f} s", flush=True)

    if "loop" in phases:
        stamp("phase loop: the training loop with the flagships' configs")
        looped = check_loop(image, device)
        by_path.update(looped["paths"])
        by_path["train_loop_detect_cli"] = looped["cli_launches"]

    if "mesh" in phases:
        stamp("phase mesh: the step, detect_many and the CLI on a mesh")
        by_path.update(check_mesh(params, device)["paths"])

    if "bf16" in phases:
        stamp("phase bf16: bf16 serving (compute_dtype='bfloat16')")
        bf16_rows, bf16_paths, highest["bf16_fused"] = check_bf16(params, image, gen, device)
        rows.update({k: v for k, v in bf16_rows.items() if k.endswith("_bf16")})
        print("bf16 forwards and drift: " + json.dumps(
            {k: v for k, v in bf16_rows.items() if not k.endswith("_bf16")}), flush=True)
        by_path.update(bf16_paths)

    if "widths" in phases:
        stamp("phase widths: the neck and heads kernels at the base and large widths")
        phase_t = time.perf_counter()
        wide_rows, wide_paths = check_widths(gen, device)
        rows.update(wide_rows)
        by_path.update(wide_paths)
        print(f"phase widths: {time.perf_counter() - phase_t:.2f} s", flush=True)

    if "tf32" in phases:
        stamp("phase tf32: matmul_precision \"default\" / \"high\" (single-pass TF32)")
        phase_t = time.perf_counter()
        rows.update(check_tf32_kernels(gen, device))
        stamp("tf32: the TF32 entries' batch invariance at \"default\"")
        invariance_t = time.perf_counter()
        check_tf32_invariance(gen, device)
        print(f"tf32 batch invariance: {time.perf_counter() - invariance_t:.2f} s", flush=True)
        stamp("tf32: detect() at \"default\" and \"high\" against \"highest\"")
        tf32_paths, tf32_numbers, fused_default = check_tf32_detects(image, highest)
        by_path.update(tf32_paths)
        stamp("tf32: the chunked, tiled and batched fused paths at \"default\"")
        by_path.update(check_tf32_paths(fused_default))
        stamp("tf32: eval_checkpoint.evaluate on the flagship")
        tf32_numbers["eval_checkpoint"] = check_tf32_eval()
        print("tf32 numbers: " + json.dumps(tf32_numbers), flush=True)
        print(f"phase tf32: {time.perf_counter() - phase_t:.2f} s", flush=True)

    if "tools" in phases:
        stamp("phase tools: the demo CLI and the profiling tools")
        by_path.update(check_tools(params, image, ref, device, fused_result))

    # Every kernel a path runs was launched in that path's counted run.
    bf16_names = [f"{k}_bf16" for k in KERNEL_NAMES]
    path_kernels = {
        "detect": ["convnext_block"], "upernext_detect": ["convnext_block"],
        "exported_program": ["convnext_block"], "exported_program_upernext": ["convnext_block"],
        "detect_cli": ["convnext_block"],
        "train_step": ["convnext_block"], "train_step_bf16": ["convnext_block_bf16"],
        "train_loop_steps": ["convnext_block"], "train_loop_dev": ["convnext_block"],
        "train_loop_steps_bf16": ["convnext_block_bf16"], "train_loop_dev_bf16": ["convnext_block_bf16"],
        "train_loop_upernext_bf16": ["convnext_block_bf16"], "train_loop_upernext_dev_bf16": ["convnext_block_bf16"],
        "train_loop_detect_cli": ["convnext_block"],
        "mesh_train_step": ["convnext_block"], "mesh_train_step_bf16": ["convnext_block_bf16"],
        "mesh_cli_train": ["convnext_block"],
        "detect_bf16_fpn_module": ["convnext_block_bf16"],
        "detect_bf16_upernext_fused": ["convnext_block_bf16"],
        "detect_bf16_fpn_fused": bf16_names, "detect_many_bf16": bf16_names,
        "detect_base_random_bfloat16": bf16_names, "detect_base_random_default": [f"{k}_tf32" for k in KERNEL_NAMES],
        # A random large model's precise pass need not find regions.
        "detect_large_random_bfloat16": bf16_names[:3],
        "detect_tf32_fpn_module": ["convnext_block_tf32"], "detect_tf32_upernext_fused": ["convnext_block_tf32"],
        "detect_tf32_fpn_fused": [f"{k}_tf32" for k in KERNEL_NAMES], "detect_tf32_bf16_fused": bf16_names,
        **dict.fromkeys(("detect_tf32_fused_chunks", "tiled_tf32_band_detect", "detect_many_tf32"),
                        [f"{k}_tf32" for k in KERNEL_NAMES]),
        **TOOLS_PATH_KERNELS,
    }
    for path, launches in by_path.items():
        missing = [k for k in path_kernels.get(path, KERNEL_NAMES) if not launches.get(k)]
        if missing:
            raise AssertionError(f"path {path}: kernels {missing} were not launched ({launches})")
    print("launches by path: " + json.dumps(by_path), flush=True)
    print("torch.profiler empty traces taken again, by phase: " + json.dumps(TRACE_RETRIES), flush=True)

    stamp("done")
    print(smi_line(), flush=True)
    sources = {
        "convnext_block": ("convnext_block.cu", "adascale/ops/pallas/convnext_block.py:290", "detect"),
        "fpn_neck_l0": ("fpn_neck_l0.cu", "adascale/ops/pallas/fpn_neck.py:185", "detect_fused"),
        "fpn_heads": ("fpn_heads.cu", "adascale/ops/pallas/fpn_heads.py:200", "detect_fused"),
        "precise_heads": ("precise_heads.cu", "adascale/ops/pallas/precise_heads.py:144", "detect_fused"),
        "convnext_block_trainable": ("convnext_block.cu", "adascale/ops/pallas/convnext_block.py:340", "train_step"),
        # The trainable bf16 block (module mode), on the bf16 train step.
        "convnext_block_trainable_bf16": ("block_bf16.cuh", "adascale/ops/pallas/convnext_block.py:340",
                                          "train_step_bf16"),
        # The block's registered operator, on the programs of phase export.
        "convnext_block_op": ("convnext_block.cu", "adascale/ops/pallas/convnext_block.py:290", "exported_program"),
        # The bf16 kernels, on the fused bf16 detect() (Pallas-mode blocks).
        "convnext_block_bf16": ("block_bf16.cuh", "adascale/ops/pallas/convnext_block.py:290", "detect_bf16_fpn_fused"),
        "fpn_neck_l0_bf16": ("fpn_neck_l0.cu", "adascale/ops/pallas/fpn_neck.py:185", "detect_bf16_fpn_fused"),
        "fpn_heads_bf16": ("fpn_head.cuh", "adascale/ops/pallas/fpn_heads.py:200", "detect_bf16_fpn_fused"),
        "precise_heads_bf16": ("fpn_head.cuh", "adascale/ops/pallas/precise_heads.py:144", "detect_bf16_fpn_fused"),
        # The single-pass TF32 entries (matmul_precision "default" / "high"),
        # on the fused f32 detect() at "default".
        "convnext_block_tf32": ("convnext_block.cu", "adascale/ops/pallas/convnext_block.py:290", "detect_tf32_fpn_fused"),
        "fpn_neck_l0_tf32": ("fpn_neck_l0.cu", "adascale/ops/pallas/fpn_neck.py:185", "detect_tf32_fpn_fused"),
        "fpn_heads_tf32": ("fpn_heads.cu", "adascale/ops/pallas/fpn_heads.py:200", "detect_tf32_fpn_fused"),
        "precise_heads_tf32": ("precise_heads.cu", "adascale/ops/pallas/precise_heads.py:144", "detect_tf32_fpn_fused"),
        # The neck and heads wider than one tile (the base and large
        # backbones': the heads' and the neck step1's feature slices on one
        # thread-block cluster a pixel tile, the neck's step2 one CTA a tile
        # at N = Co), on the fused detect() of a random-init base model in
        # each precision; the numbers at the base widths at the page shapes
        # (phase widths; the neck at 240x192).
        **{f"{k}_wide{s}": (source, replaces, f"detect_base_random_{path}")
           for k, source, replaces in (("fpn_neck_l0", "fpn_neck_l0.cu", "adascale/ops/pallas/fpn_neck.py:185"),
                                       ("fpn_heads", "fpn_head.cuh", "adascale/ops/pallas/fpn_heads.py:200"),
                                       ("precise_heads", "fpn_head.cuh", "adascale/ops/pallas/precise_heads.py:144"))
           for s, path in (("", "float32"), ("_tf32", "default"), ("_bf16", "bfloat16"))},
    }
    kernels = []
    for kernel, (source, replaces, main_path) in sources.items():
        kernel_name = {"convnext_block_trainable": "convnext_block", "convnext_block_op": "convnext_block",
                       "convnext_block_trainable_bf16": "convnext_block_bf16"}.get(kernel, kernel.replace("_wide", ""))
        entry = {
            "name": kernel,
            "route": "cuda",
            "source": f"adascale_torch/kernels/csrc/{source}",
            "replaces": replaces,
            # The count of the main path's run; the other paths' beside it.
            "launches": by_path.get(main_path, {}).get(kernel_name),
            "launches_by_path": {
                path: c[kernel_name] for path, c in by_path.items()
                if kernel_name in c and (path in TRAIN_PATHS) == (main_path in TRAIN_PATHS)
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
