"""Detection-quality evaluation of a trained checkpoint on held-out pages.

Counterpart of ``adascale/tools/eval_checkpoint.py``. Drives the full
two-stage pipeline (rough -> flatten/rescale/stack -> precise -> polygon
build -> remap -> NMS) over freshly generated synthetic pages whose random
stream is disjoint from the training and dev streams, and reports
char-level precision/recall/F1 (polygon IoU matching), the rough mask's IoU
and the height map's calibration, with the JAX tool's flags and JSON keys.
bf16 runs at ``matmul_precision="default"``, f32 at ``"highest"``, as there.

It reads the port's own checkpoints (``training/checkpoint.py``'s
``state_<epoch>[_not_best]`` files, through
``training/loop.py::export_inference_artifact``, which writes
``params.npz``) or a committed flat ``.npz`` (``tools/export_params.py``).
Under ``--shift`` the real-font fixture pages come from
``tests/fixtures/shift_pages/``.

Usage:
  python -m adascale_torch.tools.eval_checkpoint --run <train_output_dir> \\
      --model-config model.json [--steps steps.json] [--num-pages 20] \\
      [--compute-dtype bfloat16] [--pallas] [--shift] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import tempfile
from typing import Optional

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "shift_pages")


def find_latest_checkpoint(run_dir: str) -> str:
    """The highest-epoch checkpoint under ``run_dir`` (a best one preferred
    over a ``_not_best`` one of the same epoch)."""
    best = (-1, 1, None)  # (epoch, not_best rank, path): the lower rank wins
    for name in os.listdir(run_dir):
        m = re.fullmatch(r"state_(\d+)(_not_best)?", name)
        if not m:
            continue
        epoch, rank = int(m.group(1)), 1 if m.group(2) else 0
        if (epoch, -rank) > (best[0], -best[1]):
            best = (epoch, rank, os.path.join(run_dir, name))
    if best[2] is None:
        raise FileNotFoundError(f"no state_<N> checkpoints under {run_dir}")
    return best[2]


def shift_page_config(base):
    """Generator knobs pushed outside the training ranges (a
    distribution-shift probe; the trained ranges are the flagship's
    steps.json): char heights 8-110 against 14-64, rotation to 40 degrees
    against 25, perspective 2.5x stronger and more frequent, double the
    noise, denser lines and tables, lower ink contrast."""
    return dataclasses.replace(
        base,
        char_height_min=8,
        char_height_max=110,
        num_lines_min=14,
        num_lines_max=30,
        line_rotate_prob=0.6,
        line_rotate_max_deg=40.0,
        perspective_prob=0.7,
        perspective_max_ratio=0.05,
        noise_sigma=16.0,
        ink_gray_max=130,
        background_gray_min=160,
        ruled_line_prob=0.5,
        table_prob=0.4,
        vignette_prob=0.7,
    )


def load_engine(
    checkpoint_path: str,
    model_config_json: str,
    compute_dtype: str = "float32",
    pallas: bool = False,
    device: str = "cuda",
    prefix: str = "adascale_eval_",
):
    """An engine on ``checkpoint_path`` (a ``.npz``, or a checkpoint of the
    port exported by ``export_inference_artifact`` into a temporary folder),
    at the JAX tools' precision for ``compute_dtype`` ("highest" for f32,
    "default" for bf16); ``pallas`` sets ``use_pallas_backbone`` and
    ``use_pallas_neck_heads``."""
    from ..inference.engine import AdaptiveScalingInference, AdaptiveScalingInferenceConfig
    from ..models.adaptive_scaling import AdaptiveScalingConfig
    from ..training.loop import export_inference_artifact
    from ..utils.config import load_config

    if checkpoint_path.endswith(".npz"):
        params_path = checkpoint_path
    else:
        artifact = export_inference_artifact(checkpoint_path, tempfile.mkdtemp(prefix=prefix), model_config_json)
        params_path = os.path.join(artifact, "params.npz")
    return AdaptiveScalingInference(
        AdaptiveScalingInferenceConfig(
            checkpoint=params_path,
            model=load_config(model_config_json, AdaptiveScalingConfig),
            compute_dtype=compute_dtype,
            matmul_precision="highest" if compute_dtype == "float32" else "default",
            use_pallas_backbone=pallas,
            use_pallas_neck_heads=pallas,
            device=device,
        )
    )


def prf(tp: int, fp: int, fn: int):
    """Precision, recall and F1 of summed counts."""
    p = tp / max(tp + fp, 1)
    r = tp / max(tp + fn, 1)
    return p, r, 2 * p * r / max(p + r, 1e-9)


def evaluate(
    checkpoint_path: str,
    model_config_json: str,
    steps_json: Optional[str] = None,
    num_pages: int = 20,
    heldout_seed: int = 9999,
    compute_dtype: str = "float32",
    page_size: int = 768,
    direct: bool = True,
    shift: bool = False,
    fixtures_dir: Optional[str] = None,
    pallas: bool = False,
    device: str = "cuda",
) -> dict:
    """The JAX tool's ``evaluate``: the same pages (``steps_json``'s page
    spec, else ``page_size`` square), seeds, counts and keys."""
    import numpy as np

    from ..data.dataset import SynthPipelineConfig
    from ..data.synth import CharInstance, SynthPageConfig, generate_page
    from ..inference.eval import evaluate_char_detection, evaluate_rough_mask
    from ..utils.config import load_config

    if steps_json is not None:
        page_config = load_config(steps_json, SynthPipelineConfig).page
    else:
        page_config = SynthPageConfig(page_height=page_size, page_width=page_size)
    if shift:
        page_config = shift_page_config(page_config)
        heldout_seed = heldout_seed + 777000  # disjoint from the in-distribution stream
    engine = load_engine(checkpoint_path, model_config_json, compute_dtype, pallas, device)

    tp = fp = fn = 0
    dtp = dfp = dfn = 0
    mious, herrs = [], []
    for i in range(num_pages):
        page = generate_page(page_config, np.random.default_rng([heldout_seed, i]))
        if not page.chars:
            continue
        gt_corners = [c.corners for c in page.chars]
        if direct:
            # The precise pass straight on the page (no flatten, stack or
            # remap): model quality apart from the host geometry chain.
            pr = engine.precise_infer(page.image)
            ys, xs = np.nonzero(pr.precise_peak_mask)
            polys = [engine.precise_build_polygon(pr, int(y), int(x)) for y, x in zip(ys, xs)]
            dm = evaluate_char_detection(polys, gt_corners, iou_thr=0.5)
            dtp += dm.num_matched
            dfp += dm.num_pred - dm.num_matched
            dfn += dm.num_gt - dm.num_matched
        result = engine.detect(page.image)
        m = evaluate_char_detection(result["char_polygons"], gt_corners, iou_thr=0.5)
        tp += m.num_matched
        fp += m.num_pred - m.num_matched
        fn += m.num_gt - m.num_matched
        rough = result["rough"]
        mious.append(
            evaluate_rough_mask(rough.rough_char_mask, page.chars, page.image.shape[:2], rough.resized_shape)
        )
        hm = rough.rough_char_height_score_map
        if np.any(hm > 0):
            # Height calibration in the resized frame the head predicts in.
            # The prediction's median is over pixels, so each GT char is
            # weighted by its area (height x width).
            scale = rough.resized_image_shape[0] / page.image.shape[0]
            heights = np.asarray([c.height for c in page.chars])
            widths = np.asarray([np.linalg.norm(c.corners[1] - c.corners[0]) for c in page.chars])
            order = np.argsort(heights)
            cum = np.cumsum((heights * widths)[order])
            gt_med = float(heights[order][np.searchsorted(cum, cum[-1] / 2)]) * scale
            herrs.append(abs(float(np.median(hm[hm > 0])) - gt_med) / max(gt_med, 1e-6))

    fix_metrics = None
    if fixtures_dir and os.path.isdir(fixtures_dir):
        # Real-font fixture pages (tests/fixtures/shift_pages): glyphs,
        # scan skew and JPEG artifacts that training never produced.
        ftp = ffp = ffn = 0
        fmious = []
        files = sorted(f for f in os.listdir(fixtures_dir) if f.endswith(".npz"))
        for name in files:
            data = np.load(os.path.join(fixtures_dir, name))
            image, quads = data["image"], data["corners"]
            result = engine.detect(image)
            m = evaluate_char_detection(result["char_polygons"], list(quads), iou_thr=0.5)
            ftp += m.num_matched
            ffp += m.num_pred - m.num_matched
            ffn += m.num_gt - m.num_matched
            chars = [CharInstance(corners=q, height=float(h)) for q, h in zip(quads, data["heights"])]
            rough = result["rough"]
            fmious.append(evaluate_rough_mask(rough.rough_char_mask, chars, image.shape[:2], rough.resized_shape))
        if files:
            fp_, fr_, ff1_ = prf(ftp, ffp, ffn)
            fix_metrics = {
                "font_fixture_pages": len(files),
                "font_fixture_precision": round(fp_, 4),
                "font_fixture_recall": round(fr_, 4),
                "font_fixture_f1": round(ff1_, 4),
                "font_fixture_rough_miou": round(float(np.mean(fmious)), 4),
            }

    precision, recall, f1 = prf(tp, fp, fn)
    out = {
        "checkpoint": checkpoint_path,
        "num_pages": num_pages,
        "char_precision": round(precision, 4),
        "char_recall": round(recall, 4),
        "char_f1": round(f1, 4),
        "rough_mask_miou": round(float(np.mean(mious)), 4) if mious else None,
        "height_median_rel_err": round(float(np.mean(herrs)), 4) if herrs else None,
    }
    if shift:
        out["shift"] = True
    if direct:
        dp, dr, df1 = prf(dtp, dfp, dfn)
        out["direct_char_precision"] = round(dp, 4)
        out["direct_char_recall"] = round(dr, 4)
        out["direct_char_f1"] = round(df1, 4)
    if fix_metrics:
        out.update(fix_metrics)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--run", help="training output folder (picks the latest state_<N>)")
    parser.add_argument("--checkpoint", help="an explicit checkpoint file of the port or a .npz")
    parser.add_argument("--model-config", required=True)
    parser.add_argument("--steps", help="synth pipeline steps.json for the page spec")
    parser.add_argument("--num-pages", type=int, default=20)
    parser.add_argument("--seed", type=int, default=9999)
    parser.add_argument("--compute-dtype", default="float32")
    parser.add_argument(
        "--no-direct", action="store_true",
        help="skip the direct precise-pass comparison (chain metrics only)",
    )
    parser.add_argument(
        "--shift", action="store_true",
        help="distribution-shift mode: generator knobs pushed outside the training ranges, plus "
        "the real-font fixture pages",
    )
    parser.add_argument(
        "--pallas", action="store_true",
        help="serve through the fused path (the backbone, FPN neck and heads kernels)",
    )
    parser.add_argument(
        "--fixtures", default=None,
        help="folder of .npz fixture pages (default under --shift: tests/fixtures/shift_pages)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    if args.run is None and args.checkpoint is None:
        parser.error("give --run or --checkpoint")

    fixtures = args.fixtures
    if fixtures is None and args.shift and os.path.isdir(FIXTURES):
        fixtures = FIXTURES
    result = evaluate(
        args.checkpoint or find_latest_checkpoint(args.run),
        args.model_config,
        steps_json=args.steps,
        num_pages=args.num_pages,
        heldout_seed=args.seed,
        compute_dtype=args.compute_dtype,
        direct=not args.no_direct,
        shift=args.shift,
        fixtures_dir=fixtures,
        pallas=args.pallas,
        device=args.device,
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
