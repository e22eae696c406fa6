"""Tiled-mode recall on high-resolution small-print pages.

Counterpart of ``adascale/tools/tiled_recall.py``. The reference pipeline
downsamples every page to short side 720 before the rough pass, so a 2048 px
scan with 8-14 px characters lands at 3-5 px a character, below the
detector's resolving power. Tiled mode (``inference/tiled.py``) runs the
rough pass at full resolution over overlapping tiles. This tool measures
what that buys: char precision/recall/F1 of ``detect()`` (the short-side-720
resize) against ``detect(tiled=True)`` on the same generated pages, with the
JAX tool's page config, seeds and JSON keys; bf16 at
``matmul_precision="default"``, f32 at ``"highest"``, as there.

Usage:
  python -m adascale_torch.tools.tiled_recall --checkpoint <state_file or .npz> \\
      --model-config model.json [--num-pages 8] [--page-size 2048] \\
      [--char-min 8 --char-max 14] [--compute-dtype bfloat16] [--device cpu]

Prints one JSON line with both settings' metrics.
"""
from __future__ import annotations

import argparse
import json


def evaluate_tiled_recall(
    checkpoint_path: str,
    model_config_json: str,
    num_pages: int = 8,
    page_size: int = 2048,
    char_min: int = 8,
    char_max: int = 14,
    seed: int = 4242,
    compute_dtype: str = "float32",
    device: str = "cuda",
) -> dict:
    """The JAX tool's ``evaluate_tiled_recall``; ``checkpoint_path`` a
    checkpoint file of the port or a ``.npz`` (``eval_checkpoint.load_engine``)."""
    import numpy as np

    from ..data.synth import SynthPageConfig, generate_page
    from ..inference.eval import evaluate_char_detection
    from .eval_checkpoint import load_engine, prf

    # Dense small print filling a large scan: many lines, tiny glyphs.
    page_config = SynthPageConfig(
        page_height=page_size,
        page_width=page_size,
        num_lines_min=int(page_size * 0.55 / (char_max * 1.4)),
        num_lines_max=int(page_size * 0.8 / (char_max * 1.4)),
        char_height_min=char_min,
        char_height_max=char_max,
    )
    engine = load_engine(checkpoint_path, model_config_json, compute_dtype, device=device,
                         prefix="adascale_tiled_")

    counts = {False: [0, 0, 0], True: [0, 0, 0]}  # tiled -> [tp, fp, fn]
    total_chars = 0
    for i in range(num_pages):
        page = generate_page(page_config, np.random.default_rng([seed, i]))
        if not page.chars:
            continue
        total_chars += len(page.chars)
        gt = [c.corners for c in page.chars]
        for tiled in (False, True):
            m = evaluate_char_detection(engine.detect(page.image, tiled=tiled)["char_polygons"], gt, iou_thr=0.5)
            counts[tiled][0] += m.num_matched
            counts[tiled][1] += m.num_pred - m.num_matched
            counts[tiled][2] += m.num_gt - m.num_matched

    def metrics(tp, fp, fn):
        p, r, f1 = prf(tp, fp, fn)
        return {"precision": round(p, 4), "recall": round(r, 4), "f1": round(f1, 4)}

    return {
        "checkpoint": checkpoint_path,
        "num_pages": num_pages,
        "page_size": page_size,
        "char_height_range": [char_min, char_max],
        "total_gt_chars": total_chars,
        "resized_720": metrics(*counts[False]),
        "tiled_full_res": metrics(*counts[True]),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--model-config", required=True)
    parser.add_argument("--num-pages", type=int, default=8)
    parser.add_argument("--page-size", type=int, default=2048)
    parser.add_argument("--char-min", type=int, default=8)
    parser.add_argument("--char-max", type=int, default=14)
    parser.add_argument("--seed", type=int, default=4242)
    parser.add_argument("--compute-dtype", default="float32")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    print(
        json.dumps(
            evaluate_tiled_recall(
                args.checkpoint,
                args.model_config,
                num_pages=args.num_pages,
                page_size=args.page_size,
                char_min=args.char_min,
                char_max=args.char_max,
                seed=args.seed,
                compute_dtype=args.compute_dtype,
                device=args.device,
            )
        )
    )


if __name__ == "__main__":
    main()
