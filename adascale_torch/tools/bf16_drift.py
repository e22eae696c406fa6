"""bf16 serving drift against f32: the counterpart of
``adascale/tools/bf16_drift.py``.

Runs the two-pass engine twice over one page, at ``compute_dtype="float32"``
with ``matmul_precision="highest"`` and at ``"bfloat16"`` with
``"default"``, as the JAX tool does (the same engine configuration
otherwise), and reports
rough mask agreement, the height map's largest and median difference where
both are valid, the median heights, and each run's char F1 against the
page's ground-truth corners, with dF1 = F1(bf16) - F1(f32).

    python -m adascale_torch.tools.bf16_drift [--device cpu] [--fused] \\
        [--weights PATH] [--page PATH]
    python -m adascale_torch.tools.bf16_drift --references

Defaults: the tiny/FPN flagship (``examples/flagship_training``) on
``tests/fixtures/shift_pages/page_0.npz`` (its ``corners`` are the ground
truth), on the card; ``--fused`` sets ``use_pallas_backbone`` and
``use_pallas_neck_heads``. ``--device cpu`` runs the plain versions. The
tests call ``drift`` with the overfit micro fixture and its page, the JAX
tool's case. ``--references`` runs no model: it prints how far the JAX
package's own stored outputs on page_0 (``tests/fixtures/torch_port/``) are
from each other, f32 against bf16 and the two bf16 paths, the drift that a
bf16 port's parity bars have to leave room for.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
WEIGHTS = os.path.join(ROOT, "examples/flagship_training/flagship_fpn_params.f16.npz")
PAGE = os.path.join(ROOT, "tests/fixtures/shift_pages/page_0.npz")
# (compute_dtype, matmul_precision) of the two runs, the JAX tool's.
RUNS = (("float32", "highest"), ("bfloat16", "default"))


def drift(
    params: Mapping[str, Any],
    config: Any,
    image: np.ndarray,
    gt_corners: Sequence[np.ndarray],
    results: Optional[Mapping[str, Any]] = None,
) -> Dict[str, float]:
    """bf16 against f32 for an ``AdaptiveScalingInferenceConfig`` (its
    ``compute_dtype`` and ``matmul_precision`` set to each of ``RUNS`` in
    turn) on ``image``; the numbers that ``main`` prints, with both F1s and
    both results (``results``). A ``results`` entry ("float32" or
    "bfloat16") is that dtype's detect() of ``image`` already run with this
    config at that run's precision, and is used in place of a run."""
    from ..inference.engine import AdaptiveScalingInference
    from ..inference.eval import evaluate_char_detection

    runs = {}
    for dtype, precision in RUNS:
        result = (results or {}).get(dtype)
        if result is None:
            engine = AdaptiveScalingInference(
                dataclasses.replace(config, compute_dtype=dtype, matmul_precision=precision), params=params
            )
            result = engine.detect(image)
        runs[dtype] = (result, evaluate_char_detection(result["char_polygons"], gt_corners, iou_thr=0.5))
    (r32, m32), (r16, m16) = runs["float32"], runs["bfloat16"]
    h32 = r32["rough"].rough_char_height_score_map
    h16 = r16["rough"].rough_char_height_score_map
    both = (h32 > 0) & (h16 > 0)
    return {
        "mask_agreement": float((r32["rough"].rough_char_mask == r16["rough"].rough_char_mask).mean()),
        "height_max_abs": float(np.abs(h32 - h16)[both].max()) if both.any() else 0.0,
        "height_median_abs": float(np.median(np.abs(h32 - h16)[both])) if both.any() else 0.0,
        "height_median_f32": float(np.median(h32[h32 > 0])) if (h32 > 0).any() else 0.0,
        "height_median_bf16": float(np.median(h16[h16 > 0])) if (h16 > 0).any() else 0.0,
        "f1_f32": m32.f1,
        "f1_bf16": m16.f1,
        "df1": m16.f1 - m32.f1,
        "results": {"float32": r32, "bfloat16": r16},
    }


def format_drift(d: Mapping[str, Any]) -> str:
    """One line of ``drift``'s numbers."""
    return (
        f"mask agreement {d['mask_agreement']:.6f}, height max-abs {d['height_max_abs']:.4f} "
        f"median-abs {d['height_median_abs']:.4f} (both valid), height median f32/bf16 "
        f"{d['height_median_f32']:.3f}/{d['height_median_bf16']:.3f}, F1 f32 {d['f1_f32']:.4f} "
        f"bf16 {d['f1_bf16']:.4f}, dF1 {d['df1']:+.4f}"
    )


FIXTURES = os.path.join(ROOT, "tests/fixtures/torch_port")
# Pairs of stored JAX outputs on page_0 (make_reference.py's cases).
REFERENCE_PAIRS = (
    ("flagship_fpn_reference.npz", "flagship_fpn_bf16_reference.npz"),
    ("flagship_fpn_reference.npz", "flagship_fpn_fused_bf16_reference.npz"),
    ("flagship_fpn_bf16_reference.npz", "flagship_fpn_fused_bf16_reference.npz"),
    ("flagship_upernext_reference.npz", "flagship_upernext_bf16_reference.npz"),
)


def references() -> None:
    """Rough mask agreement and the polygons matched at IoU >= 0.5, each way,
    between the JAX package's stored outputs in REFERENCE_PAIRS."""
    from ..data.geometry import Polygon
    from ..inference.eval import match_polygons

    for a, b in REFERENCE_PAIRS:
        ra, rb = np.load(os.path.join(FIXTURES, a)), np.load(os.path.join(FIXTURES, b))
        pa = [Polygon(p) for p in ra["char_polygons"]]
        pb = [Polygon(p) for p in rb["char_polygons"]]
        matched = len(match_polygons(pa, pb, 0.5))
        print(
            f"{a} / {b}: mask agreement {(ra['rough_char_mask'] == rb['rough_char_mask']).mean():.6f}, "
            f"polygons {len(pa)} / {len(pb)}, matched {matched} ({matched / len(pa):.4f} / "
            f"{matched / len(pb):.4f})",
            flush=True,
        )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--fused", action="store_true")
    parser.add_argument("--weights", default=WEIGHTS)
    parser.add_argument("--page", default=PAGE)
    parser.add_argument("--references", action="store_true")
    args = parser.parse_args(argv)
    if args.references:
        references()
        return

    from ..inference.engine import AdaptiveScalingInferenceConfig
    from ..models.adaptive_scaling import AdaptiveScalingConfig
    from ..utils.params import load_npz

    page = np.load(args.page)
    config = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(size="tiny", neck_head_type="fpn"),
        use_pallas_backbone=args.fused, use_pallas_neck_heads=args.fused, device=args.device,
    )
    d = drift(load_npz(args.weights), config, page["image"], list(page["corners"]))
    print(f"bf16 drift ({args.device}, fused={args.fused}): {format_drift(d)}", flush=True)


if __name__ == "__main__":
    main()
