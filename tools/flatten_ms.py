"""Time the host's region flattening (``inference/flatten.py::
TextRegionFlattener``, detect()'s ``flatten_regions`` step without the
rescaling) of one checkout's ``adascale_torch`` on page_0.

The regions are those detect() flattens on page_0: the polygons of the
stored JAX reference's rough char mask
(``tests/fixtures/torch_port/flagship_fpn_reference.npz``), conducted to the
page as ``engine.build_flattened_text_regions`` does, with the engine's
default ratios (typical long side 3.0, dilation 0.8, core gate 0.4). Each
round flattens every region once; the script prints one JSON line with the
label, the seconds of every round, their median, the number of regions and
of rotated ones, a hash of the flattened images and masks, the host's CPU
model and, where ``nvidia-smi`` answers, the card's name and power limit.

    python3 tools/flatten_ms.py [--root CHECKOUT] [--label NAME] [--rounds 5]

To compare two checkouts, run parent, change, change, parent in one call.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(HERE, "tests/fixtures/torch_port/flagship_fpn_reference.npz")


def host_cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "none"
    return out.splitlines()[0] if out else "none"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="the checkout whose adascale_torch is timed")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np

    from adascale_torch.data.geometry import mask_to_disconnected_polygons
    from adascale_torch.inference.flatten import TextRegionFlattener

    ref = np.load(REFERENCE)
    image = np.load(os.path.join(HERE, str(ref["page"])))["image"]
    resized = tuple(int(v) for v in ref["rough_resized_shape"])
    polygons = [
        p.to_conducted_resized_polygon(resized, image.shape[:2])
        for p in mask_to_disconnected_polygons(ref["rough_char_mask"])
    ]

    def flatten():
        return TextRegionFlattener(
            typical_long_side_ratio_min=3.0, text_region_polygon_dilate_ratio=0.8, image=image,
            text_region_polygons=polygons, core_gate_dilate_ratio=0.4,
        ).flattened_text_regions

    seconds = []
    for _ in range(args.rounds):
        t = time.perf_counter()
        regions = flatten()
        seconds.append(time.perf_counter() - t)
    digest = hashlib.sha256()
    for r in regions:
        for a in (r.flattened_image, r.flattened_mask, r.flattened_core_mask):
            digest.update(np.ascontiguousarray(a).tobytes())
    print(json.dumps({
        "label": args.label, "root": os.path.abspath(args.root), "seconds": seconds,
        "median_ms": statistics.median(seconds) * 1e3, "regions": len(regions),
        "rotated": sum(1 for r in regions if r.flattening_rotate_angle != 0.0),
        "sha256": digest.hexdigest()[:16], "host_cpu": host_cpu(), "card": card(),
    }), flush=True)


if __name__ == "__main__":
    main()
