"""How far the port's ``"python"`` render backend lies from the JAX package's.

    python tests/fixtures/torch_port/render_bound.py [--seeds 200] [--first 1000]

Generates pages at the default ``SynthPageConfig`` at 512x512, 500x500 and
512x400 for each seed with both packages' ``generate_page`` (the JAX one
draws with cv2), checks that the chars are equal bit for bit, and prints the
largest difference of the images in gray levels and the share of image
values that differ. CPU only; imports the JAX package and cv2.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))

from adascale.data import synth as JS  # noqa: E402
from adascale_torch.data import synth as TS  # noqa: E402

SHAPES = ((512, 512), (500, 500), (512, 400))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=200)
    parser.add_argument("--first", type=int, default=1000)
    args = parser.parse_args(argv)
    worst, differ, values, pages = 0, 0, 0, 0
    for seed in range(args.first, args.first + args.seeds):
        for h, w in SHAPES:
            want = JS.generate_page(JS.SynthPageConfig(page_height=h, page_width=w), np.random.default_rng(seed))
            got = TS.generate_page(TS.SynthPageConfig(page_height=h, page_width=w), np.random.default_rng(seed))
            if len(got.chars) != len(want.chars) or any(
                not np.array_equal(a.corners, b.corners) or a.height != b.height for a, b in zip(got.chars, want.chars)
            ):
                raise SystemExit(f"seed {seed}, {h}x{w}: the chars differ")
            diff = np.abs(got.image.astype(np.int16) - want.image.astype(np.int16))
            worst = max(worst, int(diff.max()))
            differ += int((diff > 0).sum())
            values += diff.size
            pages += 1
    print(f"{pages} pages (seeds {args.first}-{args.first + args.seeds - 1}, {SHAPES}): chars equal; image "
          f"largest difference {worst} gray levels, {differ} of {values} values differ ({differ / values:.3e})")


if __name__ == "__main__":
    main()
