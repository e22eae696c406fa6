"""Time the FPN neck's level-0 3x3 convolution (384 -> 96, same padding) on
one CUDA card in three forms of the same function, with cuDNN's algorithm
search off and on, in turns (off, on, on, off).

    python3 tools/neck_conv_ms.py [--batch 6]

The shapes are those of the flagship's two-task train step at B = ``--batch``
(level 0 of the rough pass, 128x128, and of the precise pass, 80x80), f32,
TF32 off. The forms: ``model``, an NHWC tensor permuted to NCHW as the model
passes it to cuDNN; ``nchw``, the same made contiguous in NCHW first;
``taps``, the nine shifted views concatenated on the channel axis and one
matrix product (as the heads compute their phases). For each turn it prints
one JSON line: forward alone and forward + backward (input and weight
gradients) ms by CUDA events, and the largest difference between the forms
over the largest output. The card's name and power limit come first, as
``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def neck_conv_ms(batch: int) -> dict:
    gen = torch.Generator().manual_seed(0)
    conv = torch.nn.Conv2d(384, 96, 3, padding=1).cuda()

    def taps(x):
        h, w = x.shape[1], x.shape[2]
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        cols = torch.cat([xp[:, dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)], dim=-1)
        k = conv.weight.permute(2, 3, 1, 0).reshape(9 * 384, 96)
        return (cols.reshape(-1, 9 * 384) @ k + conv.bias).reshape(x.shape[0], h, w, 96)

    forms = {
        "model": lambda x: conv(x.permute(0, 3, 1, 2)),
        "nchw": lambda x: conv(x.permute(0, 3, 1, 2).contiguous()),
        "taps": taps,
    }
    out = {}
    for name, hw in (("rough_128x128", 128), ("precise_80x80", 80)):
        x = torch.randn(batch, hw, hw, 384, generator=gen).cuda()
        xg = x.clone().requires_grad_()
        for form, fn in forms.items():
            with torch.no_grad():
                out[f"{name}_{form}_forward"] = events_ms(lambda: fn(x), 3)
            out[f"{name}_{form}_forward_backward"] = events_ms(lambda: fn(xg).sum().backward(), 3)
        with torch.no_grad():
            ref = forms["model"](x).permute(0, 2, 3, 1)
            err = max(float((forms["nchw"](x).permute(0, 2, 3, 1) - ref).abs().max()),
                      float((forms["taps"](x) - ref).abs().max()))
        out[f"{name}_max_rel_err_between_forms"] = err / float(ref.abs().max())
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("neck_conv_ms: a CUDA device is required")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for benchmark in (False, True, True, False):
        torch.backends.cudnn.benchmark = benchmark
        print(json.dumps({"cudnn_benchmark": benchmark, "batch": args.batch, **neck_conv_ms(args.batch)}),
              flush=True)


if __name__ == "__main__":
    main()
