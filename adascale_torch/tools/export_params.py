"""Write a model's parameters as one compact flat ``.npz``.

Counterpart of ``adascale/tools/export_params.py``. It reads any source that
``utils.params.load_params`` reads (a flat ``.npz``, a training checkpoint
of the port or a reference PyTorch state-dict file; an orbax directory
raises, ROADMAP Queue 1 item 9.3),
flattens the nested tree to ``"a/b/c"`` keys and writes f16 (half the bytes;
``load_params`` casts back to f32) or f32 leaves, the format of
``examples/flagship_training/*.f16.npz`` and
``tests/fixtures/overfit_micro_params.npz``.

Usage:
  python -m adascale_torch.tools.export_params --checkpoint reference.pt \\
      --out params.f16.npz [--dtype float16] [--model-config model.json]
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Mapping

import numpy as np


def flatten_params(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> flat ``{"a/b/c": array}``."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="adascale_torch.tools.export_params")
    parser.add_argument("--checkpoint", required=True, help=".npz or reference state-dict file")
    parser.add_argument("--out", required=True, help="output .npz path")
    parser.add_argument(
        "--dtype", default="float16", choices=["float16", "float32"],
        help="storage dtype for f32 leaves (f16 halves the file; loading casts back to f32)",
    )
    parser.add_argument("--model-config", help="model config (JSON or path): a state dict's neck type")
    args = parser.parse_args(argv)

    from ..models.adaptive_scaling import AdaptiveScalingConfig
    from ..utils.config import load_config
    from ..utils.params import load_params

    params = load_params(args.checkpoint, load_config(args.model_config, AdaptiveScalingConfig))
    out = {}
    n_bytes_in = n_bytes_out = 0
    for key, value in flatten_params(params).items():
        n_bytes_in += value.nbytes
        if args.dtype == "float16" and value.dtype == np.float32:
            value = value.astype(np.float16)
        out[key] = value
        n_bytes_out += value.nbytes
    np.savez_compressed(args.out, **out)
    print(
        f"{args.out}: {len(out)} arrays, {n_bytes_in / 1e6:.1f} MB params "
        f"-> {n_bytes_out / 1e6:.1f} MB ({args.dtype}) "
        f"-> {os.path.getsize(args.out) / 1e6:.1f} MB compressed"
    )


if __name__ == "__main__":
    main()
