"""Weights carried across from the JAX package's parameter trees.

The committed weight files (``examples/flagship_training/*.f16.npz``,
``tests/fixtures/overfit_micro_params.npz``) hold a flat ``"a/b/c"`` key per
leaf of the Flax parameter tree, with f16 leaves for the large files.
``load_npz`` reads that format back into a nested dict of f32 numpy arrays;
``state_dict_from_jax`` turns the nested tree into the port's ``state_dict``.

The port's submodules carry the Flax tree's own names
(``backbone.stage0.layer0.dwconv``, ``rough_neck.step1_0.conv``, ...). The
leaf layouts change as follows:

  conv kernel HWIO (kh, kw, I, O)     -> weight OIHW (O, I, kh, kw)
  depthwise kernel (7, 7, 1, C)       -> weight (C, 1, 7, 7)
  Dense kernel (in, out)              -> Linear weight (out, in)
  LayerNorm scale                     -> weight
  bias, block_scale (C,)              -> unchanged

A gradient tree and AdamW's moment trees (optax's ``mu`` and ``nu``) have
the parameters' structure and layouts, so the same two functions carry them
across, leaf for leaf under the port's names. ``leaf_fingerprints`` reduces
such a tree to two numbers a leaf and ``leaf_sample`` to a few of its
elements, small enough to store as a reference.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def load_npz(path: str) -> Dict[str, Any]:
    """Flat ``"a/b/c"`` npz -> nested dict of numpy arrays (f16 cast to f32)."""
    params: Dict[str, Any] = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = params
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            leaf = flat[key]
            if leaf.dtype == np.float16:
                leaf = leaf.astype(np.float32)
            node[parts[-1]] = leaf
    return params


def _leaf_to_torch(name: str, leaf: np.ndarray):
    leaf = np.asarray(leaf)
    if name == "kernel":
        if leaf.ndim == 4:
            return "weight", leaf.transpose(3, 2, 0, 1)
        if leaf.ndim == 2:
            return "weight", leaf.T
        raise ValueError(f"kernel of rank {leaf.ndim}")
    if name == "scale":
        return "weight", leaf
    return name, leaf


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested Flax params (numpy leaves) -> the port's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
            else:
                name, arr = _leaf_to_torch(key, value)
                out[prefix + name] = torch.from_numpy(np.array(arr, dtype=np.float32))

    walk(params, "")
    return out


def jax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``state_dict_from_jax``: the port's ``state_dict`` ->
    nested Flax params with numpy leaves."""
    params: Dict[str, Any] = {}
    for key, tensor in sd.items():
        arr = tensor.detach().cpu().numpy()
        parts = key.split(".")
        node = params
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        name = parts[-1]
        if name == "weight":
            if arr.ndim == 4:
                name, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                name, arr = "kernel", arr.T
            else:
                name = "scale"
        node[name] = np.ascontiguousarray(arr)
    return params


def leaf_fingerprints(leaves: Mapping[str, Any], seed: int = 0) -> Dict[str, Tuple[float, float]]:
    """Per leaf (the port's names and layouts, numpy or tensors): its L2
    norm and its dot product with a random unit vector of its shape, drawn
    from numpy's ``[seed, i]`` where i is the leaf's place in sorted name
    order; both in f64."""
    out = {}
    for i, name in enumerate(sorted(leaves)):
        leaf = leaves[name]
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        a = np.asarray(leaf, dtype=np.float64).reshape(-1)
        v = np.random.default_rng([seed, i]).standard_normal(a.size)
        out[name] = (float(np.linalg.norm(a)), float(a @ v) / float(np.linalg.norm(v)))
    return out


SAMPLE_SIZE = 64


def leaf_sample(leaf: Any) -> np.ndarray:
    """``SAMPLE_SIZE`` elements of a leaf (numpy or a tensor, the port's
    layout), evenly strided over its flattened form, the first and the last
    among them; all of a smaller leaf. f32."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    a = np.asarray(leaf, dtype=np.float32).reshape(-1)
    return a[np.linspace(0, a.size - 1, min(SAMPLE_SIZE, a.size)).round().astype(np.int64)]
