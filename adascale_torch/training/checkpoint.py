"""Training checkpoints without orbax.

Counterpart of ``adascale/training/checkpoint.py``. A checkpoint is one
``torch.save`` file of ``{"epoch_idx": int, "params": the model's
state_dict, "opt_state": {"count": int, "mu": {name: tensor}, "nu": {name:
tensor}}}`` (tensors on the CPU), named ``state_<epoch>`` when the dev loss
improved and ``state_<epoch>_not_best`` otherwise, as the JAX package names
its directories. The schedule has no state of its own: the lr is a function
of the optimizer's step count, so ``set_opt_step`` (and ``reset_step`` on
restore) is the scheduler surgery of the reference.

Files are read with ``torch.load(weights_only=True)``: tensors, numbers and
dicts only, nothing unpickled that could run code.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .optimizer import ClippedAdamW, OptimizerConfig, build_optimizer

_NAME = re.compile(r"state_(\d+)(_not_best)?")


def save_checkpoint(
    path: str, model: torch.nn.Module, optimizer: ClippedAdamW, epoch_idx: int, best: bool = True
) -> str:
    """Save {epoch_idx, params, opt_state} into the folder ``path``; returns
    the file written. Written to a temporary name first and renamed, so a
    cut run never leaves a partial checkpoint under a checkpoint's name."""
    suffix = "" if best else "_not_best"
    target = os.path.abspath(os.path.join(path, f"state_{epoch_idx}{suffix}"))

    def cpu(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}

    payload = {
        "epoch_idx": int(epoch_idx),
        "params": cpu(model.state_dict()),
        "opt_state": {"count": int(optimizer.count), "mu": cpu(optimizer.mu), "nu": cpu(optimizer.nu)},
    }
    tmp = f"{target}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, target)
    return target


def latest_checkpoint_path(folder: str) -> Optional[str]:
    """The checkpoint of the highest epoch in ``folder``, or None."""
    if not os.path.isdir(folder):
        return None
    best_epoch, best_path = -1, None
    for name in os.listdir(folder):
        m = _NAME.fullmatch(name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch, best_path = int(m.group(1)), os.path.join(folder, name)
    return best_path


def _load(path: str) -> Dict[str, Any]:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?): the port reads its own "
            "checkpoint files (ROADMAP Queue 1 item 9.3); export JAX params with the JAX package's "
            "tools/export_params.py and pass the .npz as init_params_path"
        )
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(payload, Mapping) and {"epoch_idx", "params", "opt_state"} <= set(payload)):
        raise ValueError(f"{path} is not a training checkpoint of the port")
    return payload


def set_opt_step(optimizer: ClippedAdamW, step: int) -> None:
    """Put the optimizer's step count (and with it the schedule) at
    ``step``; the moments stay as they are."""
    optimizer.count = int(step)


def restore_checkpoint(
    path: str, model: torch.nn.Module, optimizer: ClippedAdamW, reset_step: Optional[int] = None
) -> Dict[str, Any]:
    """Load a checkpoint into ``model`` and ``optimizer`` in place (onto
    their devices); ``reset_step`` overrides the saved step count. Returns
    {"epoch_idx": int}. Raises ValueError when the saved optimizer state does
    not fit ``optimizer`` (other parameter names or shapes)."""
    payload = _load(path)
    saved = payload["opt_state"]
    for which in ("mu", "nu"):
        live, stored = getattr(optimizer, which), saved[which]
        if set(stored) != set(live) or any(stored[k].shape != live[k].shape for k in live):
            raise ValueError(
                f"{path}: the saved optimizer state does not fit this optimizer's parameters; "
                "restore params only (init_params_path) and start fresh moments instead"
            )
    model.load_state_dict(payload["params"], strict=True)
    with torch.no_grad():
        for which in ("mu", "nu"):
            for k, t in getattr(optimizer, which).items():
                t.copy_(saved[which][k])
    optimizer.count = int(saved["count"])
    if reset_step is not None:
        set_opt_step(optimizer, reset_step)
    return {"epoch_idx": int(payload["epoch_idx"])}


def restore_with_new_optimizer(
    path: str,
    model: torch.nn.Module,
    config: OptimizerConfig,
    steps_per_epoch: int,
    reset_step: Optional[int] = None,
) -> Dict[str, Any]:
    """Restore a checkpoint into a new optimizer built from ``config``
    (another lr, betas, weight decay, clipping or schedule): the reference's
    restore-time schedule surgery. The moments and the step count carry over
    (``reset_step`` overrides the count); ``config`` decides every later
    step. Returns {"epoch_idx", "optimizer", "schedule"}; raises ValueError
    when the saved state does not fit the model's parameters."""
    optimizer, schedule = build_optimizer(dict(model.named_parameters()), config, steps_per_epoch)
    restored = restore_checkpoint(path, model, optimizer, reset_step=reset_step)
    return {"epoch_idx": restored["epoch_idx"], "optimizer": optimizer, "schedule": schedule}


def restore_pytree_numpy(path: str) -> Dict[str, Any]:
    """A checkpoint as host numpy arrays: {"epoch_idx", "params": {name:
    array}, "opt_state": {"count", "mu", "nu"}}, for export and inspection."""
    payload = _load(path)

    def arrays(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return {k: v.numpy() for k, v in tensors.items()}

    saved = payload["opt_state"]
    return {
        "epoch_idx": int(payload["epoch_idx"]),
        "params": arrays(payload["params"]),
        "opt_state": {"count": int(saved["count"]), "mu": arrays(saved["mu"]), "nu": arrays(saved["nu"])},
    }
