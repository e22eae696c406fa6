"""Build and load the port's CUDA kernels (``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``), and check what their wrappers
pass them.

``build(name, source)`` compiles ``csrc/<source>`` once per content hash (the
source, every ``csrc/*.cuh`` header and the flags) into
``_build/<name>-<hash>/lib<name>.so`` and loads it. No PyTorch headers are
included, so a build takes seconds. One library per ``.cu`` file, so a change
to one kernel rebuilds only that one (a change to a shared header rebuilds
all). ``BUILD_REPORT[name]`` records each build: ``seconds``, ``cached``, the
``ptxas`` register/spill report and ``path``.

``refuse_grad`` is what the fused neck and heads wrappers call before a
launch: their kernels have no backward (nor have the JAX package's), and a
``ctypes`` launch writes into a fresh tensor that autograd does not see.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

BUILD_REPORT: Dict[str, Dict[str, object]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise FileNotFoundError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(source: Path, defines: Sequence[str] = ()) -> str:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS + [f"-D{d}" for d in defines]).encode())
    return h.hexdigest()[:16]


def build(name: str, source: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content hash, with ``-D`` for each
    of ``defines``) and load it as ``lib<name>.so``. Safe to call from
    several threads at once: each name builds in its own ``nvcc`` process."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
    src = CSRC / source
    out_dir = BUILD_ROOT / f"{name}-{_digest(src, defines)}"
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / "ptxas.log"
    start = time.perf_counter()
    cached = lib_path.exists()
    if not cached:
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.{os.getpid()}.{threading.get_ident()}.so"
        cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, *(f"-D{d}" for d in defines), f"-I{CSRC}",
               "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    with _LOCK:
        BUILD_REPORT[name] = {
            "seconds": time.perf_counter() - start,
            "cached": cached,
            "ptxas": log_path.read_text() if log_path.exists() else "",
            "path": str(lib_path),
        }
        return _LIBS.setdefault(name, lib)


# The activation types the kernels take, and the channel multiple each needs
# (a 16-byte copy: 4 f32 or 8 bf16 channels).
CHANNEL_MULTIPLE = {torch.float32: 4, torch.bfloat16: 8}


def check_dtype(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` is of a type the kernels take (f32 or bf16), on
    any device: the plain twins on the CPU refuse what the kernels refuse."""
    if t.dtype not in CHANNEL_MULTIPLE:
        raise ValueError(f"{name}: want float32 or bfloat16, got {t.dtype}")


def check_param(name: str, t: torch.Tensor, shape: Sequence[int], device: torch.device) -> None:
    """Raise unless ``t`` is a float32 tensor of ``shape`` on ``device``."""
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want float32 {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def check_activation(
    name: str, t: torch.Tensor, device: torch.device, dtypes=(torch.float32,)
) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned NHWC tensor of one
    of ``dtypes`` on the CUDA ``device`` whose channel count is a multiple of
    4 (f32) or 8 (bf16): the kernels copy it 16 bytes at a time."""
    if device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: want a tensor on a CUDA device, got {t.device}")
    if t.dim() != 4 or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous (B, H, W, C) tensor of {[str(d) for d in dtypes]}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    multiple = CHANNEL_MULTIPLE[t.dtype]
    if t.shape[-1] % multiple or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: want C % {multiple} == 0 and 16-byte alignment, got C={t.shape[-1]} "
            f"at address {t.data_ptr():#x}"
        )


def refuse_grad(wrapper: str, *tensors: torch.Tensor) -> None:
    """Raise where grad is enabled and any of ``tensors`` requires grad: a
    kernel launched through ``ctypes`` returns a tensor without a gradient,
    which would drop it without an error. The wrappers call this on the
    card only; on the CPU their plain twins keep the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{wrapper}: the kernel has no backward, and its input or a parameter "
            "requires grad; training runs the module neck and heads (as the JAX "
            "train step does), or call it under torch.no_grad() / torch.inference_mode()"
        )
