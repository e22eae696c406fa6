"""The port stands alone: it imports no JAX, Flax, optax, orbax, OpenCV or PIL
and nothing of the JAX package, and its entry points refuse to fall back to the CPU by themselves."""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"^\s*(import|from) (jax|flax|optax|orbax|cv2|PIL|adascale)\b")


def test_port_and_chip_smoke_import_no_jax_cv2_or_adascale():
    code = (
        "import sys\n"
        "import adascale_torch, adascale_torch.inference.engine, adascale_torch.inference.flatten\n"
        "import adascale_torch.inference.eval, adascale_torch.kernels.convnext_block\n"
        "import adascale_torch.inference.tiled, adascale_torch.inference.batch\n"
        "import adascale_torch.models.upernext, adascale_torch.data.geometry\n"
        "import adascale_torch.kernels._nvcc, adascale_torch.kernels.fpn_neck\n"
        "import adascale_torch.kernels.fpn_heads, adascale_torch.kernels.precise_heads\n"
        "import adascale_torch.losses, adascale_torch.training\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'optax', 'orbax', 'cv2', 'PIL', 'adascale'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_no_forbidden_import_lines():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "adascale_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            offenders += [f"{path}:{i}" for i, line in enumerate(f, 1) if FORBIDDEN.match(line)]
        with open(path) as f:
            assert "cpp_extension" not in f.read(), path
    assert not offenders, offenders


def test_engine_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from adascale_torch import AdaptiveScalingConfig, AdaptiveScalingInference
    from adascale_torch import AdaptiveScalingInferenceConfig

    config = AdaptiveScalingInferenceConfig(
        model=AdaptiveScalingConfig(custom_block_channels_and_num_layers=((8, 1), (16, 1), (32, 1), (64, 1)))
    )
    assert config.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdaptiveScalingInference(config, params={})
