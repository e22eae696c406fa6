"""The port's profiling and inspection tools on the CPU (micro model, small
shapes): ``tools/train_profile.py``, ``tools/serve_profile.py``,
``tools/kernel_sweep.py`` and ``tools/inspect.py``.

* The FLOP counts both profilers derive from the shapes against
  ``torch.utils.flop_counter.FlopCounterMode`` on the plain path, component
  by component, within 1 %. The counter counts a grouped convolution's
  weight gradient as a dense one (``conv_backward_flop`` leaves the groups
  out: a depthwise 7x7's C times over), so it is given that term divided by
  the groups (``GROUPED_CONV_BACKWARD``); every other formula is torch's.
* Each tool's ``main`` with ``--device cpu`` prints the JAX tool's labels.
* ``kernel_sweep``'s heads-fused variant, ``forward_rough_from_features_fused(
  ..., fuse_neck=False)``, against the JAX function at ``fuse_neck=False``
  (its Pallas heads in interpret mode) at 2e-5 and the Flax model at 1e-3
  (ROADMAP's parity bars).
* ``sample_dataset`` against the JAX one on ``tests/test_tools.py``'s steps:
  the same stems and the painted arrays equal (the JAX images taken in
  memory by a test-side ``monkeypatch`` of its painter's ``to_file``).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.utils.flop_counter as flop_counter

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_fpn_heads import micro_models  # noqa: E402
from test_tools import _steps  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from adascale.ops.pallas.fpn_heads import (  # noqa: E402
    forward_rough_from_features_fused as jax_forward_rough_from_features_fused,
)
from adascale.tools import sample_dataset as jax_sample_dataset  # noqa: E402
from adascale.utils import painter as jax_painter  # noqa: E402
from adascale_torch.kernels.fpn_heads import forward_rough_from_features_fused  # noqa: E402
from adascale_torch.tools import inspect as I  # noqa: E402
from adascale_torch.tools import kernel_sweep, serve_profile  # noqa: E402
from adascale_torch.tools import train_profile as tp  # noqa: E402
from adascale_torch.training.train_step import TrainStepConfig  # noqa: E402
from adascale_torch.utils.png import read_image  # noqa: E402

MICRO = "8x1,16x1,32x1,64x1"
FLOP_TOL = 0.01
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _grouped_conv_backward(*args, out_shape=None, **kwargs):
    """torch's ``conv_backward_flop`` with the weight gradient's count
    divided by the groups."""
    raw = flop_counter.conv_backward_flop.__wrapped__
    groups, mask = args[9], args[10]
    data = raw(*args[:10], [mask[0], False], out_shape)
    weight = raw(*args[:10], [False, mask[1]], out_shape)
    return data + weight // groups


GROUPED_CONV_BACKWARD = {torch.ops.aten.convolution_backward: _grouped_conv_backward}


def _counted(fn) -> int:
    with flop_counter.FlopCounterMode(display=False, custom_mapping=GROUPED_CONV_BACKWARD) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("dtype,remat", [("f32", False), ("f32", True), ("bf16", False)])
def test_train_profile_flops_match_the_flop_counter(dtype, remat):
    model, specs = tp.build(MICRO, dtype, CPU)
    _, _, rough, precise, rbox, pbox = tp.batches(2, 64, 48, CPU)
    cfg = TrainStepConfig(rough_core_box=rbox, precise_core_box=pbox, remat=remat,
                          compute_dtype={"f32": "float32", "bf16": "bfloat16"}[dtype])
    rows = tp.ablations(model, specs, rough, precise, cfg, CPU, dtype, remat)
    assert [label for label, _, _ in rows][:7] == [
        "full_step", "fwd_only(two-task loss)", "grad_only", "rough_task_grad", "precise_task_grad",
        "backbone_grad(rough shape)", "optimizer_only",
    ]
    for label, fn, flops in rows:
        got = _counted(fn)
        if flops is None:
            assert got == 0, label
            continue
        assert abs(got - flops) <= FLOP_TOL * flops, (label, got, flops)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_serve_profile_flops_match_the_flop_counter(dtype):
    model, specs = tp.build(MICRO, dtype, CPU)
    with torch.inference_mode():
        for label, fn, flops, nbytes in serve_profile.rows(model.eval(), specs, 2, 96, dtype, CPU):
            got = _counted(fn)
            assert abs(got - flops) <= FLOP_TOL * flops, (label, got, flops)
            assert nbytes > 0


def _main_output(capsys, main, argv):
    result = main(argv + ["--device", "cpu"])
    return result, capsys.readouterr().out


def test_train_profile_main_prints_the_jax_labels(capsys):
    times, out = _main_output(capsys, tp.main, ["--dtype", "f32", "--batch", "1", "--iters", "1",
                                                "--rough-hw", "64", "--precise-hw", "64", "--block-spec", MICRO])
    for label in ("full_step", "fwd_only(two-task loss)", "grad_only", "rough_task_grad", "precise_task_grad",
                  "backbone_grad(rough shape)", "optimizer_only", "dw7x7 16x16x8", "-- summary --",
                  "backward (diff)", "dwconv micro sum", "mfu="):
        assert label in out, label
    assert all(v > 0 for v in times.values())


def test_train_profile_loop_probe(capsys):
    _, out = _main_output(capsys, tp.main, ["--loop-probe", "--dtype", "f32", "--batch", "1", "--iters", "1",
                                            "--rough-hw", "64", "--precise-hw", "64", "--block-spec", MICRO])
    for label in ("py-loop, device-resident inputs", "py-loop, numpy f32 inputs", "py-loop, numpy compact inputs",
                  "fetch 2 ready scalars", "H2D overhead/step"):
        assert label in out, label


@pytest.mark.parametrize("pallas", [False, True], ids=["module", "pallas"])
def test_serve_profile_main_prints_the_jax_rows(capsys, pallas):
    argv = ["--dtype", "bf16" if pallas else "f32", "--batch", "1", "--hw", "96", "--iters", "1",
            "--block-spec", MICRO] + (["--pallas"] if pallas else [])
    results, out = _main_output(capsys, serve_profile.main, argv)
    labels = [r["label"] for r in results]
    assert labels[:4] == ["full_rough_forward", "backbone_only", "neck_only", "heads_only(x2)"]
    assert "stage3 dwconv7x7 x1" in labels and "stage3 LN+MLP4x x1" in labels
    assert all(0 < r["share"] <= 1 for r in results)
    assert "sum of per-stage roofline bounds" in out and "achieved/bound=" in out


@pytest.mark.parametrize("skip_stages", [False, True], ids=["stages", "skip-stages"])
def test_kernel_sweep_main_prints_its_json(capsys, skip_stages):
    argv = ["--dtype", "f32", "--batch", "1", "--hw", "64", "--iters", "1", "--block-spec", MICRO]
    results, out = _main_output(capsys, kernel_sweep.main, argv + (["--skip-stages"] if skip_stages else []))
    printed = json.loads(out.strip().splitlines()[-1])["kernel_sweep_ms"]
    assert printed == pytest.approx(results)
    for entry in kernel_sweep.ENTRIES:
        assert (f"s0 16x16x8 x1 {entry}" in printed) is not skip_stages
    for label in ("full rough fwd module", "full rough fwd +heads", "full rough fwd +neck+heads",
                  "full precise fwd module", "full precise fwd fused"):
        assert label in printed


def test_heads_fused_variant_matches_jax_fuse_neck_false():
    model, flax_model, params = micro_models(5)
    rng = np.random.default_rng(6)
    feats = [rng.standard_normal((1, 16 >> i, 12 >> i, c)).astype(np.float32) for i, c in enumerate((8, 16, 32, 64))]
    with torch.no_grad():
        got = forward_rough_from_features_fused(model, [torch.from_numpy(f) for f in feats], fuse_neck=False)
    with jax.default_matmul_precision("highest"):
        want_fused = jax_forward_rough_from_features_fused(
            flax_model, params, [jnp.asarray(f) for f in feats], fuse_neck=False, interpret=True
        )
        want_model = flax_model.apply(
            {"params": params}, tuple(jnp.asarray(f) for f in feats), method=flax_model.forward_rough_from_features
        )
    for g, wf, wm in zip(got, want_fused, want_model):
        assert tuple(g.shape) == wf.shape == wm.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wf), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(wm), atol=1e-3, rtol=1e-3)


def test_profile_forward_writes_traces(tmp_path):
    from adascale_torch.models.adaptive_scaling import AdaptiveScalingConfig

    config = AdaptiveScalingConfig(custom_block_channels_and_num_layers=((8, 1), (16, 1), (32, 1), (64, 1)))
    got = I.profile_forward(config, resolution=64, batch=1, iters=1, trace_dir=str(tmp_path), device="cpu")
    assert sorted(got) == ["forward_precise", "forward_rough"] and all(v > 0 for v in got.values())
    for name in got:
        with open(tmp_path / f"{name}.json") as f:
            assert json.load(f)["traceEvents"]


def test_sample_dataset_equals_the_jax_one(tmp_path, monkeypatch):
    steps = _steps(tmp_path)
    captured = {}
    monkeypatch.setattr(
        jax_painter.Painter, "to_file",
        lambda self, path: captured.__setitem__(os.path.splitext(os.path.basename(str(path)))[0], self.image.copy()),
    )
    jax_sample_dataset(steps, str(tmp_path / "jax"), num_batches=2, batch_size=2)
    I.sample_dataset(steps, str(tmp_path / "port"), num_batches=2, batch_size=2)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(f"{stem}.png" for stem in captured) and len(files) == 12
    for name in files:
        np.testing.assert_array_equal(read_image(str(tmp_path / "port" / name)), captured[name[:-4]], err_msg=name)


def test_profile_dataset_stats(tmp_path):
    stats = I.profile_dataset(_steps(tmp_path), num_batches=2, batch_size=2)
    assert sorted(stats) == ["batches_per_s", "max_s", "mean_s", "median_s"]
    assert stats["mean_s"] > 0 and stats["batches_per_s"] > 0
