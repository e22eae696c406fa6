"""The port's training loop, checkpoints, export and ``train`` / ``export``
commands (``adascale_torch/training/{loop,checkpoint}.py``, ``cli.py``) on
the CPU, at the micro size: the model ((8,1),(16,1),(32,1),(64,1)), 192²
native-rendered pages, 96² rough and 64² precise crops (the shapes of
``tests/test_train_loop.py``), both loops starting from one
``init_params_path``:

  * at lr 0 the two loops' dev losses agree within 1e-4 relative (PERF.md
    §2's step bar; the dev set is the same data in both, and drop path
    draws from different random streams, so train losses are not compared);
  * a trained run saves ``state_<epoch>`` checkpoints, a restore puts back
    the parameters, the moments, the step count and the lr bit for bit, and
    the run continues from it; ``reset_step``, ``set_opt_step``,
    ``restore_with_new_optimizer``;
  * ``export_inference_artifact`` writes a ``.npz`` that the engine serves
    with the same polygons as an engine built from the checkpoint;
  * ``python -m adascale_torch train`` / ``export`` / ``detect`` with
    ``--device cpu``;
  * overfit mode, the curriculum's switch, gradient inspection (its
    numbers against the JAX package's within 1e-4) and a profiled run;
  * a fresh model's parameters follow the distributions of the JAX
    package's ``model.init`` (each leaf's standard deviation within 15 %,
    for FPN and UPerNeXt; biases, LayerNorms and layer scales exact);
  * a compute dtype other than f32 and bf16 (float16) and a missing card
    raise (bf16 training: ``tests/test_torch_train_bf16.py``); the mesh at
    world size 1 gives the plain loop's losses, and the ``"python"`` render
    backend trains (the mesh over 2 ranks: ``tests/test_torch_mesh_paths.py``).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

from adascale.losses import CoreBox as JaxCoreBox
from adascale.models import AdaptiveScaling as JaxModel
from adascale.models import AdaptiveScalingConfig as JaxConfig
from adascale.training.loop import train as jax_train
from adascale.training.train_step import TrainStepConfig as JaxStepConfig
from adascale.training.train_step import make_grad_inspection_fn as jax_grad_inspection
from adascale_torch.cli import main as cli_main
from adascale_torch.inference.engine import AdaptiveScalingInference, AdaptiveScalingInferenceConfig
from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
from adascale_torch.tools.export_params import flatten_params
from adascale_torch.training import OptimizerConfig, TrainStepConfig, build_optimizer, make_grad_inspection_fn
from adascale_torch.training.checkpoint import (
    latest_checkpoint_path,
    restore_checkpoint,
    restore_pytree_numpy,
    restore_with_new_optimizer,
    set_opt_step,
)
from adascale_torch.training.loop import _clean_batch, export_inference_artifact, train
from adascale_torch.utils.params import jax_from_state_dict, load_params
from adascale_torch.utils.png import write_png

MICRO_SPEC = [[8, 1], [16, 1], [32, 1], [64, 1]]
STEPS = dict(
    page=dict(
        page_height=192, page_width=192, num_lines_min=3, num_lines_max=5, char_height_min=10,
        char_height_max=24, render_backend="native",
    ),
    rough_crop_size=96,
    rough_core_margin=4,
    precise_crop_size=64,
    precise_core_margin=2,
    rough_samples_per_page=2,
    precise_samples_per_page=2,
)
EPOCH = dict(
    num_epochs=1, train_num_batches=2, train_batch_size=2, train_num_processes=0, dev_num_batches=2,
    dev_batch_size=2, dev_num_processes=0, num_page_char_regression_labels=8, avg_num_batches=4,
)
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _write(tmp_path, name, obj):
    path = tmp_path / name
    path.write_text(json.dumps(obj))
    return str(path)


def _configs(tmp_path, **epoch):
    steps = _write(tmp_path, "steps.json", STEPS)
    dataset = _write(tmp_path, "dataset.json", {
        "train_adaptive_scaling_dataset_steps_jsons": [steps],
        "train_rng_seeds": [7],
        "epoch_indices": [0],
        "dev_adaptive_scaling_dataset_steps_json": steps,
    })
    return dict(
        dataset_config_json=dataset,
        epoch_config_json=_write(tmp_path, "epoch.json", {**EPOCH, **epoch}),
        model_config_json=_write(tmp_path, "model.json", {
            "size": "tiny", "neck_head_type": "fpn", "custom_block_channels_and_num_layers": MICRO_SPEC,
        }),
    )


def _model_config():
    return AdaptiveScalingConfig(custom_block_channels_and_num_layers=tuple(map(tuple, MICRO_SPEC)))


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory):
    """Shared initial weights: a seeded port model as a flat ``.npz``, which
    both packages' ``load_params`` read."""
    torch.manual_seed(11)
    model = AdaptiveScaling(_model_config())
    with torch.no_grad():
        for block in model.backbone.blocks():
            block.block_scale.uniform_(0.1, 0.3)
    path = str(tmp_path_factory.mktemp("init") / "init.npz")
    np.savez(path, **flatten_params(jax_from_state_dict(model.state_dict())))
    return path


def test_dev_losses_at_lr_zero_equal_jax(tmp_path, init_npz):
    kwargs = _configs(tmp_path)
    kwargs["optimizer_config_json"] = _write(
        tmp_path, "opt.json", {"adamw_lr": 0.0, "cosine_annealing_warm_restarts_eta_min": 0.0}
    )
    got = train(output_folder=str(tmp_path / "port"), init_params_path=init_npz, device="cpu", **kwargs)
    with jax.default_matmul_precision("highest"):
        want = jax_train(output_folder=str(tmp_path / "jax"), init_params_path=init_npz, **kwargs)
    for key in ("dev_rough_loss", "dev_precise_loss", "dev_loss"):
        assert abs(got[key] - want[key]) <= LOSS_TOL * abs(want[key]), (key, got[key], want[key])
    print({k: (got[k], want[k]) for k in ("dev_rough_loss", "dev_precise_loss")})
    # lr 0: the checkpoint holds the initial weights.
    saved = load_params(got["epochs"][0]["checkpoint"], _model_config())
    flat_init = np.load(init_npz)
    assert all(np.array_equal(v, flat_init[k]) for k, v in flatten_params(saved).items())


def _restored(path):
    model = AdaptiveScaling(_model_config())
    optimizer, schedule = build_optimizer(dict(model.named_parameters()), OptimizerConfig(), steps_per_epoch=2)
    return model, optimizer, schedule


def test_trained_run_saves_restores_and_continues(tmp_path, init_npz):
    kwargs = _configs(tmp_path, num_epochs=2)
    out = str(tmp_path / "run")
    first = train(output_folder=out, init_params_path=init_npz, device="cpu", **kwargs)
    names = sorted(n for n in os.listdir(out) if n.startswith("state_"))
    assert names[0] == "state_0" and names[1] in ("state_1", "state_1_not_best") and len(names) == 2
    assert all(np.isfinite(e["train_rough_loss"]) and np.isfinite(e["train_precise_loss"]) for e in first["epochs"])
    last = latest_checkpoint_path(out)
    assert last == os.path.join(out, names[1]) == first["epochs"][1]["checkpoint"]

    # A restore puts back exactly what was saved.
    payload = torch.load(last, weights_only=True)
    model, optimizer, schedule = _restored(last)
    assert restore_checkpoint(last, model, optimizer) == {"epoch_idx": 1}
    for k, v in model.state_dict().items():
        assert torch.equal(v, payload["params"][k]), k
    for which in ("mu", "nu"):
        for k, v in getattr(optimizer, which).items():
            assert torch.equal(v, payload["opt_state"][which][k]), (which, k)
    assert optimizer.count == payload["opt_state"]["count"] == 4
    assert schedule(optimizer.count) == first["epochs"][1]["lr_next_step"]

    # reset_step and set_opt_step move only the count; a new optimizer config
    # keeps the moments and takes its own schedule.
    restore_checkpoint(last, model, optimizer, reset_step=10)
    assert optimizer.count == 10
    set_opt_step(optimizer, 3)
    assert optimizer.count == 3
    new = restore_with_new_optimizer(last, model, OptimizerConfig(adamw_lr=1e-3), steps_per_epoch=2)
    assert new["epoch_idx"] == 1 and new["optimizer"].count == 4
    assert all(torch.equal(v, payload["opt_state"]["mu"][k]) for k, v in new["optimizer"].mu.items())
    assert new["schedule"](0) == pytest.approx(1e-3)
    wider = AdaptiveScaling(AdaptiveScalingConfig(custom_block_channels_and_num_layers=((16, 1), (16, 1), (32, 1), (64, 1))))
    wider_opt, _ = build_optimizer(dict(wider.named_parameters()), OptimizerConfig(), steps_per_epoch=2)
    with pytest.raises(ValueError, match="does not fit"):
        restore_checkpoint(last, wider, wider_opt)

    # Continue: one more epoch from the restored state.
    kwargs["epoch_config_json"] = _write(tmp_path, "epoch3.json", {**EPOCH, "num_epochs": 3})
    more = train(output_folder=out, restore_state_path=last, device="cpu", **kwargs)
    assert [e["epoch"] for e in more["epochs"]] == [2]
    state2 = restore_pytree_numpy(more["epochs"][0]["checkpoint"])
    assert state2["epoch_idx"] == 2 and state2["opt_state"]["count"] == 6
    with pytest.raises(ValueError, match="exclusive"):
        train(output_folder=out, restore_state_path=last, init_params_path=init_npz, device="cpu", **kwargs)


def _page():
    from adascale_torch.data.synth import SynthPageConfig, generate_page

    return generate_page(
        SynthPageConfig(page_height=192, page_width=192, num_lines_min=2, num_lines_max=3, render_backend="native"),
        np.random.default_rng(0),
    ).image


def _polygons(result):
    return [p.points.tolist() for p in result["char_polygons"]]


def test_export_artifact_serves_detect(tmp_path, init_npz):
    kwargs = _configs(tmp_path)
    run = train(output_folder=str(tmp_path / "run"), init_params_path=init_npz, device="cpu", **kwargs)
    ckpt = run["epochs"][0]["checkpoint"]
    folder = export_inference_artifact(ckpt, str(tmp_path / "artifact"), kwargs["model_config_json"])
    assert sorted(os.listdir(folder)) == ["model_config.json", "params.npz"]
    config = _model_config()
    served = AdaptiveScalingInference(
        AdaptiveScalingInferenceConfig(checkpoint=os.path.join(folder, "params.npz"), model=config, device="cpu")
    )
    in_process = AdaptiveScalingInference(
        AdaptiveScalingInferenceConfig(model=config, device="cpu"), params=load_params(ckpt, config)
    )
    page = _page()
    assert _polygons(served.detect(page)) == _polygons(in_process.detect(page))
    with pytest.raises(ValueError, match="do not fit"):
        export_inference_artifact(ckpt, str(tmp_path / "other"), json.dumps({"size": "tiny"}))


def test_cli_train_export_detect(tmp_path, init_npz, capsys):
    kwargs = _configs(tmp_path)
    out = str(tmp_path / "run")
    cli_main([
        "train", "--dataset-config", kwargs["dataset_config_json"], "--output", out,
        "--epoch-config", kwargs["epoch_config_json"], "--model-config", kwargs["model_config_json"],
        "--device", "cpu",
    ])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(metrics["dev_loss"])
    ckpt = latest_checkpoint_path(out)
    cli_main(["export", "--checkpoint", ckpt, "--output", str(tmp_path / "artifact"),
              "--model-config", kwargs["model_config_json"]])
    folder = capsys.readouterr().out.strip().splitlines()[-1]
    page_path = str(tmp_path / "page.png")
    write_png(page_path, _page())
    cli_main(["detect", "--checkpoint", os.path.join(folder, "params.npz"), "--image", page_path,
              "--model-config", os.path.join(folder, "model_config.json"), "--device", "cpu"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["num_chars"] == len(result["char_polygons"])


@pytest.mark.parametrize("mode", ["overfit", "inspection", "profile", "curriculum"])
def test_loop_modes(tmp_path, mode):
    epoch = {
        "overfit": {"enable_overfit_testing": True},
        "inspection": {"enable_multitask_gradiant_inspection": True,
                       "multitask_gradiant_inspection_per_parameter": True},
        "profile": {"profile_num_batches": 1, "prefetch_depth": 0},
        "curriculum": {"num_epochs": 2, "train_num_batches": 1},
    }[mode]
    kwargs = _configs(tmp_path, **epoch)
    if mode == "curriculum":
        # Epoch 1 switches to pages with bigger chars and another seed.
        steps2 = _write(tmp_path, "steps2.json", {**STEPS, "page": {**STEPS["page"], "char_height_min": 16}})
        kwargs["dataset_config_json"] = _write(tmp_path, "curriculum.json", {
            "train_adaptive_scaling_dataset_steps_jsons": [str(tmp_path / "steps.json"), steps2],
            "train_rng_seeds": [7, 8],
            "epoch_indices": [0, 1],
            "dev_adaptive_scaling_dataset_steps_json": str(tmp_path / "steps.json"),
        })
    out = tmp_path / "run"
    metrics = train(output_folder=str(out), device="cpu", **kwargs)
    log = (out / "log.txt").read_text()
    assert ("dev_loss" in metrics) == (mode in ("profile", "curriculum"))
    if mode == "curriculum":
        # Saved before the switch (the boundary) and at the end.
        assert "Curriculum reset at epoch 1" in log
        assert [e["checkpoint"] is not None for e in metrics["epochs"]] == [True, True]
    assert np.isfinite(metrics["epochs"][0]["train_rough_loss"])
    if mode == "inspection":
        assert "grad inspection: rough |g| mean=" in log and "grad inspection backbone.stage0" in log
    if mode == "profile":
        assert (out / "profile" / "trace.json").stat().st_size > 0


def test_grad_inspection_equals_jax(init_npz):
    from adascale_torch.data.dataset import SynthPipelineConfig, collate_samples, run_pipeline
    from adascale_torch.utils.config import load_config

    pipeline = load_config(STEPS, SynthPipelineConfig)
    rough, precise = [], []
    for run_idx in range(3):
        r, p = run_pipeline(pipeline, 3, run_idx)
        rough += r
        precise += [s for s in p]
    for s in precise:
        s.char_labels = [s.char_labels[i % len(s.char_labels)] for i in range(8)]
    batch = collate_samples(list(zip(rough[:2], precise[:2])))
    rough_b, precise_b = _clean_batch(batch["rough"]), _clean_batch(batch["precise"])
    boxes = [batch[k]["downsampled_core_box"] for k in ("rough", "precise")]

    config = _model_config()
    model = AdaptiveScaling(config)
    params = load_params(init_npz, config)
    from adascale_torch.utils.params import state_dict_from_jax

    model.load_state_dict(state_dict_from_jax(params))
    got = make_grad_inspection_fn(
        model, TrainStepConfig(rough_core_box=boxes[0], precise_core_box=boxes[1]), per_parameter=True, device="cpu"
    )(rough_b, precise_b)
    assert all(p.grad is None for p in model.parameters())

    jax_model = JaxModel(config=JaxConfig(custom_block_channels_and_num_layers=tuple(map(tuple, MICRO_SPEC))))
    step_config = JaxStepConfig(rough_core_box=JaxCoreBox(*boxes[0]), precise_core_box=JaxCoreBox(*boxes[1]))
    with jax.default_matmul_precision("highest"):
        want = jax_grad_inspection(jax_model, step_config, per_parameter=True)(
            jax.tree.map(jax.numpy.asarray, params), jax.random.PRNGKey(0), rough_b, precise_b
        )

    def port_name(jax_name):
        parts = jax_name.split("/")
        leaf, task = parts[-1].split(":")
        leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        return ".".join(parts[:-1] + [leaf]) + ":" + task

    want = {port_name(k) if "/" in k else k: float(v) for k, v in want.items()}
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= LOSS_TOL * max(abs(v), 1e-12), (k, got[k], v)


@pytest.mark.parametrize("what", ["mesh", "float16", "python_backend", "no_card"])
def test_train_paths_run_or_raise(tmp_path, what):
    """float16 and a missing card raise; the mesh (at world size 1, gloo in
    this process: the plain loop's losses bit for bit, the group ended after)
    and the ``"python"`` render backend (finite losses) run."""
    kwargs = _configs(tmp_path)
    if what == "mesh":
        plain = train(output_folder=str(tmp_path / "plain"), device="cpu", **kwargs)
        mesh = train(output_folder=str(tmp_path / "run"), use_mesh=True, device="cpu", **kwargs)
        assert not torch.distributed.is_initialized()
        for key in ("dev_rough_loss", "dev_precise_loss"):
            assert mesh[key] == plain[key], key
        assert mesh["epochs"][0]["train_rough_loss"] == plain["epochs"][0]["train_rough_loss"]
    elif what == "float16":
        kwargs["epoch_config_json"] = _write(tmp_path, "f16.json", {**EPOCH, "compute_dtype": "float16"})
        with pytest.raises(NotImplementedError, match="compute_dtype 'float16'"):
            train(output_folder=str(tmp_path / "run"), device="cpu", **kwargs)
    elif what == "python_backend":
        steps = _write(tmp_path, "py_steps.json", {**STEPS, "page": {**STEPS["page"], "render_backend": "python"}})
        kwargs["dataset_config_json"] = _write(tmp_path, "py_dataset.json", {
            "train_adaptive_scaling_dataset_steps_jsons": [steps], "dev_adaptive_scaling_dataset_steps_json": steps,
        })
        metrics = train(output_folder=str(tmp_path / "run"), device="cpu", **kwargs)
        assert np.isfinite([metrics["dev_rough_loss"], metrics["dev_precise_loss"]]).all()
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train(output_folder=str(tmp_path / "run"), **kwargs)
        assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("neck", ["fpn", "upernext"])
def test_fresh_parameters_follow_flax_init(neck):
    """Each kernel against the JAX package's own initialiser for its module
    (``convnext.trunc_normal_init`` for the backbone and UPerNeXt,
    ``fpn.kaiming_normal_init`` for the FPN neck and heads) drawn at the
    leaf's Flax shape; the rest against its constant."""
    from adascale.models.convnext import trunc_normal_init
    from adascale.models.fpn import kaiming_normal_init
    from adascale_torch.models.adaptive_scaling import init_like_flax_
    from adascale_torch.utils.params import _leaf_to_torch

    spec = ((32, 1), (64, 1), (96, 1), (128, 1))
    torch.manual_seed(0)
    model = init_like_flax_(
        AdaptiveScaling(AdaptiveScalingConfig(neck_head_type=neck, custom_block_channels_and_num_layers=spec)),
        torch.Generator().manual_seed(0),
    )
    tree = jax_from_state_dict(model.state_dict())
    draws = {}

    def reference(init, fan_in):
        """The initialiser drawn as a Dense kernel of this fan-in (one draw
        per fan-in keeps JAX's compiles few)."""
        key = (init, fan_in if init is kaiming_normal_init else 0)
        if key not in draws:
            draws[key] = np.asarray(init(jax.random.PRNGKey(len(draws)), (max(fan_in, 64), 64), jax.numpy.float32))
        return draws[key]

    checked = 0
    for name, leaf in flatten_params(tree).items():
        if name.endswith("/kernel"):
            init = trunc_normal_init if name.startswith("backbone/") or neck == "upernext" else kaiming_normal_init
            fan_in = int(np.prod(leaf.shape[:-1]))
            want = reference(init, fan_in)
            if init is kaiming_normal_init:
                want = want * np.sqrt(max(fan_in, 64) / fan_in)
            if leaf.size >= 1000:
                ratio = float(leaf.std() / want.std())
                assert abs(ratio - 1) <= 0.15, (name, ratio)
                # The truncated normal is cut at 2 standard deviations, 0.04.
                assert np.abs(leaf).max() <= 0.04 * 1.0001 or init is kaiming_normal_init, name
                checked += 1
        elif name.endswith("/bias"):
            height = name == "rough_char_height_head/step2/bias"
            assert np.all(leaf == (8.0 if height else 0.0)), name
        elif name.endswith("/block_scale"):
            assert np.all(leaf == np.float32(1e-6)), name
        else:
            assert name.endswith("/scale") and np.all(leaf == 1.0), name
    assert checked >= 10 and _leaf_to_torch("kernel", np.zeros((3, 3, 2, 4)))[1].shape == (4, 2, 3, 3)


