"""bf16 training (``compute_dtype="bfloat16"``, the flagships' own setting):
the port against the JAX package on the CPU, where the kernels' plain twins
stand in for them, at the micro size ((8,1),(16,1),(32,1),(64,1); B = 2;
32x32 crops; 8 label points).

The bf16 reference is the JAX package run eagerly, under
``jax.disable_jit()``: each operation then rounds its bf16 result, as the
Flax modules state it and as the port computes it, where under ``jit``
XLA's CPU fusions keep some bf16 intermediates in f32 (the rule of
``tests/test_torch_bf16.py``); its bf16 sums (the bias gradients) accumulate
in f32 and round once (``fixtures/torch_port/jax_bf16.py::f32_sums`` says
why). Bf16 keeps 8 bits: one rounding that another summation order flips is
2^-8 = 3.9e-3 of its value.

  * (a) the trainable bf16 block (``TrainableBlockBF16``: module-mode
    forward, recompute backward) and the gradients of x and of all nine
    parameters against ``jax.vjp`` of Flax's ``ConvNeXtBlockLayer`` at
    dtype=bfloat16, at two widths: the largest difference <= MAX_TOL and the
    mean <= MEAN_TOL of the reference's largest magnitude (the per-module
    bars of ``test_torch_bf16.py``; measured: the output and every bf16
    gradient equal bit for bit, the f32 leaves (LN scale and bias, layer
    scale) within 5.6e-6 largest, 1.7e-7 mean, their sums' order);
  * (b) the two-task step at bf16, deterministic, FPN and UPerNeXt, against
    the JAX step at bf16: the rough and precise losses and the global
    gradient norm within STEP_TOL relative (asked: 1e-2; measured: 1.1e-7
    at most), each nearer the JAX bf16 value than the port's f32 step is
    (measured 8.9e-6 to 2.1e-3 away: the port really rounds as bf16); each
    leaf's gradient norm within LEAF_NORM_TOL of the JAX leaf's (asked:
    5e-2; measured: 2.6e-7 at most);
  * (c) the UPerNeXt step at f32 against the jitted JAX step, at the f32
    bars of ``test_torch_training.py`` (losses 1e-5 relative, each leaf's
    gradient 1e-4);
  * (d) drop path at bf16 against Flax's ``DropPath`` on equal masks, the
    output and its gradients, at (a)'s bars (measured: one bf16 rounding of
    the forward flips, an f32 sum's order, moving the output by 4.9e-4 of
    its largest value and the gradients by 2.8e-3 at most, 7.2e-5 mean);
  * (e) one bf16 step moves the deepest block's ``mlp_up`` weight by more
    than 0.2x the f32 step's move (the JAX package's
    ``test_bf16_backbone_receives_gradient_signal``);
  * (f) remat at bf16 gives the same losses and gradients;
  * (g) ``train()`` at bf16: finite dev losses, every block through the bf16
    module-mode twin and none through the f32 one, a checkpoint of f32
    parameters, and its export an f32 artifact (the JAX package's
    ``test_train_loop_bf16_compute``).

Where the port's gradient rounds as JAX's: ``TrainableBlockBF16``'s
recompute rounds each cotangent where its forward rounds
(``t.to(bf16).float()``); ``ops/bf16.py`` gives the bf16 GELU and the
LayerNorm of a bf16 input JAX's own derivatives; a stage's first block
rounds its residual's cotangent apart (``bf16_input``); the factor-2 FPN
heads take Flax's per-phase form (``ops/fused_upsample.py::
module_head_bf16``); the nearest upsample of a tensor that needs a gradient
repeats rows, then columns. Each of the last four taken out alone, the FPN
step's grad norm lay 6.1e-4 (the stage LayerNorms' derivative), 4.0e-4
(``bf16_input``), 9.7e-5 (the heads' product form) and 8.3e-5 (the one-copy
upsample) from JAX's, against the f32 step's 2.4e-4. The library ops take
the batch in one call under grad (``models/convnext.py::per_image``), as
JAX does; one image a call moved these numbers by 1.1e-6.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from flax import linen as nn

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_port"))

from jax_bf16 import f32_sums  # noqa: E402

from test_torch_loop import _configs as _loop_configs  # noqa: E402
from test_torch_training import (  # noqa: E402
    MICRO_SPEC,
    _batches,
    _check_losses_and_grads,
    _configs,
    _jax_value_and_grad,
    _port_grads,
)

from adascale.models import AdaptiveScaling as JaxModel  # noqa: E402
from adascale.models import AdaptiveScalingConfig as JaxConfig  # noqa: E402
from adascale.models.convnext import ConvNeXtBlockLayer, DropPath  # noqa: E402
from adascale.training.train_step import _two_task_loss  # noqa: E402
from adascale_torch.kernels import convnext_block as K  # noqa: E402
from adascale_torch.models.adaptive_scaling import (  # noqa: E402
    AdaptiveScaling,
    AdaptiveScalingConfig,
    init_like_flax_,
)
from adascale_torch.models.convnext import ConvNeXtBlock  # noqa: E402
from adascale_torch.training import (  # noqa: E402
    OptimizerConfig,
    build_optimizer,
    make_eval_step,
    make_grad_inspection_fn,
    make_train_step,
    two_task_loss,
    upcast_batch,
)
from adascale_torch.training.checkpoint import restore_pytree_numpy  # noqa: E402
from adascale_torch.training.loop import export_inference_artifact, train  # noqa: E402
from adascale_torch.utils.params import jax_from_state_dict, state_dict_from_jax  # noqa: E402

BF16 = torch.bfloat16
CPU = torch.device("cpu")
MAX_TOL, MEAN_TOL = 1e-2, 1e-3
STEP_TOL = 1e-4
LEAF_NORM_TOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def assert_bf16_close(got, want, what=""):
    """got against want: the largest and the mean difference over want's
    largest magnitude."""
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    diff = np.abs(got - want)
    print(f"{what}: largest {diff.max() / scale:.2e}, mean {diff.mean() / scale:.2e}")
    assert diff.max() <= MAX_TOL * scale, (what, diff.max() / scale)
    assert diff.mean() <= MEAN_TOL * scale, (what, diff.mean() / scale)


def _block_case(c, seed, batch=2):
    """A Flax bf16 block with perturbed parameters and a layer scale of
    order 1 (so the branch shows), the same in the port's layout, an input
    and a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 12, 10, c)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    layer = ConvNeXtBlockLayer(channels=c, dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"],
    )
    params["block_scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return params, x, g


def _check_block_grads(got_out, got_grads, want_out, want_grads):
    assert_bf16_close(got_out, want_out, "out")
    want_p = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want_grads[0]))
    assert_bf16_close(got_grads[0], want_grads[1], "dx")
    for name, grad in zip(K.PARAM_NAMES, got_grads[1:]):
        assert grad.dtype == torch.float32
        assert_bf16_close(grad, want_p[name].numpy(), name)


# ------------------------------------------------------------- (a) the block


@pytest.mark.parametrize("c", [16, 32])
def test_trainable_bf16_block_matches_flax_vjp(c):
    params, x, g = _block_case(c, seed=c)
    layer = ConvNeXtBlockLayer(channels=c, dtype=jnp.bfloat16)
    with jax.disable_jit(), f32_sums():
        want, vjp = jax.vjp(lambda prm, xx: layer.apply({"params": prm}, xx), params, jnp.asarray(x))
        want_grads = vjp(jnp.asarray(g))
    p = {k: v.requires_grad_() for k, v in state_dict_from_jax(params).items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = K.convnext_block(xt, p, BF16)
    assert out.dtype == torch.float32 and type(out.grad_fn).__name__.startswith("TrainableBlockBF16")
    grads = torch.autograd.grad(out, [xt] + [p[k] for k in K.PARAM_NAMES], torch.from_numpy(g))
    _check_block_grads(out, grads, want, want_grads)
    # The forward is the module mode's twin; the backward rounds the
    # cotangent to bf16 where the forward rounds: the gradient reaching the
    # rounded layer scale's input (mlp_down's bias) is a bf16 value.
    with torch.no_grad():
        torch.testing.assert_close(out, K.convnext_block_plain_bf16(xt, p, True), rtol=0, atol=0)
    db2 = grads[1 + K.PARAM_NAMES.index("mlp_down.bias")]
    assert torch.equal(db2, db2.to(BF16).float())


# --------------------------------------------------------- (b), (c) the step


def _micro_pair(neck, seed):
    """The micro model's f32 parameters from a seed (layer scales around
    0.5, so that the blocks count), as a port state dict and a JAX tree."""
    torch.manual_seed(seed)
    model = AdaptiveScaling(AdaptiveScalingConfig(neck_head_type=neck, custom_block_channels_and_num_layers=MICRO_SPEC))
    sd = model.state_dict()
    rng = np.random.default_rng(seed)
    for key in sd:
        if key.endswith("block_scale"):
            sd[key] = torch.from_numpy(rng.uniform(0.25, 0.75, sd[key].shape).astype(np.float32))
    return sd, jax_from_state_dict(sd)


def _port_model(neck, sd, dtype):
    model = AdaptiveScaling(
        AdaptiveScalingConfig(neck_head_type=neck, custom_block_channels_and_num_layers=MICRO_SPEC), dtype
    )
    model.load_state_dict(sd, strict=True)
    return model


def _jax_model(neck, dtype=jnp.float32):
    return JaxModel(config=JaxConfig(neck_head_type=neck, custom_block_channels_and_num_layers=MICRO_SPEC), dtype=dtype)


def _norm(t):
    return float(np.linalg.norm(np.asarray(t, np.float64)))


def _global_norm(grads):
    return float(np.sqrt(sum(_norm(g) ** 2 for g in grads.values())))


@pytest.mark.parametrize("neck", ["fpn", "upernext"])
def test_bf16_step_matches_jax_bf16_eager(neck):
    sd, params = _micro_pair(neck, seed=21)
    rough, precise, rb, pb = _batches(seed=22)
    cfg32, jcfg = _configs(rb, pb)
    cfg = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    jm = _jax_model(neck, jnp.bfloat16)
    fn = jax.value_and_grad(
        lambda p, r, q: _two_task_loss(jm, p, r, q, jax.random.PRNGKey(0), jcfg, True), has_aux=True
    )
    with jax.default_matmul_precision("highest"), jax.disable_jit(), f32_sums():
        (_, (jr, jp)), jgrads = fn(params, rough, precise)
    jgrads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    want = np.array([float(jr), float(jp), _global_norm(jgrads)])

    r, p, grads = _port_grads(_port_model(neck, sd, BF16), rough, precise, cfg)
    r32, p32, grads32 = _port_grads(_port_model(neck, sd, torch.float32), rough, precise, cfg32)
    got = np.array([r, p, _global_norm(grads)])
    f32 = np.array([r32, p32, _global_norm(grads32)])
    err, err32 = np.abs(got - want) / np.abs(want), np.abs(f32 - want) / np.abs(want)
    leaf = {k: abs(_norm(grads[k]) - _norm(jgrads[k])) / max(_norm(jgrads[k]), 1e-30) for k in grads}
    worst = max(leaf, key=leaf.get)
    print(f"{neck} bf16 step vs JAX bf16 eager: rel errs (rough, precise, grad norm) {err}, the port's f32 "
          f"step {err32}; worst leaf norm {worst} {leaf[worst]:.3e}")
    assert (err <= STEP_TOL).all(), err
    assert (err < err32).all(), (err, err32)
    assert grads.keys() == jgrads.keys()
    assert leaf[worst] <= LEAF_NORM_TOL, (worst, leaf[worst])


def test_upernext_f32_step_matches_jax():
    sd, params = _micro_pair("upernext", seed=23)
    rough, precise, rb, pb = _batches(seed=24)
    cfg, jcfg = _configs(rb, pb)
    _check_losses_and_grads(
        _port_grads(_port_model("upernext", sd, torch.float32), rough, precise, cfg),
        _jax_value_and_grad(_jax_model("upernext"), params, rough, precise, jcfg),
    )


# ------------------------------------------------------------ (d) drop path


def test_drop_path_bf16_matches_flax_on_equal_masks():
    """A bf16 block at rate 0.5 over a batch of 8: Flax's DropPath on the
    f32 branch against the port's ``x + mask * ((out - x) / keep)`` around
    the module-mode kernel, on the mask Flax drew, forward and backward."""
    c, prob = 16, 0.5
    params, x, g = _block_case(c, seed=31, batch=8)
    layer = ConvNeXtBlockLayer(channels=c, prob_bypass=prob, dtype=jnp.bfloat16)
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        if not (isinstance(context.module, DropPath) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        keep = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)[:, :1, :1, :1] != 0
        masks.append(keep[:, 0, 0, 0])
        return jnp.where(keep, args[0] / (1.0 - prob), jnp.zeros_like(args[0]))

    def fwd(prm, xx):
        with nn.intercept_methods(interceptor):
            return layer.apply({"params": prm}, xx, False, rngs={"drop_path": jax.random.PRNGKey(5)})

    with jax.disable_jit(), f32_sums():
        want, vjp = jax.vjp(fwd, params, jnp.asarray(x))
        want_grads = vjp(jnp.asarray(g))
    mask = np.asarray(masks[-1])
    assert 0 < mask.sum() < len(mask)
    block = ConvNeXtBlock(c, prob, BF16)
    block.load_state_dict(state_dict_from_jax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = block(xt, drop_mask=torch.from_numpy(mask.astype(np.float32)))
    named = dict(block.named_parameters())
    grads = torch.autograd.grad(out, [xt] + [named[k] for k in K.PARAM_NAMES], torch.from_numpy(g))
    _check_block_grads(out, grads, want, want_grads)
    dropped = ~mask
    np.testing.assert_array_equal(out.detach().numpy()[dropped], x[dropped])


# ------------------------------------------------- (e) the gradient reaches


def test_bf16_backbone_receives_gradient_signal():
    """With the layer scales at their 1e-6 init, a bf16 residual add would
    round the blocks away; the f32 residual stream keeps them: one bf16 step
    moves the deepest block's mlp_up weight by more than 0.2x the f32
    step's move."""
    rough, precise, rb, pb = _batches(seed=41)
    cfg32, _ = _configs(rb, pb)

    def mlp_delta(dtype):
        model = AdaptiveScaling(AdaptiveScalingConfig(custom_block_channels_and_num_layers=MICRO_SPEC), dtype)
        init_like_flax_(model, torch.Generator().manual_seed(0))
        weight = model.backbone.blocks()[-1].mlp_up.weight
        before = weight.detach().clone()
        opt, _ = build_optimizer(dict(model.named_parameters()), OptimizerConfig(), steps_per_epoch=10)
        cfg = dataclasses.replace(cfg32, compute_dtype="bfloat16" if dtype == BF16 else "float32")
        make_train_step(model, opt, cfg, device="cpu")(rough, precise, torch.Generator().manual_seed(1))
        return float((weight.detach() - before).abs().mean())

    d32, d16 = mlp_delta(torch.float32), mlp_delta(BF16)
    assert d32 > 0 and d16 > 0.2 * d32, (d16, d32)


# ------------------------------------------------------------------ (f) remat


def test_remat_bf16_gives_the_same_losses_and_grads():
    sd, _ = _micro_pair("fpn", seed=51)
    model = _port_model("fpn", sd, BF16)
    rough, precise, rb, pb = _batches(seed=52)
    cfg = dataclasses.replace(_configs(rb, pb)[0], compute_dtype="bfloat16")
    results = []
    for remat in (False, True):
        model.zero_grad()
        total, (r, p) = two_task_loss(
            model, upcast_batch(rough, CPU), upcast_batch(precise, CPU),
            dataclasses.replace(cfg, remat=remat), False, torch.Generator().manual_seed(3),
        )
        total.backward()
        results.append(([float(r.detach()), float(p.detach())], {k: v.grad.clone() for k, v in model.named_parameters()}))
    (l0, g0), (l1, g1) = results
    np.testing.assert_allclose(l1, l0, rtol=1e-6, atol=0)
    for k in g0:
        assert _norm(g1[k] - g0[k]) <= 1e-6 * max(_norm(g0[k]), 1e-30), k


def test_eval_and_grad_inspection_at_bf16():
    """The eval step and the gradient inspection take the bf16 model: the
    eval losses equal the deterministic two-task loss's, the inspection's
    numbers are finite and nonzero, and ``.grad`` stays untouched."""
    sd, _ = _micro_pair("fpn", seed=55)
    model = _port_model("fpn", sd, BF16)
    rough, precise, rb, pb = _batches(seed=56)
    cfg = dataclasses.replace(_configs(rb, pb)[0], compute_dtype="bfloat16")
    got = make_eval_step(model, cfg, device="cpu")(rough, precise)
    with torch.no_grad():
        _, (r, p) = two_task_loss(model, upcast_batch(rough, CPU), upcast_batch(precise, CPU), cfg, True)
    assert float(got["rough_loss"]) == float(r) and float(got["precise_loss"]) == float(p)
    inspected = make_grad_inspection_fn(model, cfg, per_parameter=True, device="cpu")(rough, precise)
    assert all(np.isfinite(v) for v in inspected.values()) and inspected["rough_abs_grads_mean"] > 0
    assert all(p.grad is None for p in model.parameters())


def test_step_refuses_a_model_of_another_dtype():
    sd, _ = _micro_pair("fpn", seed=53)
    rough, precise, rb, pb = _batches(seed=54)
    cfg32, _ = _configs(rb, pb)
    model = _port_model("fpn", sd, torch.float32)
    opt, _ = build_optimizer(dict(model.named_parameters()), OptimizerConfig(), steps_per_epoch=10)
    with pytest.raises(ValueError, match="bfloat16"):
        make_train_step(model, opt, dataclasses.replace(cfg32, compute_dtype="bfloat16"), device="cpu")


# ------------------------------------------------------------------ (g) train()


def test_train_loop_bf16_compute(tmp_path, monkeypatch):
    calls = {"bf16": 0, "f32": 0}
    plain_bf16, plain = K.convnext_block_plain_bf16, K.convnext_block_plain

    def counted_bf16(x, p, module, *rest):
        assert module and x.dtype == torch.float32
        calls["bf16"] += 1
        return plain_bf16(x, p, module, *rest)

    def counted_f32(x, p):
        calls["f32"] += 1
        return plain(x, p)

    monkeypatch.setattr(K, "convnext_block_plain_bf16", counted_bf16)
    monkeypatch.setattr(K, "convnext_block_plain", counted_f32)
    kwargs = _loop_configs(tmp_path, compute_dtype="bfloat16")
    out = tmp_path / "run"
    metrics = train(output_folder=str(out), device="cpu", **kwargs)
    assert np.isfinite(metrics["dev_loss"]) and len(metrics["epochs"][0]["step_ms"]) == 2
    # 4 blocks a pass, 2 passes: 2 steps (forward and recompute) and 2 dev
    # batches.
    assert calls == {"bf16": 2 * 2 * 8 + 2 * 8, "f32": 0}, calls
    ckpts = sorted(d for d in os.listdir(out) if d.startswith("state_0"))
    assert ckpts
    restored = restore_pytree_numpy(str(out / ckpts[0]))
    assert all(v.dtype == np.float32 for v in restored["params"].values())
    artifact = export_inference_artifact(str(out / ckpts[0]), str(tmp_path / "artifact"), kwargs["model_config_json"])
    with np.load(os.path.join(artifact, "params.npz")) as flat:
        assert flat.files and all(flat[k].dtype == np.float32 for k in flat.files)
