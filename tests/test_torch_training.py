"""The port's training slice against the JAX package's, on the CPU at the
micro size ((8,1),(16,1),(32,1),(64,1); 32x32 crops; 8 label points):

  * the trainable block (``TrainableBlock``) against ``jax.vjp(block_xla)``,
    what ``make_trainable_block``'s backward computes: 1e-5 of the largest
    gradient;
  * the repaired wrapper: a call that needs a gradient goes through the
    Function, and the module path's gradients equal autograd through the
    plain twin;
  * drop path: exactly Flax's ``DropPath`` on equal masks, the per-layer
    rates, and the micro model with drop path on against Flax with the same
    masks (1e-5 of the largest output);
  * the schedule against the JAX one and torch's ``CosineAnnealingWarmRestarts``
    (1e-6 relative), the optimizer against the optax chain (1e-6);
  * the two-task step against ``_two_task_loss(deterministic=True)``: losses
    within 1e-5 relative, each leaf's gradient within 1e-4 (L2 of the
    difference over the L2 of JAX's); then one optimizer step, and a second
    with JAX's moments carried across; remat, the mask head and the eval step.
"""
import dataclasses

import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import jax
import jax.numpy as jnp

from adascale.losses import CoreBox as JaxCoreBox
from adascale.losses import AdaptiveScalingPreciseLossConfig as JaxPreciseLossConfig
from adascale.models import AdaptiveScaling as JaxModel
from adascale.models import AdaptiveScalingConfig as JaxConfig
from adascale.models.convnext import DropPath
from adascale.ops.pallas import block_xla
from adascale.training import OptimizerConfig as JaxOptimizerConfig
from adascale.training import TrainStepConfig as JaxStepConfig
from adascale.training import build_optimizer as jax_build_optimizer
from adascale.training import cosine_annealing_warm_restarts as jax_schedule
from adascale.training import make_eval_step as jax_make_eval_step
from adascale.training.train_step import _two_task_loss
from adascale_torch.kernels import convnext_block as K
from adascale_torch.losses import AdaptiveScalingPreciseLossConfig, CoreBox
from adascale_torch.models import convnext as C
from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
from adascale_torch.training import (
    Metrics,
    OptimizerConfig,
    TrainStepConfig,
    build_optimizer,
    cosine_annealing_warm_restarts,
    make_eval_step,
    make_train_step,
    seeded_batches,
    setup_seeds,
    two_task_loss,
    upcast_batch,
)
from adascale_torch.utils.params import jax_from_state_dict, leaf_fingerprints, leaf_sample, state_dict_from_jax

MICRO_SPEC = ((8, 1), (16, 1), (32, 1), (64, 1))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ----------------------------------------------------------- the trainable block


def _block_case(c, hw, seed):
    rng = np.random.default_rng(seed)
    p = {
        "dwconv.weight": rng.standard_normal((c, 1, 7, 7)) * 0.1,
        "dwconv.bias": rng.standard_normal(c) * 0.1,
        "ln.weight": 1 + rng.standard_normal(c) * 0.1,
        "ln.bias": rng.standard_normal(c) * 0.1,
        "mlp_up.weight": rng.standard_normal((4 * c, c)) * c ** -0.5,
        "mlp_up.bias": rng.standard_normal(4 * c) * 0.1,
        "mlp_down.weight": rng.standard_normal((c, 4 * c)) * (4 * c) ** -0.5,
        "mlp_down.bias": rng.standard_normal(c) * 0.1,
        "block_scale": rng.uniform(0.5, 1.5, c),
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, *hw, c)).astype(np.float32)
    g = rng.standard_normal((2, *hw, c)).astype(np.float32)
    return x, p, g


def _to_jax_layout(name, a):
    if name == "dwconv.weight":
        return a.transpose(2, 3, 1, 0)  # (C, 1, 7, 7) -> (7, 7, 1, C)
    if name.endswith("mlp_up.weight") or name.endswith("mlp_down.weight"):
        return a.T
    return a


@pytest.mark.parametrize("c,hw", [(8, (13, 19)), (16, (8, 8))])
def test_trainable_block_grads_match_block_xla_vjp(c, hw):
    x, p, g = _block_case(c, hw, seed=c)
    inputs = [torch.tensor(x, requires_grad=True)] + [
        torch.tensor(p[k], requires_grad=True) for k in K.PARAM_NAMES
    ]
    out = K.TrainableBlock.apply(*inputs)
    plain = K.convnext_block_plain(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(block_xla, jnp.asarray(x), *(jnp.asarray(_to_jax_layout(k, p[k])) for k in K.PARAM_NAMES))
        want = vjp(jnp.asarray(g))
    for name, t, w in zip(("x",) + K.PARAM_NAMES, got, want):
        w = np.asarray(w)
        err = _max_rel(_to_jax_layout(name, t.numpy()), w)
        assert err <= 1e-5, (name, err)
        assert tuple(t.shape) == (x.shape if name == "x" else p[name].shape)


def test_wrapper_routes_a_gradient_through_the_function():
    x, p, _ = _block_case(8, (8, 8), seed=3)
    params = {k: torch.tensor(v, requires_grad=(k == "mlp_up.bias")) for k, v in p.items()}
    before = K.LAUNCHES
    out = K.convnext_block(torch.from_numpy(x), params)
    assert out.grad_fn is not None and "TrainableBlock" in type(out.grad_fn).__name__
    with torch.no_grad():
        assert K.convnext_block(torch.from_numpy(x), params).grad_fn is None
    assert K.LAUNCHES == before


def test_module_path_grads_equal_autograd_through_the_plain_twin(monkeypatch):
    torch.manual_seed(0)
    backbone = C.ConvNeXt(MICRO_SPEC)
    with torch.no_grad():
        for block in backbone.blocks():
            block.block_scale.uniform_(0.25, 0.75)
    x = torch.randn(2, 32, 32, 3)
    weights = [torch.randn(f.shape) for f in backbone(x)]

    def grads():
        backbone.zero_grad()
        loss = sum((f * w).sum() for f, w in zip(backbone(x), weights))
        loss.backward()
        return {k: p.grad.clone() for k, p in backbone.named_parameters()}

    through_function = grads()
    monkeypatch.setattr(C, "convnext_block", K.convnext_block_plain)
    through_plain = grads()
    assert through_function.keys() == through_plain.keys()
    for k in through_plain:
        torch.testing.assert_close(through_function[k], through_plain[k], rtol=1e-6, atol=1e-9)
    assert all(float(g.abs().sum()) > 0 for k, g in through_function.items() if "stage0" in k or "stem" in k)


@pytest.mark.cuda
def test_cuda_wrapper_keeps_the_gradient():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, p, g = _block_case(96, (13, 19), seed=5)
    params = {k: torch.tensor(v, device="cuda", requires_grad=True) for k, v in p.items()}
    xc = torch.tensor(x, device="cuda", requires_grad=True)
    before = K.LAUNCHES
    out = K.convnext_block(xc, params)
    assert K.LAUNCHES == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, [xc, *params.values()], torch.tensor(g, device="cuda"))
    want = torch.autograd.grad(
        K.convnext_block_plain(xc, params), [xc, *params.values()], torch.tensor(g, device="cuda")
    )
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# ------------------------------------------------------------------ drop path


def test_drop_path_equals_flax_on_equal_masks():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((16, 5, 7, 16)).astype(np.float32)
    out = x + rng.standard_normal(x.shape).astype(np.float32) * 1e-3
    prob = 0.5
    key = jax.random.PRNGKey(7)
    layer = DropPath(prob)
    mask = np.asarray(layer.apply({}, jnp.ones(x.shape), False, rngs={"drop_path": key}))[:, 0, 0, 0] != 0
    assert 0 < mask.sum() < len(mask)
    flax = x + np.asarray(layer.apply({}, jnp.asarray(out - x), False, rngs={"drop_path": key}))
    pallas_train = np.asarray(x + jnp.where(mask[:, None, None, None], (out - x) / (1 - prob), 0.0))
    got = C.drop_path(torch.from_numpy(x), torch.from_numpy(out), torch.from_numpy(mask), 1 - prob).numpy()
    np.testing.assert_array_equal(got, flax)
    np.testing.assert_array_equal(got, pallas_train)


def _flax_forward_with_masks(model, params, x, key, method):
    """Flax's forward with drop path on, jitted; each DropPath's mask is
    recovered by applying it to ones (the same draw), and its result is
    Flax's formula on that mask. Returns the outputs, the masks and the
    rates, layer by layer."""
    rates = []

    def fwd(params, x, key):
        masks = []

        def interceptor(next_fun, args, kwargs, context):
            if not (isinstance(context.module, DropPath) and context.method_name == "__call__"):
                return next_fun(*args, **kwargs)
            y, prob = args[0], context.module.prob_bypass
            rates.append(prob)
            if prob == 0.0:
                return next_fun(*args, **kwargs)
            keep = next_fun(jnp.ones_like(y), *args[1:], **kwargs)[:, :1, :1, :1] != 0
            masks.append(keep[:, 0, 0, 0])
            return jnp.where(keep, y / (1.0 - prob), jnp.zeros_like(y))

        with nn.intercept_methods(interceptor):
            out = model.apply({"params": params}, x, False, rngs={"drop_path": key}, method=method)
        return out, masks

    with jax.default_matmul_precision("highest"):
        out, masks = jax.jit(fwd)(params, jnp.asarray(x), key)
    masks = iter(np.asarray(m) for m in masks)
    return out, [None if r == 0.0 else next(masks) for r in rates], rates


def test_drop_path_model_matches_flax_with_its_masks(models):
    tm, jm, params = models
    x = np.random.default_rng(8).uniform(0, 255, (16, 32, 32, 3)).astype(np.float32)
    want, masks, rates = _flax_forward_with_masks(jm, params, x, jax.random.PRNGKey(11), jm.forward_rough)
    blocks = tm.backbone.blocks()
    assert rates == [b.prob_bypass for b in blocks] == [0.1 * l / (len(blocks) - 1) for l in range(len(blocks))]
    assert any(m is not None and not m.all() for m in masks)
    drop_masks = [None if m is None else torch.from_numpy(m.astype(np.float32)) for m in masks]
    with torch.no_grad():
        got = tm.forward_rough(torch.from_numpy(x), False, drop_masks=drop_masks)
        plain = tm.forward_rough(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert _max_rel(g.numpy(), w) <= 1e-5
    assert any(_max_rel(g.numpy(), p.numpy()) > 1e-3 for g, p in zip(got, plain))


def test_drop_masks_come_from_the_generator():
    backbone = C.ConvNeXt(MICRO_SPEC)
    a = backbone.draw_drop_masks(64, torch.Generator().manual_seed(1))
    b = backbone.draw_drop_masks(64, torch.Generator().manual_seed(1))
    assert a[0] is None and all(torch.equal(u, v) for u, v in zip(a[1:], b[1:]))
    assert 0.8 < float(a[-1].mean()) < 1.0  # keep 0.9 over 64 samples
    state = torch.random.get_rng_state()
    setup_seeds()
    assert torch.equal(state, torch.random.get_rng_state())


# -------------------------------------------------------- schedule and optimizer


def test_schedule_matches_jax_and_torch_over_two_cycles():
    """Both at 1e-6: torch's (f64, as the port) relative to the lr; the JAX
    one computes in f32, so it is held to 1e-6 of the base lr (near a
    cycle's end, where the lr is ~1e-2 of base, f32 rounding alone reaches
    ~2e-6 of the lr)."""
    base, t0, tmult, eta, spe = 8e-4, 10, 10, 8e-6, 50
    ours = cosine_annealing_warm_restarts(base, t0, tmult, eta, spe)
    theirs = jax_schedule(base, t0, tmult, eta, spe)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=base)
    sched = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(opt, T_0=t0, T_mult=tmult, eta_min=eta)
    steps = sorted({*range(0, 110 * spe, 97), *(k * spe + d for k in (0, 9, 10, 11, 109) for d in (0, 1, 17, 49))})
    for step in steps:
        sched.step(step / spe)
        got = ours(step)
        np.testing.assert_allclose(got, opt.param_groups[0]["lr"], rtol=1e-6, atol=0)
        np.testing.assert_allclose(got, float(theirs(step)), rtol=0, atol=1e-6 * base)


@pytest.mark.parametrize("scale", [10.0, 0.1], ids=["clipped", "unclipped"])
def test_optimizer_matches_optax_chain(scale):
    """Parameters within 1e-6 relative; the moments within 1e-6 of each
    tensor's largest value (XLA fuses ``(1 - b) g + b m`` into an FMA, so an
    element that cancels across steps differs by a few ulp of the tensor)."""
    rng = np.random.default_rng(10)
    shapes = {"a.weight": (6, 4, 3, 3), "a.bias": (6,), "b.weight": (5, 7), "c": (3,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [
        {k: (rng.standard_normal(s) * scale / 8).astype(np.float32) for k, s in shapes.items()}
        for _ in range(3)
    ]
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    ours, _ = build_optimizer(params, OptimizerConfig(), steps_per_epoch=2)
    tx, _ = jax_build_optimizer(JaxOptimizerConfig(), steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        norm = float(ours.step())
        np.testing.assert_allclose(norm, float(optax.global_norm(g)), rtol=1e-6)
        assert (norm > 2.5) == (scale > 1)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in params:
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    adam = state[1][0]
    assert ours.count == int(adam.count) == 3
    for k in params:
        for got, want in ((ours.mu[k], adam.mu[k]), (ours.nu[k], adam.nu[k])):
            assert _max_rel(got.numpy(), want) <= 1e-6, k


def test_metrics_sliding_window():
    metrics = Metrics(["foo", "bar"], 3)
    assert [metrics.update("foo", v) for v in (1, 2, 3, 4)] == [1, 1.5, 2, 3]
    metrics.reset(["foo"])
    assert metrics.update("foo", 10) == 10 and metrics.mean("bar") is None


# --------------------------------------------------------- the two-task step


@pytest.fixture(scope="module")
def models():
    """The micro model on both sides, seeded weights shared through numpy,
    with layer scales around 0.5 so that the blocks count."""
    torch.manual_seed(0)
    tm = AdaptiveScaling(AdaptiveScalingConfig(custom_block_channels_and_num_layers=MICRO_SPEC))
    sd = tm.state_dict()
    rng = np.random.default_rng(0)
    for key in sd:
        if key.endswith("block_scale"):
            sd[key] = torch.from_numpy(rng.uniform(0.25, 0.75, sd[key].shape).astype(np.float32))
    tm.load_state_dict(sd, strict=True)
    jm = JaxModel(config=JaxConfig(custom_block_channels_and_num_layers=MICRO_SPEC))
    return tm, jm, jax_from_state_dict(sd)


def _batches(seed=11):
    return seeded_batches(seed, 2, rough_size=32, precise_size=32, num_points=8,
                          rough_core_margin=2, precise_core_margin=1)


def _configs(rough_box, precise_box, **precise_loss):
    port = TrainStepConfig(
        precise_loss=AdaptiveScalingPreciseLossConfig(**precise_loss),
        rough_core_box=rough_box, precise_core_box=precise_box,
    )
    jax_cfg = JaxStepConfig(
        precise_loss=JaxPreciseLossConfig(**precise_loss),
        rough_core_box=JaxCoreBox(*rough_box), precise_core_box=JaxCoreBox(*precise_box),
    )
    return port, jax_cfg


_JAX_FNS = {}


def _jax_value_and_grad(jm, params, rough, precise, cfg):
    """``jax.value_and_grad`` of ``_two_task_loss(deterministic=True)``,
    jitted once per model and config."""
    key = (id(jm), cfg)
    if key not in _JAX_FNS:
        _JAX_FNS[key] = jax.jit(jax.value_and_grad(
            lambda p, r, q: _two_task_loss(jm, p, r, q, jax.random.PRNGKey(0), cfg, True), has_aux=True
        ))
    fn = _JAX_FNS[key]
    with jax.default_matmul_precision("highest"):
        (_, (r, p)), grads = fn(params, rough, precise)
    return float(r), float(p), state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _port_grads(tm, rough, precise, cfg):
    tm.zero_grad()
    total, (r, p) = two_task_loss(tm, upcast_batch(rough, CPU), upcast_batch(precise, CPU), cfg, True)
    total.backward()
    return float(r.detach()), float(p.detach()), {k: v.grad.clone() for k, v in tm.named_parameters()}


def _check_losses_and_grads(port, jax_result):
    (r, p, grads), (jr, jp, jgrads) = port, jax_result
    np.testing.assert_allclose([r, p], [jr, jp], rtol=1e-5, atol=0)
    assert grads.keys() == jgrads.keys()
    worst = max((_rel(grads[k], jgrads[k]), k) for k in grads)
    assert worst[0] <= 1e-4, worst


def test_two_task_step_matches_jax_then_carries_the_moments(models):
    tm, jm, params = models
    tm = type(tm)(tm.config)
    tm.load_state_dict(state_dict_from_jax(params))
    rough, precise, rb, pb = _batches()
    cfg, jcfg = _configs(rb, pb)
    want = _jax_value_and_grad(jm, params, rough, precise, jcfg)
    got = _port_grads(tm, rough, precise, cfg)
    _check_losses_and_grads(got, want)

    # One optimizer step on each side's own gradients.
    tx, _ = jax_build_optimizer(JaxOptimizerConfig(), steps_per_epoch=1000)
    tx = tx._replace(update=jax.jit(tx.update))
    updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, jax_from_state_dict(want[2])), tx.init(params), params)
    jparams = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
    opt, _ = build_optimizer(dict(tm.named_parameters()), OptimizerConfig(), steps_per_epoch=1000)
    opt.step()
    new = state_dict_from_jax(jparams)
    old = state_dict_from_jax(params)
    sd = tm.state_dict()
    worst = max((_rel(sd[k] - old[k], new[k] - old[k]), k) for k in sd)
    assert worst[0] <= 1e-3, worst  # Adam's first step is ~sign(g): tiny gradients move most

    # A second step from JAX's parameters and moments, carried across.
    tm.load_state_dict(new)
    adam = state[1][0]
    opt.count = int(adam.count)
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        carried = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        for k, v in carried.items():
            getattr(opt, name)[k].copy_(v)
    rough, precise, _, _ = _batches(seed=12)
    want = _jax_value_and_grad(jm, jparams, rough, precise, jcfg)
    got = _port_grads(tm, rough, precise, cfg)
    _check_losses_and_grads(got, want)
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, jax_from_state_dict(want[2])), state, jparams)
    final = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, optax.apply_updates(jparams, updates)))
    opt.step()
    sd = tm.state_dict()
    worst = max((_rel(sd[k] - new[k], final[k] - new[k]), k) for k in sd)
    assert worst[0] <= 1e-3, worst


def test_remat_gives_the_same_losses_and_grads(models):
    tm, _, _ = models
    rough, precise, rb, pb = _batches()
    cfg, _ = _configs(rb, pb)
    results = []
    for remat in (False, True):
        tm.zero_grad()
        gen = torch.Generator().manual_seed(3)
        total, (r, p) = two_task_loss(
            tm, upcast_batch(rough, CPU), upcast_batch(precise, CPU),
            dataclasses.replace(cfg, remat=remat), False, gen,
        )
        total.backward()
        results.append(([float(r.detach()), float(p.detach())], {k: v.grad.clone() for k, v in tm.named_parameters()}))
    (l0, g0), (l1, g1) = results
    np.testing.assert_allclose(l1, l0, rtol=1e-6, atol=0)
    for k in g0:
        assert _rel(g1[k], g0[k]) <= 1e-6, k


def test_mask_head_train_step_matches_jax():
    cfg_kw = dict(custom_block_channels_and_num_layers=MICRO_SPEC, precise_enable_char_mask_head=True)
    torch.manual_seed(1)
    tm = AdaptiveScaling(AdaptiveScalingConfig(**cfg_kw))
    jm = JaxModel(config=JaxConfig(**cfg_kw))
    params = jax_from_state_dict(tm.state_dict())
    assert "precise_char_mask_head" in params
    rough, precise, rb, pb = _batches(seed=13)
    cfg, jcfg = _configs(rb, pb, char_mask_focal_factor=1.0)
    _check_losses_and_grads(
        _port_grads(tm, rough, precise, cfg), _jax_value_and_grad(jm, params, rough, precise, jcfg)
    )
    before = {k: v.detach().clone() for k, v in tm.named_parameters() if k.startswith("precise_char_mask_head")}
    opt, _ = build_optimizer(dict(tm.named_parameters()), OptimizerConfig(), steps_per_epoch=10)
    step = make_train_step(tm, opt, cfg, device="cpu")
    metrics = step(rough, precise, torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(not torch.equal(v, dict(tm.named_parameters())[k]) for k, v in before.items())


def test_eval_step_matches_jax(models):
    tm, jm, params = models
    rough, precise, rb, pb = _batches(seed=14)
    cfg, jcfg = _configs(rb, pb)
    with jax.default_matmul_precision("highest"):
        want = jax_make_eval_step(jm, jcfg)(params, rough, precise)
    got = make_eval_step(tm, cfg, device="cpu")(rough, precise)
    np.testing.assert_allclose(
        [float(got["rough_loss"]), float(got["precise_loss"])],
        [float(want["rough_loss"]), float(want["precise_loss"])], rtol=1e-5, atol=0,
    )


def test_train_step_defaults_to_cuda_and_refuses_other_dtypes(models):
    tm, _, _ = models
    with pytest.raises(NotImplementedError):
        TrainStepConfig(compute_dtype="bfloat16")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    opt, _ = build_optimizer(dict(tm.named_parameters()), OptimizerConfig(), steps_per_epoch=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(tm, opt, TrainStepConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_step(tm, TrainStepConfig())


def test_gradient_and_moment_trees_cross_with_the_parameters(models):
    _, _, params = models
    rng = np.random.default_rng(15)
    tree = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    sd = state_dict_from_jax(tree)
    back = jax_from_state_dict(sd)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    prints = leaf_fingerprints(sd, seed=0)
    assert prints == leaf_fingerprints({k: v.numpy() for k, v in sd.items()}, seed=0)
    k = "backbone.stage0.layer0.mlp_up.weight"
    np.testing.assert_allclose(prints[k][0], np.linalg.norm(sd[k].numpy()), rtol=1e-6)


def test_leaf_sample_strides_over_the_leaf():
    leaf = torch.arange(1000, dtype=torch.float32).reshape(10, 100)
    got = leaf_sample(leaf)
    assert got.dtype == np.float32 and got.size == 64 and got[0] == 0 and got[-1] == 999
    assert (np.diff(got) > 0).all()
    np.testing.assert_array_equal(got, leaf_sample(leaf.numpy()))
    np.testing.assert_array_equal(leaf_sample(np.arange(5.0)), np.arange(5.0, dtype=np.float32))


def test_stochastic_depth_needs_drawn_masks():
    backbone = C.ConvNeXt(MICRO_SPEC)
    with pytest.raises(ValueError, match="draw_drop_masks"):
        backbone(torch.zeros(1, 32, 32, 3), deterministic=False)
