"""The port's data-parallel train step (``adascale_torch/parallel``,
``make_train_step(mesh=...)``) on the CPU: gloo ranks in fresh processes
(``tests/fixtures/torch_port/mesh_workers.py``), held against the JAX
package's mesh step and plain step on conftest's virtual CPU devices, at the
micro size of ``tests/test_training.py`` ((8,1),(16,1),(32,1),(64,1); 32x32
crops, 8 label points; a global batch of 4), drop path on:

  (a) a 2-rank mesh step against the JAX 2-device mesh step and the JAX
      plain step on the same global batch, the port given JAX's drop-path
      masks: losses and grad norm within 1e-5 relative (the JAX mesh tests'
      bar), each rank's reduced gradient within 1e-5 of the leaf's largest
      gradient, each parameter after the step within 1e-5 of the reference
      leaf's largest magnitude where its gradient is not near zero
      (``_check_step``); where it is near zero the two JAX steps are shown
      to lie more than 2e-5 apart, so that no step meets 1e-5 of both there
      (the gap is printed, ``-s``);
  (b) the same on labels whose masks are unbalanced across the ranks, where
      the mean of the ranks' own losses (what averaging per-rank losses
      would train on) misses the reference by more than the bar;
  (c) a hybrid (2, 2) ``("dcn", "data")`` mesh over 4 ranks, against the
      JAX hybrid mesh step (as ``test_train_step_hybrid_mesh_2x4``) and the
      plain step;

The JAX steps compile in threads, side by side (~25 s each alone). Two
steps from the generator's masks and the helpers:
``tests/test_torch_mesh_paths.py``.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import jax
import jax.numpy as jnp

from adascale.losses import CoreBox as JaxCoreBox
from adascale.models import AdaptiveScaling as JaxModel
from adascale.models import AdaptiveScalingConfig as JaxConfig
from adascale.models.convnext import DropPath
from adascale.parallel import create_hybrid_mesh as jax_hybrid_mesh
from adascale.parallel import create_mesh as jax_mesh
from adascale.parallel.mesh import batch_sharding, replicated_sharding
from adascale.training import OptimizerConfig as JaxOptimizerConfig
from adascale.training import TrainStepConfig as JaxStepConfig
from adascale.training import build_optimizer as jax_build_optimizer
from adascale.training.train_step import _two_task_loss
from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig
from adascale_torch.training import seeded_batches
from adascale_torch.utils.params import jax_from_state_dict, state_dict_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_port"))

from mesh_workers import run_group  # noqa: E402

MICRO_SPEC = ((8, 1), (16, 1), (32, 1), (64, 1))
BATCH = 4
REL_TOL = 1e-5
SMALL_GRAD = 1e-3
KEY = jax.random.PRNGKey(5)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _batches(seed):
    return seeded_batches(seed, BATCH, rough_size=32, precise_size=32, num_points=8,
                          rough_core_margin=2, precise_core_margin=1)


def _unbalanced(seed):
    """Rank 0's rows nearly without positive labels, rank 1's nearly all
    positive: masked means over the whole batch are far from the mean of
    the two halves' masked means."""
    rough, precise, rb, pb = _batches(seed)
    rng = np.random.default_rng(seed)
    for batch in (rough, precise):
        share = np.where(np.arange(BATCH) < BATCH // 2, 0.03, 0.95)[:, None, None]
        batch["downsampled_mask"] = (rng.uniform(size=batch["downsampled_mask"].shape) < share).astype(np.uint8)
    return rough, precise, rb, pb


@pytest.fixture(scope="module")
def setup():
    """The micro model on both sides (port init, layer scales near 0.5),
    and the JAX steps: plain, 2-device mesh and (2, 2) hybrid mesh, each
    returning the new parameters, the losses, the grad norm and the
    drop-path masks it drew, compiled side by side."""
    torch.manual_seed(0)
    tm = AdaptiveScaling(AdaptiveScalingConfig(custom_block_channels_and_num_layers=MICRO_SPEC))
    sd = tm.state_dict()
    rng = np.random.default_rng(0)
    for key in sd:
        if key.endswith("block_scale"):
            sd[key] = torch.from_numpy(rng.uniform(0.25, 0.75, sd[key].shape).astype(np.float32))
    state = {k: v.numpy().copy() for k, v in sd.items()}
    params = jax_from_state_dict(sd)
    jm = JaxModel(config=JaxConfig(custom_block_channels_and_num_layers=MICRO_SPEC))
    tx, _ = jax_build_optimizer(JaxOptimizerConfig(), steps_per_epoch=10)
    rough, precise, rb, pb = _batches(1)
    jcfg = JaxStepConfig(rough_core_box=JaxCoreBox(*rb), precise_core_box=JaxCoreBox(*pb))

    def step(params, opt_state, rng, rough, precise):
        masks = []

        def record(next_fun, args, kwargs, context):
            # DropPath's own draw, applied to ones once (Flax's formula on
            # the mask it drew): the forward is unchanged and the masks come
            # out.
            if not (isinstance(context.module, DropPath) and context.method_name == "__call__"):
                return next_fun(*args, **kwargs)
            y, prob = args[0], context.module.prob_bypass
            if prob == 0.0:
                return next_fun(*args, **kwargs)
            keep = next_fun(jnp.ones_like(y), *args[1:], **kwargs)[:, :1, :1, :1] != 0
            masks.append(keep[:, 0, 0, 0])
            return jnp.where(keep, y / (1.0 - prob), jnp.zeros_like(y))

        def loss(p):
            with nn.intercept_methods(record):
                return _two_task_loss(jm, p, rough, precise, rng, jcfg, False)

        (_, (r, p)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), r, p, optax.global_norm(grads), masks, grads

    cpus = jax.devices("cpu")
    meshes = {"plain": None, "mesh": jax_mesh(cpus[:2]), "hybrid": jax_hybrid_mesh(2, cpus[:4])}
    opt_state = tx.init(params)
    args = (params, opt_state, KEY, rough, precise)

    def compiled(mesh):
        if mesh is None:
            fn = jax.jit(step)
        else:
            repl, data = replicated_sharding(mesh), batch_sharding(mesh)
            fn = jax.jit(step, in_shardings=(repl, repl, repl, data, data))
        with jax.default_matmul_precision("highest"):
            return fn.lower(*args).compile()

    with ThreadPoolExecutor(3) as pool:
        fns = dict(zip(meshes, pool.map(compiled, meshes.values())))

    def run(name, rough, precise):
        new, r, p, norm, masks, grads = fns[name](params, opt_state, KEY, rough, precise)
        return {
            "params": {k: v.numpy() for k, v in state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new)).items()},
            "metrics": {"rough_loss": float(r), "precise_loss": float(p), "grad_norm": float(norm)},
            "masks": [np.asarray(m) for m in masks],
            "grads": {k: v.numpy() for k, v in state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads)).items()},
        }

    return {"state": state, "run": run, "boxes": (tuple(rb), tuple(pb))}


def _port_masks(masks):
    """JAX's masks (each pass's non-zero-rate blocks, rough then precise) as
    the port's draws: None for the first block of each pass (rate 0)."""
    per_pass = len(masks) // 2
    return [[None] + masks[:per_pass], [None] + masks[per_pass:]]


def _moved(g):
    """The elements whose gradient is not near zero."""
    return np.abs(g) > SMALL_GRAD * np.abs(g).max()


def _param_gap(got, want, moved):
    """The largest distance of ``got``'s parameters after the step from
    ``want``'s, over the leaves, each leaf's over its largest magnitude, on
    the elements whose gradient in ``want`` is (``moved``) or is not near
    zero; with the leaf's name."""
    return max(
        (float(np.abs(got["params"][k] - w)[_moved(want["grads"][k]) == moved].max(initial=0.0)
               / np.abs(w).max()), k)
        for k, w in want["params"].items()
    )


def _check_step(got, want, label):
    """Losses and grad norm within REL_TOL relative; each rank's reduced
    gradient within REL_TOL of the leaf's largest gradient; the parameters
    after the step within REL_TOL of the leaf's largest magnitude wherever
    the gradient exceeds SMALL_GRAD of the leaf's largest gradient. Adam's
    first step is lr * sign(g): an element whose gradient is near zero moves
    by up to lr on a rounding difference of its gradient, and there the JAX
    mesh step and the JAX plain step themselves differ by more than twice
    REL_TOL of a leaf's largest magnitude (``_mesh_case`` asserts it)."""
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][0][k] - v) <= REL_TOL * abs(v), (label, k, got["metrics"][0][k], v)
    worst = max(
        (float(np.abs(got["grads"][k] - g).max() / np.abs(g).max()), k) for k, g in want["grads"].items()
    )
    assert worst[0] <= REL_TOL, (label, "gradient", worst)
    worst = _param_gap(got, want, moved=True)
    assert worst[0] <= REL_TOL, (label, "parameter", worst)


def _mesh_case(setup, tmp_path, world, data, slices=None):
    rough, precise, _, _ = data
    plain, mesh_name = setup["run"]("plain", rough, precise), ("hybrid" if slices else "mesh")
    jax_mesh_step = setup["run"](mesh_name, rough, precise)
    for a, b in zip(plain["masks"], jax_mesh_step["masks"]):
        np.testing.assert_array_equal(a, b)
    assert any(not m.all() for m in plain["masks"])
    # Where the gradient is near zero the two JAX steps lie more than twice
    # REL_TOL apart, so no parameters are within REL_TOL of both there; the
    # bar holds on the other elements, as it does between the two steps.
    apart, near = _param_gap(jax_mesh_step, plain, moved=False), _param_gap(jax_mesh_step, plain, moved=True)
    print(f"{mesh_name}, {world} ranks: JAX mesh vs plain step parameters {apart[0]:.3e} apart where the "
          f"gradient is near zero ({apart[1]}), {near[0]:.3e} elsewhere")
    assert apart[0] > 2 * REL_TOL, apart
    assert near[0] <= REL_TOL, near
    payload = dict(spec=MICRO_SPEC, state=setup["state"], rough_box=setup["boxes"][0],
                   precise_box=setup["boxes"][1], batches=[(rough, precise)], masks=_port_masks(plain["masks"]),
                   slices=slices)
    ranks = run_group("step", world, tmp_path, payload)
    assert [r["rank"] for r in ranks] == list(range(world))
    for r in ranks:
        _check_step(r, plain, "plain")
        _check_step(r, jax_mesh_step, mesh_name)
        for key in ("params", "grads"):
            for k, v in ranks[0][key].items():
                np.testing.assert_array_equal(r[key][k], v)
        assert r["metrics"] == ranks[0]["metrics"]
    return ranks, plain


def test_mesh_step_matches_jax_mesh_and_plain_steps(setup, tmp_path):
    _mesh_case(setup, tmp_path, 2, _batches(1))


def test_mesh_step_keeps_the_global_loss_on_unbalanced_masks(setup, tmp_path):
    ranks, plain = _mesh_case(setup, tmp_path, 2, _unbalanced(2))
    # What a mean of per-rank losses would give misses the global loss.
    for i, name in enumerate(("rough_loss", "precise_loss")):
        mean = np.mean([r["local"][0][i] for r in ranks])
        want = plain["metrics"][name]
        assert abs(mean - want) > REL_TOL * abs(want), (name, mean, want)


def test_hybrid_mesh_step_matches_jax(setup, tmp_path):
    _mesh_case(setup, tmp_path, 4, _batches(3), slices=2)
