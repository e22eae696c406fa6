"""The port's losses against the JAX package's: the seven primitives and the
rough and precise composites, on the same seeded inputs (numpy in between).
Values within 1e-5 relative, gradients with respect to the predictions within
1e-5 of the largest JAX gradient (f32 on both sides, other summation order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adascale.losses import adaptive_scaling as JA
from adascale.losses import primitives as JP
from adascale_torch.losses import adaptive_scaling as TA
from adascale_torch.losses import primitives as TP

TOL = 1e-5
B, H, W, P = 2, 16, 16, 8


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _check(jax_fn, torch_fn, preds, others):
    """Value and gradients w.r.t. ``preds`` of ``fn(*preds, *others)`` in
    both frameworks, held to TOL."""
    argnums = tuple(range(len(preds)))
    jv, jg = jax.value_and_grad(jax_fn, argnums=argnums)(
        *map(jnp.asarray, preds), *map(jnp.asarray, others)
    )
    tp = [torch.tensor(p, requires_grad=True) for p in preds]
    tv = torch_fn(*tp, *(torch.from_numpy(np.asarray(o)) for o in others))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=TOL, atol=0)
    for t, g in zip(tp, jg):
        g = np.asarray(g)
        err = np.abs(t.grad.numpy() - g).max()
        assert err <= TOL * np.abs(g).max(), (err, np.abs(g).max())


def _maps(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, H, W)) * 2).astype(np.float32)
    prob = (1 / (1 + np.exp(-logits))).astype(np.float32)
    gt = (rng.uniform(size=(B, H, W)) > 0.7).astype(np.float32)
    soft = rng.uniform(size=(B, H, W)).astype(np.float32)
    mask = (rng.uniform(size=(B, H, W)) > 0.3).astype(np.float32)
    values = rng.uniform(-3, 3, (B, H, W)).astype(np.float32)
    return logits, prob, gt, soft, mask, values


# name -> (function of (module, pred, target[, mask]), which prediction,
# which target, with mask)
PRIMITIVES = {
    "bce_with_logits": (lambda M, p, g: M.bce_with_logits(p, g).sum(), "logits", "gt", False),
    "ohem_bce": (lambda M, p, g: M.weighted_bce_with_logits_loss(p, g), "logits", "gt", False),
    "ohem_bce_masked": (
        lambda M, p, g, m: M.weighted_bce_with_logits_loss(p, g, m, negative_ratio=2.0),
        "logits", "gt", True,
    ),
    "focal": (lambda M, p, g: M.focal_with_logits_loss(p, g), "logits", "gt", False),
    "focal_masked": (lambda M, p, g, m: M.focal_with_logits_loss(p, g, m), "logits", "soft", True),
    "dice": (lambda M, p, g: M.dice_loss(p, g), "prob", "gt", False),
    "dice_masked": (lambda M, p, g, m: M.dice_loss(p, g, m), "prob", "gt", True),
    "l1": (lambda M, p, g: M.l1_loss(p, g), "values", "soft", False),
    "smooth_l1_masked": (
        lambda M, p, g, m: M.l1_loss(p, g, m, smooth=True, smooth_beta=0.25), "values", "soft", True,
    ),
    "smooth_l1_beta_2_5": (lambda M, p, g: M.l1_loss(p, g, smooth=True, smooth_beta=2.5), "values", "soft", False),
    "l2": (lambda M, p, g: M.l2_loss(p, g), "prob", "soft", False),
    "l2_masked": (lambda M, p, g, m: M.l2_loss(p, g, m), "prob", "soft", True),
    "wahr": (lambda M, p, g: M.wahr_loss(p, g), "prob", "soft", False),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_matches_jax(name):
    fn, pred_key, gt_key, masked = PRIMITIVES[name]
    logits, prob, gt, soft, mask, values = _maps(1)
    arrays = {"logits": logits, "prob": prob, "gt": gt, "soft": soft, "values": values}
    others = [arrays[gt_key]] + ([mask] if masked else [])
    _check(lambda *a: fn(JP, *a), lambda *a: fn(TP, *a), [arrays[pred_key]], others)


@pytest.mark.parametrize("class_axis", [1, 2])
def test_soft_cross_entropy_matches_jax(class_axis):
    rng = np.random.default_rng(2)
    pred = rng.standard_normal((B, P, 4)).astype(np.float32) * 2
    gt = rng.dirichlet(np.ones(pred.shape[class_axis]), size=B * (P * 4 // pred.shape[class_axis]))
    gt = np.moveaxis(gt.reshape(B, -1, pred.shape[class_axis]), -1, class_axis).astype(np.float32)
    _check(
        lambda p, g: JP.cross_entropy_with_logits_loss(p, g, class_axis=class_axis),
        lambda p, g: TP.cross_entropy_with_logits_loss(p, g, class_axis=class_axis),
        [pred], [gt],
    )


CORE = (2, 13, 2, 13)


def _rough_inputs(seed):
    rng = np.random.default_rng(seed)
    ch = CORE[1] + 1 - CORE[0]
    mask_logits = (rng.standard_normal((B, H, W, 1)) * 2).astype(np.float32)
    # Heights on both sides of the 1.1 floor.
    height = np.log1p(np.exp(rng.standard_normal((B, H, W, 1)) * 2 + 1)).astype(np.float32)
    mask = (rng.uniform(size=(B, ch, ch)) > 0.5).astype(np.float32)
    score = rng.uniform(0, 10, (B, ch, ch)).astype(np.float32)
    return [mask_logits, height], [mask, score]


@pytest.mark.parametrize("bce_factor", [0.0, 1.0])
def test_rough_loss_matches_jax(bce_factor):
    preds, others = _rough_inputs(3)
    jc = JA.AdaptiveScalingRoughLossConfig(bce_factor=bce_factor)
    tc = TA.AdaptiveScalingRoughLossConfig(bce_factor=bce_factor)
    _check(
        lambda m, h, dm, s: JA.rough_loss(m, h, dm, s, JA.CoreBox(*CORE), jc),
        lambda m, h, dm, s: TA.rough_loss(m, h, dm, s, TA.CoreBox(*CORE), tc),
        preds, others,
    )


def _precise_inputs(seed, mask_head):
    rng = np.random.default_rng(seed)
    ch = CORE[1] + 1 - CORE[0]
    preds = [
        rng.standard_normal((B, H, W, 1)).astype(np.float32) * 2,
        rng.standard_normal((B, H, W, 2)).astype(np.float32) * 3,
        rng.standard_normal((B, H, W, 4)).astype(np.float32),
        np.log1p(np.exp(rng.standard_normal((B, H, W, 4)) * 2 + 1)).astype(np.float32),
    ]
    if mask_head:
        preds.append(rng.standard_normal((B, H, W, 1)).astype(np.float32))
    ys = rng.integers(0, H, (B, P)).astype(np.int32)
    xs = rng.integers(0, W, (B, P)).astype(np.int32)
    ys[:, 1], xs[:, 1] = ys[:, 0], xs[:, 0]  # a repeated point
    others = [
        rng.uniform(0, 1, (B, ch, ch)).astype(np.float32),
        (rng.uniform(size=(B, ch, ch)) > 0.5).astype(np.float32),
        ys, xs,
        rng.uniform(-4, 4, (B, P, 2)).astype(np.float32),
        rng.dirichlet(np.ones(4), size=(B, P)).astype(np.float32),
        rng.uniform(0, 10, (B, P, 3)).astype(np.float32),
    ]
    return preds, others


@pytest.mark.parametrize("mask_head", [False, True])
def test_precise_loss_matches_jax(mask_head):
    preds, others = _precise_inputs(4, mask_head)
    kw = dict(char_mask_focal_factor=1.0, char_prob_l1_factor=0.5, char_prob_wahr_factor=0.5) if mask_head else {}
    jc, tc = JA.AdaptiveScalingPreciseLossConfig(**kw), TA.AdaptiveScalingPreciseLossConfig(**kw)

    def call(mod, cfg, prob, off, ang, dist, *rest):
        mask_feat = rest[0] if mask_head else None
        score, mask, ys, xs, offs, angs, dists = rest[-7:]
        return mod.precise_loss(
            prob, off, ang, dist, score, mask, mod.CoreBox(*CORE), ys, xs, offs, angs, dists, cfg,
            precise_char_mask_feature=mask_feat,
        )

    _check(lambda *a: call(JA, jc, *a), lambda *a: call(TA, tc, *a), preds, others)


def test_label_point_gather_accumulates_repeated_points():
    feature = torch.zeros(1, 4, 4, 2, requires_grad=True)
    ys, xs = torch.tensor([[1, 1, 2]]), torch.tensor([[3, 3, 0]])
    TA.get_label_point_feature(feature, ys, xs).sum().backward()
    assert feature.grad[0, 1, 3].tolist() == [2.0, 2.0]
    assert feature.grad[0, 2, 0].tolist() == [1.0, 1.0]
    assert float(feature.grad.sum()) == 6.0
