"""Where the port and the JAX package split the precise peak pick on a blank page.

    JAX_PLATFORMS=cpu python tests/fixtures/torch_port/blank_page_ties.py

The overfit micro fixture (tests/test_detection_quality.py) fires on a blank
100x700 page, its precise probability map is near-flat, and the 5x5 peak
pick ``prob == maxfilter(prob)`` then turns on ties. This script runs the
JAX engine and the port on that page, both on the CPU, and counts the peak
pixels that differ from the JAX engine's when one part of the precise pass
(backbone, neck, head, or one op of the head) comes from the other package.
Each op of the head is also run on the other package's input to count the
elements it rounds differently. Needs both packages; prints one line per
case.
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)

from test_detection_quality import MODEL_SPEC, _load_fixture_params  # noqa: E402

from adascale.inference import AdaptiveScalingInference as JaxEngine  # noqa: E402
from adascale.inference import AdaptiveScalingInferenceConfig as JaxEngineConfig  # noqa: E402
from adascale.inference.engine import compute_padded_shape  # noqa: E402
from adascale.models.fpn import FpnHead as JaxFpnHead  # noqa: E402
from adascale.ops.fused_upsample import phase_conv3x3_after_nearest2x  # noqa: E402
from adascale_torch import (  # noqa: E402
    AdaptiveScalingConfig,
    AdaptiveScalingInference,
    AdaptiveScalingInferenceConfig,
)
from adascale_torch.inference.eval import match_polygons  # noqa: E402
from adascale_torch.ops.fused_upsample import heads_phase_form, phase_tap_weights  # noqa: E402


def main() -> None:
    torch.set_num_threads(2)
    params = _load_fixture_params()
    image = np.zeros((100, 700, 3), np.uint8)
    jax_engine = JaxEngine(JaxEngineConfig(model=MODEL_SPEC), params=params)
    want = jax_engine.detect(image)
    for fused in (False, True):
        config = AdaptiveScalingInferenceConfig(
            model=AdaptiveScalingConfig(
                custom_block_channels_and_num_layers=MODEL_SPEC.custom_block_channels_and_num_layers
            ),
            use_pallas_neck_heads=fused,
            device="cpu",
        )
        port = AdaptiveScalingInference(config, params=params)
        got = port.detect(image)
        matched = len(match_polygons(got["char_polygons"], want["char_polygons"], 0.5))
        print(
            f"detect (use_pallas_neck_heads={fused}): polygons jax {len(want['char_polygons'])} "
            f"port {len(got['char_polygons'])} matched {matched}",
            flush=True,
        )

    # The precise pass on the JAX engine's stacked image.
    cfg = jax_engine.config
    rough = jax_engine.rough_infer(image)
    stacked, _ = jax_engine.stack_flattened_text_regions(
        jax_engine.build_flattened_text_regions(image, rough)
    )
    h, w = stacked.shape[:2]
    ph, pw = compute_padded_shape(h, w, divisor=cfg.backbone_downsampling_factor, bucket=cfg.shape_bucket)
    want_peaks = jax_engine.precise_infer(stacked).precise_peak_mask.astype(bool)
    fdf = 4 // cfg.precise_head_upsampling_factor
    valid_h, valid_w = -(-h // fdf), -(-w // fdf)

    def peaks_differ(logits: np.ndarray) -> int:
        """Peak pixels that differ from the JAX engine's, picked from these
        logits as the port's engine picks them."""
        prob = torch.sigmoid(torch.from_numpy(np.asarray(logits))[0, :, :, 0])
        prob[valid_h:] = 0.0
        prob[:, valid_w:] = 0.0
        local_max = F.max_pool2d(prob[None, None], 5, stride=1, padding=2)[0, 0]
        peaks = (prob == local_max) & (prob >= cfg.precise_build_polygons_positive_char_prob_thr)
        return int((peaks.numpy() != want_peaks).sum())

    x = np.pad(stacked.astype(np.float32)[None], ((0, 0), (0, ph - h), (0, pw - w), (0, 0)))
    model = jax_engine.model
    hp = params["precise_char_prob_head"]
    head = JaxFpnHead(out_channels=1, upsampling_factor=2)

    def jit_apply(method, *args):
        with jax.default_matmul_precision(cfg.matmul_precision):
            return jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=method))(params, *args)

    feats_j = [np.array(f) for f in jit_apply(lambda m, x: tuple(m.backbone(x)), jnp.asarray(x))]
    neck_j = np.array(jit_apply(lambda m, x: m.precise_neck(m.backbone(x)), jnp.asarray(x)))
    with jax.default_matmul_precision(cfg.matmul_precision):
        logits_j, inter = jax.jit(
            lambda p, n: head.apply({"params": p}, n, capture_intermediates=True)
        )(hp, jnp.asarray(neck_j))
        conv_j = jax.jit(phase_conv3x3_after_nearest2x)(
            jnp.asarray(neck_j), hp["step1"]["conv"]["kernel"], hp["step1"]["conv"]["bias"]
        )
    inter = inter["intermediates"]
    stages_j = {
        "conv": [np.array(t) for t in conv_j],
        "LN": [np.array(t) for t in inter["step1"]["ln"]["__call__"]],
        "GELU": [np.array(t) for t in inter["step1"]["__call__"][0]],
        "Dense": [np.array(t) for t in inter["step2"]["__call__"]],
    }

    tm = port.model
    pp = dict(tm.precise_char_prob_head.named_parameters())
    ops = {
        "LN": lambda z: F.layer_norm(z, (z.shape[-1],), pp["step1.ln.weight"], pp["step1.ln.bias"], eps=1e-6),
        "GELU": lambda z: F.gelu(z, approximate="none"),
        "Dense": lambda z: F.linear(z, pp["step2.weight"], pp["step2.bias"]),
    }

    def interleave(phases):
        b, hh, ww, c = phases[0].shape
        out = np.empty((b, 2 * hh, 2 * ww, c), np.float32)
        for k, y in enumerate(phases):
            out[:, k // 2 :: 2, k % 2 :: 2] = y
        return out

    def port_from(stage: str):
        """The port's head ops after ``stage``, on the JAX head's output of it."""
        names = list(ops)[list(stages_j).index(stage) :]
        outs = []
        for z in stages_j[stage]:
            z = torch.from_numpy(z)
            for name in names:
                z = ops[name](z)
            outs.append(z.numpy())
        return interleave(outs)

    with torch.no_grad():
        feats_t = tm.backbone(torch.from_numpy(x))
        neck_t = tm.precise_neck(feats_t)
        neck_tj = tm.precise_neck([torch.from_numpy(f) for f in feats_j])
        rows = {
            "port backbone, neck and head": heads_phase_form(neck_t, [pp])[0],
            "JAX backbone; port neck and head": heads_phase_form(neck_tj, [pp])[0],
            "JAX backbone and neck; port head": heads_phase_form(torch.from_numpy(neck_j), [pp])[0],
        }
        rows = {k: v.numpy() for k, v in rows.items()}
        for stage in ("conv", "LN", "GELU"):
            rows[f"JAX head up to its {stage}; port ops after it"] = port_from(stage)
    with jax.default_matmul_precision(cfg.matmul_precision):
        rows["port backbone; JAX neck and head"] = np.asarray(jax.jit(
            lambda p, f: model.apply(
                {"params": p}, f, method=lambda m, f: m.precise_char_prob_head(m.precise_neck(list(f)))
            )
        )(params, tuple(jnp.asarray(f.numpy()) for f in feats_t)))
    rows["JAX alone, its head jitted apart from its backbone and neck"] = np.asarray(logits_j)
    print(f"precise peaks: JAX engine {int(want_peaks.sum())}", flush=True)
    for name, logits in rows.items():
        print(f"peaks that differ from the JAX engine's, {name}: {peaks_differ(logits)}", flush=True)
    print(
        f"max abs difference, port vs JAX: backbone features "
        f"{[float(np.abs(a.numpy() - b).max()) for a, b in zip(feats_t, feats_j)]}; neck on the "
        f"same features {float(np.abs(neck_tj.numpy() - neck_j).max())}",
        flush=True,
    )
    # Each head op on the JAX head's own input: elements rounded differently.
    with torch.no_grad():
        taps = phase_tap_weights(pp["step1.conv.weight"])
        xp = F.pad(torch.from_numpy(neck_j), (0, 0, 1, 1, 1, 1))
        hh, ww, c = neck_j.shape[1:]
        differ = 0
        for a in (0, 1):
            for bb in (0, 1):
                cols = torch.cat(
                    [xp[:, a + dy : a + dy + hh, bb + dx : bb + dx + ww] for dy in (0, 1) for dx in (0, 1)], -1
                )
                y = cols.reshape(-1, 4 * c) @ taps[2 * a + bb].reshape(4 * c, -1) + pp["step1.conv.bias"]
                differ += int((y.reshape(stages_j["conv"][0].shape).numpy() != stages_j["conv"][2 * a + bb]).sum())
        size = sum(t.size for t in stages_j["conv"])
        print(f"head conv on the same input: {differ} of {size} elements differ", flush=True)
        previous = "conv"
        for name, op in ops.items():
            differ = sum(
                int((op(torch.from_numpy(a)).numpy() != b).sum())
                for a, b in zip(stages_j[previous], stages_j[name])
            )
            size = sum(t.size for t in stages_j[name])
            print(f"head {name} on the same input: {differ} of {size} elements differ", flush=True)
            previous = name


if __name__ == "__main__":
    main()
