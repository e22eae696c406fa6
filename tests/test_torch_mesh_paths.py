"""The port's mesh on the CPU beyond the step's parity with JAX
(``tests/test_torch_mesh.py``), over gloo ranks in fresh processes
(``tests/fixtures/torch_port/mesh_workers.py``):

  (d) two steps on a 2-rank mesh with the drop-path masks from the
      generator: the parameters equal on both ranks bit for bit, and the
      losses and grad norms those of the single-process port step within
      1e-5 relative;
  (e) the helpers at world size 4: ``local_batch_size``,
      ``per_process_seed``, ``shard_batch`` against ``assemble_batch``
      (as ``tests/test_training.py::test_local_batch_size_and_seed_helpers``
      and ``test_assemble_batch_matches_shard_batch``), ``replicate``;
  (f) ``BatchedAdaptiveScalingInference(engine, mesh=...).detect_many`` on
      2 ranks, with the overfit micro fixture, over three 384x384 text pages
      (one group, padded to 4: 2 rows a rank) and a blank 100x700 page (its
      own group, padded to 2): every rank returns every page's results,
      those of the mesh-less ``detect_many`` (the same rough mask, the same
      polygon count, points within 1e-3, the bar of
      ``tests/test_batch_inference.py::test_detect_many_on_mesh`` and
      ``tests/test_torch_batch.py``);
  (g) ``train(use_mesh=True)`` on the micro configs of
      ``tests/test_torch_loop.py``: over 2 ranks each rank's train batches
      are those of the single-process dataset at ``seed + 7919 * rank``
      (``batch_checksum``), its losses finite and equal on both ranks, and
      rank 0 alone writes the run folder; at world size 1 the losses, the
      batches and the checkpoint equal ``use_mesh=False``'s bit for bit.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_port"))

from mesh_workers import run_group  # noqa: E402
from test_detection_quality import FIXTURE, MODEL_SPEC, PAGE_SPEC  # noqa: E402

from adascale.data.synth import generate_page  # noqa: E402
from adascale_torch import AdaptiveScalingConfig, AdaptiveScalingInference  # noqa: E402
from adascale_torch import AdaptiveScalingInferenceConfig  # noqa: E402
from adascale_torch.data.dataset import AdaptiveScalingDatasetConfig, AdaptiveScalingIterableDataset  # noqa: E402
from adascale_torch.data.dataset import collate_samples  # noqa: E402
from adascale_torch.inference.batch import BatchedAdaptiveScalingInference  # noqa: E402
from adascale_torch.losses import CoreBox  # noqa: E402
from adascale_torch.models.adaptive_scaling import AdaptiveScaling  # noqa: E402
from adascale_torch.training import OptimizerConfig, TrainStepConfig, batch_checksum  # noqa: E402
from adascale_torch.training import build_optimizer, make_train_step, seeded_batches  # noqa: E402
from adascale_torch.training.loop import _clean_batch, _pull_pairs  # noqa: E402
from adascale_torch.utils.params import load_params  # noqa: E402

SPEC = MODEL_SPEC.custom_block_channels_and_num_layers
STEPS = dict(
    page=dict(
        page_height=192, page_width=192, num_lines_min=3, num_lines_max=5, char_height_min=10,
        char_height_max=24, render_backend="native",
    ),
    rough_crop_size=96, rough_core_margin=4, precise_crop_size=64, precise_core_margin=2,
    rough_samples_per_page=2, precise_samples_per_page=2,
)
EPOCH = dict(
    num_epochs=1, train_num_batches=2, train_batch_size=4, train_num_processes=0, dev_num_batches=1,
    dev_batch_size=2, dev_num_processes=0, num_page_char_regression_labels=8, avg_num_batches=4,
)
TRAIN_SEED = 7
MICRO_SPEC = [[8, 1], [16, 1], [32, 1], [64, 1]]
STEP_SPEC = tuple(map(tuple, MICRO_SPEC))
STEP_TOL = 1e-5


def _batches(seed):
    return seeded_batches(seed, 4, rough_size=32, precise_size=32, num_points=8, rough_core_margin=2,
                          precise_core_margin=1)


BOXES = tuple(tuple(b) for b in _batches(0)[2:])


@pytest.fixture(scope="module")
def micro_state():
    torch.manual_seed(0)
    model = AdaptiveScaling(AdaptiveScalingConfig(custom_block_channels_and_num_layers=STEP_SPEC))
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def test_detect_many_on_a_two_rank_mesh(tmp_path):
    pages = [generate_page(PAGE_SPEC, np.random.default_rng([42, k])).image for k in range(3)]
    pages.append(np.zeros((100, 700, 3), np.uint8))
    model = AdaptiveScalingConfig(custom_block_channels_and_num_layers=SPEC)
    engine = AdaptiveScalingInference(AdaptiveScalingInferenceConfig(model=model, device="cpu"),
                                      params=load_params(FIXTURE, model))
    want = BatchedAdaptiveScalingInference(engine).detect_many(pages)
    ranks = run_group("detect_many", 2, tmp_path, {"spec": SPEC, "params": FIXTURE, "pages": pages})
    assert sum(len(r["char_polygons"]) for r in want[:3]) > 0
    for got in ranks:
        assert len(got) == len(pages)
        for res, ref in zip(got, want):
            np.testing.assert_array_equal(res["mask"], ref["rough"].rough_char_mask)
            assert len(res["points"]) == len(ref["char_polygons"])
            for a, b in zip(res["points"], ref["char_polygons"]):
                np.testing.assert_allclose(a, b.points, atol=1e-3)


def test_pad_batch_is_a_multiple_of_the_mesh():
    pad = BatchedAdaptiveScalingInference._pad_batch
    assert [pad(n) for n in (1, 3, 4, 5)] == [1, 4, 4, 8]
    assert [pad(n, 4) for n in (1, 3, 4, 5)] == [4, 4, 4, 8]
    assert [pad(n, 3) for n in (1, 2, 4, 5)] == [3, 3, 6, 9]


def _configs(folder):
    os.makedirs(folder, exist_ok=True)

    def write(name, obj):
        path = os.path.join(folder, name)
        with open(path, "w") as f:
            json.dump(obj, f)
        return path

    steps = write("steps.json", STEPS)
    return dict(
        dataset_config_json=write("dataset.json", {
            "train_adaptive_scaling_dataset_steps_jsons": [steps], "train_rng_seeds": [TRAIN_SEED],
            "epoch_indices": [0], "dev_adaptive_scaling_dataset_steps_json": steps,
        }),
        epoch_config_json=write("epoch.json", EPOCH),
        model_config_json=write("model.json", {
            "size": "tiny", "neck_head_type": "fpn", "custom_block_channels_and_num_layers": MICRO_SPEC,
        }),
    )


def _expected_checksums(rows: int, seed: int):
    """The train batches of the single-process dataset at ``seed``, ``rows``
    pairs a batch, as the loop hands them to the step."""
    dataset = AdaptiveScalingIterableDataset(AdaptiveScalingDatasetConfig(
        steps_json=json.dumps(STEPS), num_page_char_regression_labels=EPOCH["num_page_char_regression_labels"],
        num_samples=rows * EPOCH["train_num_batches"], rng_seed=seed, num_processes=0, num_cached_runs=3,
    ))
    out, it = [], iter(dataset)
    try:
        for _ in range(EPOCH["train_num_batches"]):
            pairs, it = _pull_pairs(dataset, it, rows)
            batch = collate_samples(pairs)
            out.append(batch_checksum(_clean_batch(batch["rough"]), _clean_batch(batch["precise"])))
    finally:
        dataset.pool.cleanup()
    return out


def test_train_on_a_two_rank_mesh(tmp_path):
    configs = _configs(str(tmp_path / "configs"))
    folder = str(tmp_path / "runs")
    ranks = run_group("loop", 2, tmp_path / "group", {"configs": configs, "folder": folder})
    rows = EPOCH["train_batch_size"] // 2
    for rank, out in enumerate(ranks):
        assert out["mesh"]["checksums"] == _expected_checksums(rows, TRAIN_SEED + 7919 * rank), rank
        metrics = out["mesh"]["metrics"]
        losses = [metrics["dev_rough_loss"], metrics["dev_precise_loss"]]
        losses += [metrics["epochs"][0]["train_rough_loss"], metrics["epochs"][0]["train_precise_loss"]]
        assert all(np.isfinite(losses)), losses
    a, b = (out["mesh"]["metrics"] for out in ranks)
    assert a["dev_loss"] == b["dev_loss"]
    assert a["epochs"][0]["train_rough_loss"] == b["epochs"][0]["train_rough_loss"]
    assert a["epochs"][0]["checkpoint"] == b["epochs"][0]["checkpoint"]
    assert os.path.basename(a["epochs"][0]["checkpoint"]) in ranks[0]["mesh"]["files"]
    assert "log.txt" in ranks[0]["mesh"]["files"]


def test_train_on_a_one_rank_mesh_equals_the_plain_loop(tmp_path):
    configs = _configs(str(tmp_path / "configs"))
    folder = str(tmp_path / "runs")
    (out,) = run_group("loop", 1, tmp_path / "group", {"configs": configs, "folder": folder, "plain_too": True})
    plain, mesh = out["plain"], out["mesh"]
    assert mesh["checksums"] == plain["checksums"] == _expected_checksums(EPOCH["train_batch_size"], TRAIN_SEED)
    for key in ("dev_rough_loss", "dev_precise_loss", "dev_loss"):
        assert mesh["metrics"][key] == plain["metrics"][key], key
    for key in ("train_rough_loss", "train_precise_loss", "lr_next_step"):
        assert mesh["metrics"]["epochs"][0][key] == plain["metrics"]["epochs"][0][key], key
    assert mesh["files"] == plain["files"]
    saved = [torch.load(os.path.join(folder, label, "state_0"), weights_only=True) for label in ("plain", "mesh")]
    for k, v in saved[0]["params"].items():
        assert torch.equal(saved[1]["params"][k], v), k
    for which in ("mu", "nu"):
        for k, v in saved[0]["opt_state"][which].items():
            assert torch.equal(saved[1]["opt_state"][which][k], v), (which, k)


def test_two_mesh_steps_keep_the_ranks_equal(micro_state, tmp_path):
    batches = [_batches(4)[:2], _batches(5)[:2]]
    payload = dict(spec=STEP_SPEC, state=micro_state, rough_box=BOXES[0], precise_box=BOXES[1], batches=batches,
                   seed=9)
    ranks = run_group("step", 2, tmp_path, payload)
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]

    tm = AdaptiveScaling(AdaptiveScalingConfig(custom_block_channels_and_num_layers=STEP_SPEC))
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in micro_state.items()})
    opt, _ = build_optimizer(dict(tm.named_parameters()), OptimizerConfig(), steps_per_epoch=10)
    step = make_train_step(tm, opt, TrainStepConfig(rough_core_box=CoreBox(*BOXES[0]), precise_core_box=CoreBox(*BOXES[1])),
                           device="cpu")
    gen = torch.Generator().manual_seed(9)
    for (rough, precise), got in zip(batches, ranks[0]["metrics"]):
        want = {k: float(v) for k, v in step(rough, precise, gen).items()}
        for k, v in want.items():
            assert abs(got[k] - v) <= STEP_TOL * abs(v), (k, got[k], v)


def test_helpers_at_world_size_four(tmp_path):
    rng = np.random.default_rng(0)
    batch = {
        "image": rng.uniform(0, 255, (8, 16, 16, 3)).astype(np.float32),
        "mask": (rng.uniform(size=(8, 8, 8)) > 0.5).astype(np.uint8),
    }
    ranks = run_group("helpers", 4, tmp_path, {"batch": batch})
    for rank, out in enumerate(ranks):
        assert out["rank"] == rank and out["size"] == 4
        assert out["local_8"] == 2 and "not divisible" in out["local_6"]
        assert out["seed"] == 13371 + 7919 * rank
        assert out["equal"]
        for k, v in batch.items():
            np.testing.assert_array_equal(out["sharded"][k], v[2 * rank : 2 * rank + 2])
        np.testing.assert_array_equal(out["replicated"][0], np.zeros(3, np.float32))
        np.testing.assert_array_equal(out["replicated"][1], np.full((2, 2), 10.0, np.float32))
    # The ranks' rows, stacked in rank order, are the global batch.
    for k, v in batch.items():
        np.testing.assert_array_equal(np.concatenate([out["sharded"][k] for out in ranks]), v)
