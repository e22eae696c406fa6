"""The port's command line (``python -m adascale_torch``) against the JAX
package's (``adascale/cli.py``), on the CPU.

``detect`` on the overfit micro fixture and page [42, 0] of the
detection-quality spec, written as a PNG by OpenCV: the port's JSON against
the JAX CLI's on the same ``.npz`` and PNG, char polygons matched one to one
at IoU >= 0.5, >= 95 % both ways (the port's engine bar; the two engines
compute the same function in f32, so the measured share is printed).
``export`` of an orbax directory raises, naming its ROADMAP item; ``train
--mesh`` runs at world size 1 on the micro model (``train`` and ``export``
themselves: ``tests/test_torch_loop.py``), and so does ``demo`` (its images
against the JAX demo's: ``tests/test_torch_demo.py``).
"""
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_detection_quality import FIXTURE, MODEL_SPEC, PAGE_SPEC  # noqa: E402

from adascale.cli import main as jax_cli_main  # noqa: E402
from adascale.data.synth import SynthPageConfig, generate_page  # noqa: E402
from adascale.tools.export_params import flatten_params  # noqa: E402
from adascale.utils.config import config_to_dict as jax_config_to_dict  # noqa: E402
from adascale_torch.cli import main as cli_main  # noqa: E402
from adascale_torch.data.geometry import Polygon  # noqa: E402
from adascale_torch.inference.demo import STEMS as DEMO_STEMS  # noqa: E402
from adascale_torch.inference.eval import match_polygons  # noqa: E402
from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig  # noqa: E402
from adascale_torch.models.adaptive_scaling import init_like_flax_  # noqa: E402
from adascale_torch.utils.params import jax_from_state_dict  # noqa: E402
from adascale_torch.utils.png import write_png  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLYGON_BAR = 0.95
MICRO_SPEC = ((8, 1), (16, 1), (32, 1), (64, 1))


def test_detect_cli_matches_the_jax_cli(tmp_path):
    page = generate_page(PAGE_SPEC, np.random.default_rng([42, 0]))
    image_path = str(tmp_path / "page.png")
    assert cv2.imwrite(image_path, page.image[:, :, ::-1])
    model_json = tmp_path / "model.json"
    model_json.write_text(json.dumps(jax_config_to_dict(MODEL_SPEC)))
    args = ["detect", "--checkpoint", FIXTURE, "--image", image_path, "--model-config", str(model_json)]

    jax_json = str(tmp_path / "jax.json")
    jax_cli_main(args + ["--output", jax_json])
    port_json = str(tmp_path / "port.json")
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "adascale_torch", *args, "--output", port_json, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]

    want, got = (json.loads(open(p).read()) for p in (jax_json, port_json))
    assert set(got) == {"num_chars", "char_polygons"} and got["num_chars"] == len(got["char_polygons"])
    theirs = [Polygon(np.asarray(p)) for p in want["char_polygons"]]
    ours = [Polygon(np.asarray(p)) for p in got["char_polygons"]]
    matched = len(match_polygons(ours, theirs, 0.5))
    print(f"detect CLI: port {len(ours)}, JAX {len(theirs)}, matched@0.5 {matched}")
    assert len(theirs) > 50
    assert matched >= POLYGON_BAR * len(theirs) and matched >= POLYGON_BAR * len(ours)


MICRO_STEPS = dict(
    page=dict(page_height=128, page_width=128, num_lines_min=2, num_lines_max=3, char_height_min=10,
              char_height_max=20),
    rough_crop_size=64, rough_core_margin=2, precise_crop_size=64, precise_core_margin=2,
    rough_samples_per_page=2, precise_samples_per_page=2,
)
MICRO_EPOCH = dict(num_epochs=1, train_num_batches=1, train_batch_size=2, train_num_processes=0, dev_num_batches=1,
                   dev_batch_size=2, dev_num_processes=0, num_page_char_regression_labels=8)


def _micro_train_configs(folder):
    paths = {}
    for name, obj in (("steps", MICRO_STEPS), ("epoch", MICRO_EPOCH),
                      ("model", {"custom_block_channels_and_num_layers": [[8, 1], [16, 1], [32, 1], [64, 1]]})):
        paths[name] = str(folder / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    paths["dataset"] = str(folder / "dataset.json")
    with open(paths["dataset"], "w") as f:
        json.dump({"train_adaptive_scaling_dataset_steps_jsons": [paths["steps"]],
                   "dev_adaptive_scaling_dataset_steps_json": paths["steps"]}, f)
    return ["--dataset-config", paths["dataset"], "--epoch-config", paths["epoch"], "--model-config",
            paths["model"]]


def _micro_demo_inputs(folder):
    """``--config`` (the micro model at a seeded init, as an ``.npz``) and
    ``--image`` (a 192x192 synth page as PNG) for ``demo``."""
    model = AdaptiveScaling(AdaptiveScalingConfig(custom_block_channels_and_num_layers=MICRO_SPEC))
    init_like_flax_(model, torch.Generator().manual_seed(0))
    weights = str(folder / "micro.npz")
    np.savez(weights, **flatten_params(jax_from_state_dict(model.state_dict())))
    config = folder / "infer.json"
    config.write_text(json.dumps({"checkpoint": weights, "model": {"custom_block_channels_and_num_layers": MICRO_SPEC}}))
    page = generate_page(SynthPageConfig(page_height=192, page_width=192, num_lines_min=2, num_lines_max=3),
                         np.random.default_rng(2))
    image = str(folder / "page.png")
    write_png(image, page.image)
    return ["--config", str(config), "--image", image]


@pytest.mark.parametrize(
    "argv,item",
    [
        # train and export are ported (tests/test_torch_loop.py): train
        # --mesh runs (at world size 1 here; under torchrun,
        # tests/test_torch_mesh_paths.py and chip_smoke.py); an orbax
        # checkpoint directory raises; demo runs on the micro model.
        (["train", "--output", "{tmp}/out", "--mesh", "--device", "cpu"], None),
        (["export", "--checkpoint", "{tmp}", "--output", "{tmp}/out"], "item 9.3"),
        (["demo", "--output", "{tmp}/out", "--device", "cpu"], None),
    ],
    ids=["train", "export", "demo"],
)
def test_commands_run_or_raise_naming_their_item(argv, item, tmp_path, capsys):
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    if argv[0] == "demo":
        cli_main(argv + _micro_demo_inputs(tmp_path))
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed["num_chars"] >= 0 and printed["output"] == str(tmp_path / "out")
        assert sorted(os.listdir(tmp_path / "out")) == sorted(f"{stem}.png" for stem in DEMO_STEMS)
        return
    if item is None:
        # train --mesh on the micro model and the "python" render backend
        # (the steps JSON has no render_backend).
        cli_main(argv + _micro_train_configs(tmp_path))
        metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isfinite(metrics["dev_loss"])
        assert (tmp_path / "out" / "state_0").exists()
        return
    with pytest.raises(NotImplementedError, match=item):
        cli_main(argv)
    assert not (tmp_path / "out").exists()
