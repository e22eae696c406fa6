"""The port's evaluation tools against their JAX twins on the CPU:
``tools/eval_checkpoint.py`` (``find_latest_checkpoint``,
``shift_page_config``, ``evaluate``), ``tools/tiled_recall.py``
(``evaluate_tiled_recall``) and ``tools/battery.py``, on the overfit micro
fixture (tests/fixtures/overfit_micro_params.npz). The port draws the JAX
package's pages (its "python" render backend), so the tools see the same
pages; each rate may differ by EVAL_TOL, where a bf16 rounding that another
summation order flips moves a polygon."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_detection_quality import FIXTURE, MODEL_SPEC, _load_fixture_params  # noqa: E402

import adascale.inference.engine as jax_engine  # noqa: E402
import adascale.training.loop as jax_loop  # noqa: E402
from adascale.data.synth import SynthPageConfig as JaxPageConfig  # noqa: E402
from adascale.tools import eval_checkpoint as jax_eval  # noqa: E402
from adascale.tools import tiled_recall as jax_tiled  # noqa: E402
from adascale_torch.data.synth import SynthPageConfig  # noqa: E402
from adascale_torch.tools import eval_checkpoint, tiled_recall  # noqa: E402
from adascale_torch.tools.battery import run_battery  # noqa: E402

EVAL_TOL = 0.02
RATES = ("char_precision", "char_recall", "char_f1", "rough_mask_miou", "direct_char_precision",
         "direct_char_recall", "direct_char_f1")


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model_json(tmp_path_factory):
    path = tmp_path_factory.mktemp("model") / "model.json"
    path.write_text(json.dumps({
        "size": "tiny", "neck_head_type": "fpn",
        "custom_block_channels_and_num_layers": [list(t) for t in MODEL_SPEC.custom_block_channels_and_num_layers],
    }))
    return str(path)


def test_shift_page_config_matches_jax_field_for_field():
    want = dataclasses.asdict(jax_eval.shift_page_config(JaxPageConfig(page_height=768, page_width=768)))
    got = dataclasses.asdict(eval_checkpoint.shift_page_config(SynthPageConfig(page_height=768, page_width=768)))
    assert set(want) <= set(got), sorted(set(want) - set(got))
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("names", [
    ["state_0", "state_1_not_best", "state_2_not_best", "state_2", "state_10_not_best", "state_x", "notes"],
    ["state_3", "state_3_not_best", "state_1"],
    ["state_4_not_best", "state_2"],
    ["state_0"],
], ids=["latest_not_best", "tie_prefers_best", "only_not_best_latest", "one"])
def test_find_latest_checkpoint_matches_jax(tmp_path, names):
    """From a tree of ``state_<N>`` and ``state_<N>_not_best`` names (the
    JAX package's checkpoint folders, the port's checkpoint files: both
    kinds here), both tools pick the same one."""
    for k, name in enumerate(names):
        if k % 2:
            (tmp_path / name).mkdir()
        else:
            (tmp_path / name).write_text("")
    assert eval_checkpoint.find_latest_checkpoint(str(tmp_path)) == jax_eval.find_latest_checkpoint(str(tmp_path))


def test_find_latest_checkpoint_raises_on_an_empty_run(tmp_path):
    with pytest.raises(FileNotFoundError, match="no state_<N>"):
        eval_checkpoint.find_latest_checkpoint(str(tmp_path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_evaluate_matches_jax(model_json, dtype):
    """``evaluate`` of the micro fixture's .npz on 2 small pages: the JAX
    dict's keys, each rate within EVAL_TOL; bf16 at "default" on both
    sides."""
    kwargs = dict(num_pages=2, page_size=384, compute_dtype=dtype)
    want = jax_eval.evaluate(FIXTURE, model_json, **kwargs)
    got = eval_checkpoint.evaluate(FIXTURE, model_json, device="cpu", **kwargs)
    print(f"{dtype}: jax {json.dumps(want)}\nport {json.dumps(got)}")
    assert set(got) == set(want)
    for key in RATES:
        assert abs(got[key] - want[key]) <= EVAL_TOL, (key, got[key], want[key])


def test_evaluate_tiled_recall_matches_jax(model_json, monkeypatch, tmp_path):
    """``evaluate_tiled_recall`` on one 768 page of the micro model's char
    heights, resized and tiled, against the JAX tool's numbers (its
    checkpoint export handed the fixture's parameters)."""
    params = _load_fixture_params()
    monkeypatch.setattr(jax_loop, "export_inference_artifact", lambda *a: str(tmp_path))
    monkeypatch.setattr(jax_engine, "load_params", lambda *a: params)
    kwargs = dict(num_pages=1, page_size=768, char_min=20, char_max=36)
    want = jax_tiled.evaluate_tiled_recall("checkpoint", model_json, **kwargs)
    got = tiled_recall.evaluate_tiled_recall(FIXTURE, model_json, device="cpu", **kwargs)
    print(f"jax {json.dumps(want)}\nport {json.dumps(got)}")
    assert {k: got[k] for k in ("num_pages", "page_size", "char_height_range", "total_gt_chars")} == {
        k: want[k] for k in ("num_pages", "page_size", "char_height_range", "total_gt_chars")}
    for setting in ("resized_720", "tiled_full_res"):
        for key, value in want[setting].items():
            assert abs(got[setting][key] - value) <= EVAL_TOL, (setting, key, got[setting], want[setting])


def test_match_polygons_rasterises_only_touching_boxes():
    """``match_polygons`` computes the IoU of the pairs whose bounding boxes
    touch only (every other pair's IoU is 0): the same matches as the IoU
    of every pair, on the flagship reference's polygons against page_0's
    ground truth and against themselves moved a little."""
    import numpy as np

    from adascale_torch.data.geometry import Polygon
    from adascale_torch.inference.eval import match_polygons, polygon_iou

    def every_pair(preds, gts, thr):
        candidates = sorted(((polygon_iou(p, g), i, j) for i, p in enumerate(preds) for j, g in enumerate(gts)
                             if polygon_iou(p, g) >= thr), reverse=True)
        used_p, used_g, out = set(), set(), []
        for iou, i, j in candidates:
            if i not in used_p and j not in used_g:
                used_p.add(i)
                used_g.add(j)
                out.append((i, j, iou))
        return out

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
    ref = np.load(os.path.join(fixtures, "torch_port", "flagship_fpn_reference.npz"))
    polys = [Polygon(p) for p in ref["char_polygons"][:60]]
    gts = [Polygon(np.asarray(c, np.float32)) for c in np.load(os.path.join(fixtures, "shift_pages", "page_0.npz"))["corners"]]
    rng = np.random.default_rng(0)
    moved = [Polygon(p.points + rng.normal(0, 3, p.points.shape).astype(np.float32)) for p in polys]
    for preds, targets, thr in ((polys, gts, 0.5), (moved, polys, 0.3)):
        got = match_polygons(preds, targets, thr)
        assert got and got == every_pair(preds, targets, thr)


# ------------------------------------------------------------------ battery


def _write_spec(tmp_path: Path, steps) -> Path:
    p = tmp_path / "battery.json"
    p.write_text(json.dumps({"logdir": "logs", "steps": steps}))
    return p


def test_stub_battery_manifest_and_logs(tmp_path):
    """A step that imports the port in a child (the runner sets its
    PYTHONPATH) and one that fails: both logged, the manifest on disk."""
    spec = _write_spec(tmp_path, [
        {"name": "import_check", "module": "adascale_torch.tools.battery", "args": ["--help"], "timeout": 60},
        {"name": "boom", "module": "adascale_torch._no_such_module_", "timeout": 60},
    ])
    manifest = run_battery(spec)
    assert manifest["ok"] is False
    by_name = {s["name"]: s for s in manifest["steps"]}
    assert by_name["import_check"]["rc"] == 0
    assert by_name["boom"]["rc"] != 0
    logdir = tmp_path / "logs"
    assert (logdir / "import_check.log").exists()
    assert (logdir / "boom.log").exists()
    assert json.loads((logdir / "battery_manifest.json").read_text())["ok"] is False


def test_battery_resume_skips_ok_steps(tmp_path):
    spec = _write_spec(tmp_path, [
        {"name": "once", "module": "adascale_torch.tools.battery", "args": ["--help"], "timeout": 60},
    ])
    assert run_battery(spec)["ok"] is True
    stamp = (tmp_path / "logs" / "once.log").stat().st_mtime_ns
    assert run_battery(spec)["ok"] is True  # resumed: the ok step does not run again
    assert (tmp_path / "logs" / "once.log").stat().st_mtime_ns == stamp


def test_battery_cli_exit_code(tmp_path):
    spec = _write_spec(tmp_path, [{"name": "fails", "module": "adascale_torch._no_such_module_", "timeout": 60}])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "adascale_torch.tools.battery", "--spec", str(spec)],
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          capture_output=True, text=True, env=env)
    assert proc.returncode == 1
    assert '"battery_ok": false' in proc.stdout
