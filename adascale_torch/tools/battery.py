"""Post-training evidence battery runner.

Counterpart of ``adascale/tools/battery.py``: runs a list of
``python -m <module> <args>`` steps (the evaluation tools, typically) one
after another, so that a battery cannot be lost to its environment or to a
crash half way:

  * every step's ``PYTHONPATH`` starts with the folder that holds the
    imported ``adascale_torch`` package (if this module runs, the steps can
    import it too);
  * each step's stdout and stderr go to ``<logdir>/<name>.log`` and its
    outcome (rc, wall seconds, log path, last log line) is written to
    ``battery_manifest.json`` after every step, so a crash keeps everything
    finished so far;
  * steps that an existing manifest marks ok are skipped, so the battery
    resumes with the same command line.

The spec is a JSON file::

    {
      "logdir": "run/eval",                 # relative to the spec
      "wait_pid": null,                     # optional: wait for pid to exit
      "steps": [
        {"name": "eval_f32",
         "module": "adascale_torch.tools.eval_checkpoint",
         "args": ["--run", "run", "--model-config", "model.json"],
         "cwd": ".",                        # relative to the spec file
         "timeout": 3000}
      ]
    }

Usage:  python -m adascale_torch.tools.battery --spec battery.json
        [--wait-pid N] [--no-resume]

Prints ``{"battery_ok": ..., "failed": [...]}`` and exits 0 only if every
step is ok.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional


def _repo_pythonpath() -> str:
    """A ``PYTHONPATH`` that makes ``import adascale_torch`` work in the
    steps: the imported package's parent folder, then the caller's."""
    import adascale_torch

    pkg_root = Path(adascale_torch.__file__).resolve().parent.parent
    existing = os.environ.get("PYTHONPATH", "")
    return f"{pkg_root}{os.pathsep}{existing}" if existing else str(pkg_root)


def wait_for_pid(pid: int, poll_seconds: float = 30.0) -> None:
    """Block until ``pid`` no longer exists (the run the battery follows)."""
    while True:
        try:
            os.kill(pid, 0)
        except (ProcessLookupError, PermissionError):
            return
        time.sleep(poll_seconds)


def _load_manifest(path: Path) -> Dict[str, Any]:
    if path.exists():
        try:
            return json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            pass
    return {"steps": []}


def _ok_names(manifest: Dict[str, Any]) -> set:
    return {s["name"] for s in manifest.get("steps", []) if s.get("rc") == 0}


def run_step(step: Dict[str, Any], spec_dir: Path, logdir: Path, env: Dict[str, str]) -> Dict[str, Any]:
    """Run one step; returns its manifest record."""
    name = step["name"]
    argv = [sys.executable, "-m", step["module"], *step.get("args", [])]
    cwd = (spec_dir / step.get("cwd", ".")).resolve()
    timeout = float(step.get("timeout", 3000))
    log_path = logdir / f"{name}.log"
    started = time.time()
    rc: Optional[int] = None
    note = ""
    with open(log_path, "wb") as log:
        try:
            rc = subprocess.run(argv, cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT,
                                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc, note = -1, f"timeout after {timeout:.0f}s"
        except OSError as exc:
            rc, note = -2, f"spawn failed: {exc}"
    tail = ""
    try:
        lines = log_path.read_text(errors="replace").strip().splitlines()
        tail = lines[-1][:300] if lines else ""
    except OSError:
        pass
    return {
        "name": name,
        "argv": argv[1:],  # without the interpreter's path
        "rc": rc,
        "seconds": round(time.time() - started, 1),
        "log": str(log_path),
        "note": note,
        "tail": tail,
    }


def run_battery(spec_path: Path, wait_pid: Optional[int] = None, resume: bool = True) -> Dict[str, Any]:
    """Run the spec's steps (skipping those a manifest marks ok where
    ``resume``); returns the manifest, with ``ok`` true where every step is."""
    spec_path = Path(spec_path)
    spec = json.loads(spec_path.read_text())
    spec_dir = spec_path.resolve().parent
    logdir = (spec_dir / spec.get("logdir", "battery_logs")).resolve()
    logdir.mkdir(parents=True, exist_ok=True)
    manifest_path = logdir / "battery_manifest.json"
    manifest = _load_manifest(manifest_path) if resume else {"steps": []}
    done = _ok_names(manifest)

    pid = wait_pid if wait_pid is not None else spec.get("wait_pid")
    if pid:
        print(f"[battery] waiting for pid {pid} ...", flush=True)
        wait_for_pid(int(pid))

    env = dict(os.environ)
    env["PYTHONPATH"] = _repo_pythonpath()

    steps: List[Dict[str, Any]] = spec["steps"]
    for step in steps:
        if step["name"] in done:
            print(f"[battery] {step['name']}: already ok, skipping", flush=True)
            continue
        print(f"[battery] {step['name']}: start", flush=True)
        result = run_step(step, spec_dir, logdir, env)
        # Drop an earlier record of this step, then append.
        manifest["steps"] = [s for s in manifest["steps"] if s["name"] != result["name"]] + [result]
        manifest_path.write_text(json.dumps(manifest, indent=1))
        status = "ok" if result["rc"] == 0 else f"FAILED rc={result['rc']}"
        print(f"[battery] {step['name']}: {status} ({result['seconds']}s)", flush=True)

    ok_now = _ok_names(manifest)
    manifest["ok"] = all(step["name"] in ok_now for step in steps)
    manifest_path.write_text(json.dumps(manifest, indent=1))
    return manifest


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spec", required=True, type=Path)
    ap.add_argument("--wait-pid", type=int, default=None)
    ap.add_argument(
        "--no-resume", action="store_true",
        help="run every step again, even those an earlier manifest marked ok",
    )
    args = ap.parse_args(argv)
    manifest = run_battery(args.spec, args.wait_pid, resume=not args.no_resume)
    failed = [s["name"] for s in manifest["steps"] if s["rc"] != 0]
    print(json.dumps({"battery_ok": manifest["ok"], "failed": failed}))
    sys.exit(0 if manifest["ok"] else 1)


if __name__ == "__main__":
    main()
