"""Workers of the port's CPU mesh tests (``tests/test_torch_mesh.py``).

Each rank runs in a fresh interpreter that imports torch and
``adascale_torch`` only, never JAX or a test module:

    python mesh_workers.py TASK RANK WORLD STORE INPUT OUTPUT

joins a gloo group of WORLD ranks through a ``FileStore`` at STORE (no TCP
port, so parallel test workers cannot meet each other), runs TASK on the
pickled INPUT and pickles its result to OUTPUT. ``run_group`` starts the
ranks from a test and waits for them with a time limit: a rank that hangs in
a collective is killed with its group, and the test fails with each rank's
output.
"""
from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
INIT_TIMEOUT_S = 60


def run_group(task: str, world: int, folder, payload, timeout: float = 120.0) -> list:
    """Runs ``task`` on ``world`` gloo ranks in ``folder`` (a fresh directory);
    returns the ranks' results in rank order."""
    folder = str(folder)
    os.makedirs(folder, exist_ok=True)
    store, inp = os.path.join(folder, "store"), os.path.join(folder, "input.pkl")
    with open(inp, "wb") as f:
        pickle.dump(payload, f)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(folder, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, str(rank), str(world), store, inp,
             os.path.join(folder, f"out{rank}.pkl")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
        ))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
        for p in procs:
            p.wait()
    text = []
    for rank, log in enumerate(logs):
        log.seek(0)
        text.append(f"--- rank {rank} (rc {procs[rank].returncode}) ---\n{log.read()[-4000:]}")
        log.close()
    if hung:
        raise AssertionError(f"{task}: {len(hung)} ranks hung past {timeout} s and were killed\n" + "\n".join(text))
    if any(p.returncode for p in procs):
        raise AssertionError(f"{task}: a rank failed\n" + "\n".join(text))
    out = []
    for rank in range(world):
        with open(os.path.join(folder, f"out{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# --------------------------------------------------------------------- tasks


def _model(spec, state):
    import torch

    from adascale_torch.models.adaptive_scaling import AdaptiveScaling, AdaptiveScalingConfig

    model = AdaptiveScaling(AdaptiveScalingConfig(custom_block_channels_and_num_layers=spec))
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model


def _mesh(payload):
    from adascale_torch.parallel import create_hybrid_mesh, create_mesh

    slices = payload.get("slices")
    return create_hybrid_mesh(slices, device="cpu") if slices else create_mesh(device="cpu")


def task_step(payload, rank, world):
    """``make_train_step(mesh=...)`` for ``len(batches)`` steps from the
    payload's parameters (rank 0's only; ``replicate`` hands them on). The
    drop-path masks are the payload's global ones where it has them, else
    the generator's. Returns each step's metrics, each step's per-rank
    losses on this rank's rows alone (what a mean of per-rank losses would
    average) and the final parameters."""
    import torch

    from adascale_torch.losses import CoreBox
    from adascale_torch.parallel import mesh_rank, replicate, shard_batch
    from adascale_torch.training import (
        OptimizerConfig, TrainStepConfig, build_optimizer, make_train_step, precise_task_loss, rough_task_loss,
        upcast_batch,
    )

    mesh = _mesh(payload)
    model = _model(payload["spec"], payload["state"] if rank == 0 else None)
    replicate(model, mesh)
    opt, _ = build_optimizer(dict(model.named_parameters()), OptimizerConfig(), steps_per_epoch=10)
    cfg = TrainStepConfig(rough_core_box=CoreBox(*payload["rough_box"]),
                          precise_core_box=CoreBox(*payload["precise_box"]))
    step = make_train_step(model, opt, cfg, device="cpu", mesh=mesh)
    masks = list(payload.get("masks") or [])
    if masks:
        def draw(batch_size, generator):
            drawn = masks.pop(0)
            assert all(m is None or len(m) == batch_size for m in drawn), batch_size
            return [None if m is None else torch.from_numpy(m.astype("float32")) for m in drawn]

        model.backbone.draw_drop_masks = draw
    gen = torch.Generator().manual_seed(payload.get("seed", 0))
    r = mesh_rank(mesh)
    metrics, local = [], []
    for rough, precise in payload["batches"]:
        rough_l, precise_l = shard_batch(rough, mesh), shard_batch(precise, mesh)
        if masks:
            b = rough_l["image"].shape[0]
            rows = [[None if m is None else torch.from_numpy(m[r * b:(r + 1) * b].astype("float32")) for m in ms]
                    for ms in masks[:2]]
            with torch.no_grad():
                local.append((
                    float(rough_task_loss(model, upcast_batch(rough_l, torch.device("cpu")), cfg, False, rows[0])),
                    float(precise_task_loss(model, upcast_batch(precise_l, torch.device("cpu")), cfg, False, rows[1])),
                ))
        out = step(rough_l, precise_l, gen)
        metrics.append({k: float(v) for k, v in out.items()})
    return {"metrics": metrics, "local": local, "rank": r,
            "params": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
            "grads": {k: v.grad.numpy().copy() for k, v in model.named_parameters()}}


def task_helpers(payload, rank, world):
    """The mesh helpers at this world size: the local batch size and seed,
    ``shard_batch`` against ``assemble_batch`` of this rank's rows, and
    ``replicate`` of a dict."""
    import torch

    from adascale_torch.parallel import (
        assemble_batch, local_batch_size, mesh_rank, mesh_size, per_process_seed, replicate, shard_batch,
    )

    mesh = _mesh(payload)
    out = {"local_8": local_batch_size(8), "seed": per_process_seed(13371), "rank": mesh_rank(mesh),
           "size": mesh_size(mesh)}
    try:
        local_batch_size(6)
        out["local_6"] = "accepted"
    except ValueError as e:
        out["local_6"] = str(e)
    batch = payload["batch"]
    n = out["local_8"]
    sharded = shard_batch(batch, mesh)
    assembled = assemble_batch({k: v[out["rank"] * n:(out["rank"] + 1) * n] for k, v in batch.items()}, mesh)
    out["sharded"] = {k: v.numpy() for k, v in sharded.items()}
    out["equal"] = all(torch.equal(sharded[k], assembled[k]) and sharded[k].dtype == assembled[k].dtype
                       for k in batch)
    state = {"a": torch.full((3,), float(rank)), "b": [torch.full((2, 2), 10.0 + rank)]}
    replicate(state, mesh)
    out["replicated"] = [state["a"].numpy(), state["b"][0].numpy()]
    return out


def task_detect_many(payload, rank, world):
    """``detect_many`` over the payload's pages on a mesh of all ranks, with
    the micro engine on the CPU; returns each page's polygons and rough
    mask."""
    from adascale_torch import BatchedAdaptiveScalingInference
    from adascale_torch.inference.engine import AdaptiveScalingInference, AdaptiveScalingInferenceConfig
    from adascale_torch.models.adaptive_scaling import AdaptiveScalingConfig
    from adascale_torch.parallel import create_mesh
    from adascale_torch.utils.params import load_params

    model = AdaptiveScalingConfig(custom_block_channels_and_num_layers=payload["spec"])
    engine = AdaptiveScalingInference(AdaptiveScalingInferenceConfig(model=model, device="cpu"),
                                      params=load_params(payload["params"], model))
    batched = BatchedAdaptiveScalingInference(engine, mesh=create_mesh(device="cpu"))
    results = batched.detect_many(payload["pages"])
    return [{"points": [p.points for p in r["char_polygons"]], "mask": r["rough"].rough_char_mask}
            for r in results]


def task_loop(payload, rank, world):
    """``train(use_mesh=True)`` on the payload's configs (at world size 1,
    ``use_mesh=False`` first, in the same process); records the checksum of
    every train batch the step is given."""
    import numpy as np

    from adascale_torch.training import batch_checksum
    from adascale_torch.training import loop

    seen = []
    make = loop.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def wrapped(rough, precise, generator):
            seen.append(batch_checksum({k: np.asarray(v) for k, v in rough.items()},
                                       {k: np.asarray(v) for k, v in precise.items()}))
            return step(rough, precise, generator)

        return wrapped

    loop.make_train_step = recording
    out = {}
    runs = [("plain", False)] if payload.get("plain_too") else []
    for label, mesh in runs + [("mesh", True)]:
        seen.clear()
        metrics = loop.train(output_folder=os.path.join(payload["folder"], label), use_mesh=mesh, device="cpu",
                             **payload["configs"])
        out[label] = {"metrics": metrics, "checksums": list(seen),
                      "files": sorted(os.listdir(os.path.join(payload["folder"], label)))
                      if os.path.isdir(os.path.join(payload["folder"], label)) else None}
    return out


TASKS = {"step": task_step, "helpers": task_helpers, "detect_many": task_detect_many, "loop": task_loop}


def main(argv):
    task, rank, world, store, inp, out = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        with open(inp, "rb") as f:
            payload = pickle.load(f)
        result = TASKS[task](payload, rank, world)
        with open(out, "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "cv2", "adascale"))
    if bad:
        raise SystemExit(f"a mesh worker imported {bad[:5]}")


if __name__ == "__main__":
    main(sys.argv[1:])
