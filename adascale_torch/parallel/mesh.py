"""Data parallelism over ``torch.distributed``: one process (a rank) per card.

Counterpart of ``adascale/parallel/mesh.py``. The JAX package's mesh is pure
data parallelism: a 1-D ``("data",)`` mesh (or a 2-D ``("dcn", "data")``
hybrid one), batches sharded on their leading axis, parameters and optimizer
state replicated, and XLA's SPMD partitioner inserting the collectives. Here
``torchrun`` starts one process per card, and a "process" of the JAX package
is a rank. A mesh is a ``DeviceMesh`` over the whole world:

  * the rows of a global batch are split over the flattened mesh, slice
    outermost, as the JAX package's ``batch_sharding`` splits them: rank
    ``r`` of ``W`` holds rows ``r * B / W`` to ``(r + 1) * B / W``;
  * parameters and optimizer state are replicated (``replicate`` broadcasts
    them from rank 0);
  * the train step gathers the heads' outputs and labels over the mesh
    (``gather_rows``) so that every rank computes the global batch's loss, and
    sums the gradients (``reduce_gradients``), as the JAX SPMD step does
    (``training/train_step.py``).

The process group comes from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``--standalone`` meets on
localhost), or is made at world size 1 in this process when there is none.
It runs over NCCL on the card and over gloo only where ``device="cpu"`` is
asked for; a missing card or NCCL raises, with no fall back to the CPU.
"""
from __future__ import annotations

import os
from typing import Any, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# The JAX package's per-process seed stride.
SEED_STRIDE = 7919


def _init_process_group(device: str) -> None:
    """Joins the process group ``torchrun`` describes in the environment, or
    makes one of world size 1 (an in-process store: no port, no file) when
    there is none; NCCL for ``device="cuda"`` (this rank's card is
    ``LOCAL_RANK``), gloo for ``device="cpu"``. A group that exists already
    is kept as it is."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the mesh over gloo on the CPU"
            )
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: the mesh on the card needs it")
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, device {device!r} needs {backend}")
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def create_mesh(device: str = "cuda") -> DeviceMesh:
    """1-D ``("data",)`` data-parallel mesh over every rank of the world."""
    _init_process_group(device)
    return init_device_mesh(torch.device(device).type, (dist.get_world_size(),), mesh_dim_names=("data",))


def create_hybrid_mesh(num_slices: int, device: str = "cuda") -> DeviceMesh:
    """2-D ``("dcn", "data")`` mesh for multi-slice training: the outer axis
    crosses slices (hosts), the inner one the ranks of a slice. Batches are
    split over both axes, slice outermost, so the step's collectives run
    over the flattened mesh."""
    _init_process_group(device)
    n = dist.get_world_size()
    if n % num_slices:
        raise ValueError(f"world size {n} is not a multiple of {num_slices} slices")
    return init_device_mesh(
        torch.device(device).type, (num_slices, n // num_slices), mesh_dim_names=("dcn", "data")
    )


def mesh_size(mesh: DeviceMesh) -> int:
    """The ranks of the mesh, all axes together."""
    return mesh.size()


def mesh_rank(mesh: DeviceMesh) -> int:
    """This rank's position in the flattened mesh (slice outermost): the
    index of its rows in a global batch."""
    return mesh.mesh.flatten().tolist().index(dist.get_rank())


def mesh_group(mesh: DeviceMesh):
    """The process group over the flattened mesh, in ``mesh_rank`` order."""
    if mesh.ndim == 1:
        return mesh.get_group()
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("a multi-axis mesh must cover the world in rank order")
    return dist.group.WORLD


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_batch_size(global_batch_size: int) -> int:
    """This rank's share of a global batch (each rank's generator pool makes
    only its own rows)."""
    n, _ = _world()
    if global_batch_size % n:
        raise ValueError(f"global batch size {global_batch_size} not divisible by world size {n}")
    return global_batch_size // n


def per_process_seed(seed: int) -> int:
    """Decorrelates the ranks' generator streams: rank ``r`` draws from
    ``seed + 7919 * r``, so that the global batch comes from W independent
    streams and not W copies of one."""
    return seed + SEED_STRIDE * _world()[1]


def _rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    n, r = mesh_size(mesh), mesh_rank(mesh)
    if x.shape[0] % n:
        raise ValueError(f"a leading axis of {x.shape[0]} rows does not split over {n} ranks")
    b = x.shape[0] // n
    return x[r * b : (r + 1) * b]


def shard_batch(batch: Mapping[str, Any], mesh: DeviceMesh) -> dict:
    """This rank's rows of a global batch (the same arrays on every rank),
    on its device. The JAX package's single-process ``shard_batch`` places a
    global array with its leading axis split over the mesh's devices; the
    shard a device holds there is what this returns on its rank."""
    dev = mesh_device(mesh)
    return {k: _rows(torch.as_tensor(v), mesh).to(dev) for k, v in batch.items()}


def assemble_batch(local_batch: Mapping[str, Any], mesh: DeviceMesh) -> dict:
    """This rank's own rows (``local_batch_size`` of them, from its own
    generator), on its device. The JAX package's ``assemble_batch``
    (``jax.make_array_from_process_local_data``) builds the global array
    from each process's rows without gathering them; here the global batch
    is never built either: rank ``r``'s rows are rows ``r * B / W`` onward
    of it, which ``shard_batch`` of the global batch would give the rank."""
    dev = mesh_device(mesh)
    return {k: torch.as_tensor(v).to(dev) for k, v in local_batch.items()}


def replicate(module_or_state: Any, mesh: DeviceMesh) -> Any:
    """Broadcasts a module's parameters and buffers, or every tensor of a
    (nested) dict or list of tensors, from rank 0 to the mesh, in place;
    returns its argument."""
    group = mesh_group(mesh)
    src = mesh.mesh.flatten().tolist()[0]
    if isinstance(module_or_state, torch.nn.Module):
        tensors = list(module_or_state.parameters()) + list(module_or_state.buffers())
    else:
        tensors = list(_tensors(module_or_state))
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=src, group=group)
    return module_or_state


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def all_gather_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) stacked on the leading axis in
    ``mesh_rank`` order; no gradient."""
    parts = [torch.empty_like(x) for _ in range(mesh_size(mesh))]
    dist.all_gather(parts, x.contiguous(), group=mesh_group(mesh))
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    """``all_gather_rows`` with a gradient: the backward keeps this rank's
    rows of the cotangent."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows, ctx.rank = x.shape[0], mesh_rank(mesh)
        return all_gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank * ctx.rows : (ctx.rank + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The global batch of a per-rank tensor, differentiable.

    Every rank computes the same loss from the same gathered tensors, so the
    cotangent of the gathered tensor is the same on every rank, and this
    rank's rows of it are the gradient of the global loss with respect to its
    own rows: the backward returns them and communicates nothing. A rank's
    parameter gradients are then its rows' share of the global loss's
    gradient, and their sum over the ranks (``reduce_gradients``) is that
    gradient. (The backward of ``torch.distributed.nn.all_gather`` would sum
    the W equal cotangents instead, which a division by W undoes.)"""
    return _GatherRows.apply(x, mesh)


def gather_batch(batch: Mapping[str, torch.Tensor], mesh: DeviceMesh) -> dict:
    """The global batch of a per-rank batch's label arrays (the images are
    never gathered)."""
    return {k: all_gather_rows(v, mesh) for k, v in batch.items() if k != "image"}


def reduce_gradients(grads: Sequence[torch.Tensor], mesh: DeviceMesh) -> None:
    """Sums each gradient over the mesh, in place, in one collective a dtype
    (the gradients flattened into one buffer)."""
    if any(g is None for g in grads):
        raise ValueError(f"{sum(g is None for g in grads)} parameters have no gradient to reduce")
    for dtype in sorted({g.dtype for g in grads}, key=str):
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh_group(mesh))
        offset = 0
        for g in same:
            g.copy_(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()
