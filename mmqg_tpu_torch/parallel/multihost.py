"""Multi-process data parallelism (``mmqg_tpu/parallel/multihost.py``):
one process per device, joined by ``torch.distributed``.

The JAX package runs one program over a mesh that spans processes, and
XLA inserts the collectives. The port runs one process per card (NCCL) or
per CPU worker (gloo), each holding a full replica and its contiguous block
of every global batch (``mesh.row_block`` in rank order, the JAX package's
process-major ``assemble_global_batch``), and makes the collectives itself:
the training step's gradient and batchnorm all-reduces, the bucket caps
(:func:`global_max_int`) and the validation gather (:func:`to_host`).

Every function takes a ``torch.distributed`` group (``None``: the default
group) and is the identity when no process group is initialised or the
group has one member, as the JAX functions are in one process.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mmqg_tpu_torch.parallel.mesh import padded_rows, row_block


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device="cuda", timeout_s: float = 600.0,
                         backend: Optional[str] = None) -> None:
    """Join this process to the process group (``jax.distributed
    .initialize``): NCCL for a CUDA ``device``, gloo for the CPU, or
    ``backend`` (gloo on CUDA tensors stages them through the host: two
    ranks on one card, which NCCL refuses). With a ``coordinator``
    ("host:port") the group meets there over TCP and
    ``num_processes``/``process_id`` are required; without one they come
    from the environment (``env://``: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK). ``process_id`` is this process's global rank."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {}
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        kw = dict(init_method=f"tcp://{coordinator}",
                  world_size=int(num_processes), rank=int(process_id))
    else:
        kw = dict(init_method="env://")
        if num_processes is not None:
            kw["world_size"] = int(num_processes)
        if process_id is not None:
            kw["rank"] = int(process_id)
    if backend == "nccl":
        # NCCL binds a rank to the card that is current when it first talks
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)


def world(group=None) -> Tuple[int, int]:
    """(rank, size) of this process in ``group``; (0, 1) without a process
    group."""
    if not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def is_primary(group=None) -> bool:
    """True on the process that owns the filesystem side effects
    (checkpoints, stats.json): rank 0, or the only process."""
    return world(group)[0] == 0


def barrier(group=None) -> None:
    """Wait for every process of ``group``; nothing with one."""
    if world(group)[1] > 1:
        dist.barrier(group=group)


def local_row_range(global_rows: int, group=None) -> Tuple[int, int]:
    """[start, stop) of the global batch rows this process contributes:
    its ``row_block`` (the JAX package's ``local_row_range``); (0, rows)
    alone."""
    rank, size = world(group)
    if size == 1:
        return 0, global_rows
    return row_block(rank, size, global_rows)


def loader_local_rows(batch_size: int, group=None) -> Optional[tuple]:
    """The ``local_rows`` a sharded loader packs for a ``batch_size``-row
    host batch that is padded to the data axis and split: this process's
    block of the PADDED batch, clipped to the real rows (padded rows are
    zeros, never loaded). None when every row is loaded (one process)."""
    rank, size = world(group)
    if size == 1:
        return None
    lo, hi = row_block(rank, size, padded_rows(batch_size, size))
    return min(lo, batch_size), min(hi, batch_size)


def global_max_int(value: int, group=None) -> int:
    """The max of a host integer over the processes (one all-reduce MAX).
    Host decisions that shape the work -- the AV bucket caps -- must agree
    on every process: a sharded loader sees only its own rows."""
    if world(group)[1] == 1:
        return int(value)
    # NCCL takes tensors on the current card, gloo on the CPU too
    dev = ("cuda" if dist.get_backend(group) == dist.Backend.NCCL
           else "cpu")
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def to_host(x: torch.Tensor, group=None,
            rows: Optional[int] = None) -> np.ndarray:
    """Every process's block of a batch-sharded result, in rank order, as
    numpy on every process (an all-gather; the JAX package's ``to_host``),
    cut to the first ``rows`` when given (the padding's rows go)."""
    if world(group)[1] > 1:
        local = x.detach().contiguous()
        parts = [torch.empty_like(local) for _ in range(world(group)[1])]
        dist.all_gather(parts, local, group=group)
        x = torch.cat(parts)
    out = x.detach().cpu().numpy()
    return out if rows is None else out[:rows]


class _AllReduceSum(torch.autograd.Function):
    """All-reduce SUM whose backward is the all-reduce SUM of the
    cotangent: the derivative of a sum over processes, each process
    holding its share of one global loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the processes, differentiable (its gradient is
    summed too); ``x`` itself alone."""
    if world(group)[1] == 1:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    group=None) -> List[torch.Tensor]:
    """The elementwise sums over the processes of same-shaped lists of
    tensors, as one flat bucket (one all-reduce); the tensors themselves
    alone."""
    if world(group)[1] == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def replicas_differ(tensors: Sequence[torch.Tensor], group=None) -> float:
    """The largest difference between the processes' copies of
    ``tensors`` (max over the processes minus min, elementwise, as one
    bucket): 0.0 when every process holds the same values."""
    if world(group)[1] == 1 or not tensors:
        return 0.0
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    return float((hi - lo).max())
