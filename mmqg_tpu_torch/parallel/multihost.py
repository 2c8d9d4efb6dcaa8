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

A ``(data, model)`` mesh is a :class:`Grid` of processes, one per device in
row-major order. The ranks of one row of the data axis (a model group)
see the same batch rows, since JAX splits the batch over "data" only, so
whatever is per data-parallel rank -- the row block
(:func:`local_row_range`, :func:`loader_local_rows`), the gradient and
batchnorm sums -- takes the grid's data group, whose rank is the data
index.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mmqg_tpu_torch.parallel.mesh import padded_rows, row_block


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device="cuda", timeout_s: float = 600.0,
                         backend: Optional[str] = None) -> None:
    """Join this process to the process group (``jax.distributed
    .initialize``): NCCL for a CUDA ``device``, gloo for the CPU, or
    ``backend`` (gloo on CUDA tensors stages them through the host: two
    ranks on one card, which NCCL refuses). With a ``coordinator_address``
    ("host:port") the group meets there over TCP and
    ``num_processes``/``process_id`` are required; without one they come
    from the environment (``env://``: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK). ``process_id`` is this process's global rank."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        kw = dict(init_method=f"tcp://{coordinator_address}",
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


class Grid:
    """The process grid of a ``(data, model)`` mesh over the processes of
    ``group`` (default: every process): rank ``i`` is at data index
    ``i // model`` and model index ``i % model``, as JAX's row-major
    ``make_mesh`` places devices. ``data_group``: the ``data`` ranks that
    share this rank's model index; ``model_group``: the ``model`` ranks
    that share its data index (``data_ranks``/``model_ranks``: their
    global ranks, in group order). Every process builds the grid, in the same
    order (``dist.new_group`` is collective); without a process group the
    grid is ``(1, 1)`` and both groups are None."""

    def __init__(self, shape: Tuple[int, int], group=None):
        d, m = (int(s) for s in shape)
        rank, size = world(group)
        if d * m != size:
            raise ValueError(f"a ({d}, {m}) grid needs {d * m} processes, "
                             f"the group has {size}")
        self.shape = (d, m)
        self.dp, self.tp = d, m
        self.group = group
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, m)
        self.data_group = self.model_group = None
        self.model_ranks = self.data_ranks = [rank]
        if size == 1:
            return
        ranks = [dist.get_global_rank(group, i) if group not in (
            None, dist.group.WORLD) else i for i in range(size)]
        for j in range(m):
            members = [ranks[i * m + j] for i in range(d)]
            g = dist.new_group(members)
            if j == self.model_index:
                self.data_group, self.data_ranks = g, members
        for i in range(d):
            members = [ranks[i * m + j] for j in range(m)]
            g = dist.new_group(members)
            if i == self.data_index:
                self.model_group, self.model_ranks = g, members

    def __repr__(self) -> str:
        return (f"Grid(data={self.dp}, model={self.tp}, rank {self.rank} at "
                f"({self.data_index}, {self.model_index}))")


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


def _nccl(group) -> bool:
    return dist.get_backend(group) == dist.Backend.NCCL


def reduce_scatter_flat(flat: torch.Tensor, group=None) -> torch.Tensor:
    """This process's block of the elementwise sum over the processes of
    ``flat`` (1-D, its length a multiple of the group size, block r for
    rank r): one reduce-scatter on NCCL. gloo gets an all-reduce and keeps
    the block (not every version of its CUDA path has a reduce-scatter;
    the sums are the same). ``flat`` itself alone."""
    rank, size = world(group)
    if size == 1:
        return flat
    n = flat.numel() // size
    if _nccl(group):
        out = torch.empty(n, dtype=flat.dtype, device=flat.device)
        dist.reduce_scatter_tensor(out, flat.contiguous(), group=group)
        return out
    flat = flat.clone()
    dist.all_reduce(flat, group=group)
    return flat[rank * n:(rank + 1) * n].clone()


def all_gather_flat(block: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's ``block`` (1-D, the same length on each), in rank
    order, as one tensor: one all-gather (on NCCL into one buffer; gloo
    through the host). ``block`` itself alone."""
    size = world(group)[1]
    if size == 1:
        return block
    if _nccl(group):
        out = torch.empty(size * block.numel(), dtype=block.dtype,
                          device=block.device)
        dist.all_gather_into_tensor(out, block.contiguous(), group=group)
        return out
    host = block.detach().cpu()
    parts = [torch.empty_like(host) for _ in range(size)]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts).to(block.device)


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
