"""Pipeline parallelism: a GPipe microbatch schedule over the model group
of a process grid (``mmqg_tpu/parallel/gpipe.py``).

The pipeline has S stages, one per rank of the group; rank s computes
stage s alone. The batch is split into M microbatches
(:func:`microbatch`); at tick t rank s applies stage s to microbatch
t - s, and after each tick every rank sends its activation to the next rank
and receives the previous rank's (``dist.isend``/``irecv``, the
neighbour hop of JAX's ``ppermute``). T = M + S - 1 ticks run the
schedule, with the textbook bubble of (S - 1) / T. The last stage's
outputs are summed over the group (the others contribute zeros), so
every rank returns them, as JAX's ``psum`` does.

:func:`gpipe` is differentiable: its backward runs the reverse schedule,
each tick recomputing the stage's forward from the activation it kept,
sending the input gradient to the previous rank and receiving the output
gradient from the next. Stage parameters come in stacked (leading dim S,
:func:`stack_stage_params`); rank s takes its slice, and the backward
gathers the slices' gradients, so every rank returns the gradient of the
whole stack (``model_axis.split_to_model``). With a data axis each model
group runs its own pipeline on its data row's rows (DP x PP). Like JAX's,
it is a generic primitive for homogeneous stacks: no model path uses it.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist

from mmqg_tpu_torch.optim import tree_map
from mmqg_tpu_torch.parallel import model_axis
from mmqg_tpu_torch.parallel.multihost import world

Tensor = torch.Tensor


def microbatch(x: Tensor, num_microbatches: int) -> Tensor:
    """(B, ...) -> (M, B/M, ...)."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(
            f"batch {b} not divisible into {num_microbatches} microbatches")
    return x.reshape((num_microbatches, b // num_microbatches) + x.shape[1:])


def unmicrobatch(y: Tensor) -> Tensor:
    """Inverse of :func:`microbatch`: (M, mb, ...) -> (M * mb, ...)."""
    return y.reshape((y.shape[0] * y.shape[1],) + y.shape[2:])


def stack_stage_params(stage_params: list) -> Any:
    """[params_0, ..., params_{S-1}] (one structure and shapes) -> one
    tree whose every leaf gains a leading stage dim S."""
    return tree_map(lambda *ls: torch.stack(ls), *stage_params)


def _shift(x: Tensor, to_rank: int, from_rank: int, group) -> Tensor:
    """Send ``x`` to ``to_rank`` and receive a tensor of its shape from
    ``from_rank`` (global ranks); gloo's point-to-point goes through the
    host. One rank alone keeps ``x``."""
    if world(group)[1] == 1:
        return x.detach()
    stage = (x.is_cuda and dist.get_backend(group) != dist.Backend.NCCL)
    send = x.detach().contiguous()
    if stage:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, to_rank),
           dist.P2POp(dist.irecv, recv, from_rank)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if stage else recv


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, group, ranks, xs, *params):
        s, S = world(group)
        M = xs.shape[0]
        nxt, prv = ranks[(s + 1) % S], ranks[(s - 1) % S]
        buf = torch.zeros_like(xs[0])
        kept: List[Tensor] = []
        outs = torch.zeros_like(xs)
        with torch.no_grad():
            for t in range(M + S - 1):
                x_in = (xs[t] if t < M else torch.zeros_like(xs[0])) \
                    if s == 0 else buf
                y = stage_fn(params, x_in)
                if y.shape != x_in.shape or y.dtype != x_in.dtype:
                    raise ValueError(
                        "stage_fn must preserve activation shape/dtype: "
                        f"{tuple(x_in.shape)}/{x_in.dtype} -> "
                        f"{tuple(y.shape)}/{y.dtype}")
                kept.append(x_in)
                if s == S - 1 and t >= S - 1:
                    outs[t - (S - 1)] = y
                buf = _shift(y, nxt, prv, group)
        ctx.stage_fn, ctx.group, ctx.ranks = stage_fn, group, ranks
        ctx.kept = kept
        ctx.save_for_backward(*params)
        return model_axis.all_reduce_(outs, group)

    @staticmethod
    def backward(ctx, g_out):
        params = ctx.saved_tensors
        s, S = world(ctx.group)
        M = g_out.shape[0]
        nxt, prv = ctx.ranks[(s + 1) % S], ctx.ranks[(s - 1) % S]
        g_params = [torch.zeros_like(p) for p in params]
        g_xs = torch.zeros_like(g_out)
        g_next = torch.zeros_like(g_out[0])     # from rank s + 1, tick t + 1
        for t in reversed(range(M + S - 1)):
            gy = g_next if s < S - 1 else torch.zeros_like(g_out[0])
            if s == S - 1 and t >= S - 1:
                gy = gy + g_out[t - (S - 1)]
            with torch.enable_grad():
                x_in = ctx.kept[t].detach().requires_grad_(True)
                ps = [p.detach().requires_grad_(True) for p in params]
                y = ctx.stage_fn(ps, x_in)
                grads = torch.autograd.grad(y, [x_in] + ps, gy,
                                            allow_unused=True)
            gx = grads[0] if grads[0] is not None else torch.zeros_like(
                x_in)
            for acc, g in zip(g_params, grads[1:]):
                if g is not None:
                    acc += g
            if s == 0 and t < M:
                g_xs[t] = gx
            # the input gradient goes back to the rank that sent the input
            g_next = _shift(gx, prv, nxt, ctx.group)
        # every rank holds the inputs; their gradient is stage 0's
        model_axis.all_reduce_(g_xs, ctx.group)
        return (None, None, None, g_xs, *g_params)


def gpipe(stage_fn: Callable[[Any, Tensor], Tensor], stacked_params: Any,
          xs: Tensor, *, group, ranks: List[int]) -> Tensor:
    """Apply S pipeline stages to M microbatches with a GPipe schedule
    over ``group`` (S ranks; ``ranks``: their global ranks in group
    order, ``multihost.Grid.model_ranks``).

    ``stage_fn(params_s, x) -> y`` is one stage; it must keep the
    activation's shape and dtype (the same buffer moves between stages).
    ``stacked_params``: a tree whose every leaf has leading dim S, leaf[s]
    stage s's (:func:`stack_stage_params`). ``xs``: (M, mb, ...)
    microbatched inputs (:func:`microbatch`), the same on every rank of
    the group. Returns (M, mb, ...): every microbatch through all S stages
    in order, on every rank, differentiable in ``xs`` and
    ``stacked_params``."""
    S = world(group)[1]
    if len(ranks) != S:
        raise ValueError(f"{len(ranks)} ranks for a group of {S}")
    leaves: List[Tensor] = []
    tree_map(leaves.append, stacked_params)
    for leaf in leaves:
        if tuple(leaf.shape[:1]) != (S,):
            raise ValueError(f"stage param leading dim {tuple(leaf.shape)} "
                             f"!= {S} stages (the model group)")
    # this rank's stage, its gradient gathered back into the stack
    mine = [model_axis.split_to_model(leaf, 0, group)[0] if S > 1
            else leaf[0] for leaf in leaves]
    treedef = stacked_params

    def fn(flat, x):
        it = iter(flat)
        return stage_fn(tree_map(lambda _: next(it), treedef), x)
    return _GPipe.apply(fn, group, list(ranks), xs, *mine)
