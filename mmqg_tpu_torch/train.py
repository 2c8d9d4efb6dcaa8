"""Training for the PyTorch port (``mmqg_tpu/train.py``).

    python -m mmqg_tpu_torch.train -c config.json --epochs 10   # on the card
    python -m mmqg_tpu_torch.train -c config.json --device cpu
    python -m mmqg_tpu_torch.train -c config.json --data-parallel  # all cards
    python -m mmqg_tpu_torch.train -c config.json --data-parallel --zero1
    python -m mmqg_tpu_torch.train -c config.json --data-parallel \
        --sequence-parallel    # config mesh_shape (data, model), e.g. (1, 2)

One train step: ``qg_model.loss_fn`` (train-mode encode, the text and video
LSTMs through K4, teacher-forced decode) under autograd, in any mode,
decoder and video backbone (``--mode``, ``--decoder``,
``--video-encoder``), then the optimizer of ``mmqg_tpu_torch.optim``
(optax's Adam/AdamW/SGD, schedules, clipping and the
``text_non_trainable`` freeze, in optax's state layout). Validation
is the greedy-fed CE decode through K1 and K2 plus BLEU. Checkpoints are the
JAX package's msgpack or orbax train state (``checkpoint_backend``),
written on a writer thread with ``checkpoint_async``, so each package
resumes the other's.

Data parallelism (``--data-parallel``, ``--multihost``; ``Trainer``'s
``process_group``) runs one process per device, each with its row block of
every global batch, and all-reduces what one program over the global
batch would share: the valid count, the batchnorm statistics and the
gradients. ``--zero1`` splits the optimizer state over the data axis and
``--fsdp`` the parameters too (``parallel/zero.py``: the gradients
reduce-scattered, the parameters all-gathered). ``--streaming`` reads
batches with ``data.streaming``'s pack pool. A ``config.mesh_shape`` of
``(data, model)`` lays the processes out as that mesh
(``multihost.Grid``): the model axis stores the state by JAX's
tensor-parallel rules (``parallel/model_axis.py``), and
``--sequence-parallel`` (``--sp-gather-free``) splits the text memory over
it. ``--profile-dir`` traces one warm step with ``torch.profiler``, whose
parts are spans under any profiler (``train.h2d``, ``train.forward``,
``train.backward``, ``train.optimizer``, ``train.loss_read``; the batch's
gather ``data.batch``), and ``h2d_shipped`` counts the H2D's calls and
bytes; ``--nan-debug`` raises at the first non-finite value
(``utils/profiling.py``). ``--compile-cache`` is left out (nothing is
compiled ahead). ``Config``,
``QGDataset``, BLEU and the pipelining helper are the port's own copies of
the JAX package's modules; either package's ``config.json`` loads.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import threading
import time
from collections import deque
from contextlib import ExitStack, nullcontext
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch import metrics as M
from mmqg_tpu_torch.compat.from_jax import (load_train_state,
                                            params_from_numpy,
                                            train_state_to_numpy)
from mmqg_tpu_torch.config import Config
from mmqg_tpu_torch.data import native
from mmqg_tpu_torch.data.dataset import Batch, QGDataset
from mmqg_tpu_torch.data.streaming import StreamingLoader
from mmqg_tpu_torch.data.vocab import START_ID
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.optim import (Transform, apply_updates, global_norm,
                                  learning_rate_schedule, make_optimizer,
                                  norm_over, tree_leaves, tree_map)
from mmqg_tpu_torch.ops.attention_sp import trimodal_attention_sp
from mmqg_tpu_torch.parallel import model_axis, multihost, zero
from mmqg_tpu_torch.parallel.mesh import (Mesh, pad_batch, padded_rows,
                                          row_block, sequence_constraint)
from mmqg_tpu_torch.parallel.multihost import all_reduce_flat
from mmqg_tpu_torch.utils import profiling
from mmqg_tpu_torch.utils.device import resolve_device
from mmqg_tpu_torch.utils.pipelining import pipelined

Tensor = torch.Tensor

__all__ = ["TrainState", "Trainer", "batch_arrays", "evaluate_bleu",
           "init_train_state", "learning_rate_schedule", "make_optimizer",
           "make_train_step", "make_validate_step", "to_device"]


@dataclass
class TrainState:
    """The model (parameters and batchnorm state), the optimizer state in
    optax's layout, and the number of optimizer updates taken. ``shards``:
    set when the state is split over a data axis (``parallel.zero``):
    ``opt_state`` then holds this process's slices, and with FSDP the
    split parameters are freed between steps."""
    model: qg_model.QGModel
    opt_state: Any
    step: int = 0
    shards: Optional[zero.Shards] = None


def init_train_state(mc: qg_model.ModelConfig, emb_weights,
                     optimizer: Transform, *, seed: int = 0,
                     device="cuda") -> TrainState:
    """A fresh trainable model (``qg_model.init_params`` from ``seed``, the
    embedding table from ``emb_weights``) and its optimizer state, on
    ``device``: the card by default; without CUDA that raises unless the
    caller passes ``device="cpu"``."""
    device = resolve_device(device, caller="init_train_state")
    params, state = qg_model.init_params(mc, seed, emb_weights)
    model = params_from_numpy(params, state, device, trainable=True)
    return TrainState(model, optimizer.init(qg_model.param_tree(model)))


def batch_arrays(batch: Batch) -> Dict[str, np.ndarray]:
    """The model inputs of a Batch (drops the host-only fields)."""
    return {"context_ids": batch.context_ids,
            "context_len": batch.context_len,
            "frames": batch.frames,
            "frames_len": batch.frames_len,
            "audio_pcm": batch.audio_pcm,
            "audio_len": batch.audio_len,
            "target_ids": batch.target_ids,
            "target_len": batch.target_len,
            "valid": batch.valid}


# host batches shipped to the device by ``to_device``, and their bytes
h2d_shipped = {"calls": 0, "bytes": 0}


@profiling.annotate("train.h2d")
def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    h2d_shipped["calls"] += 1
    h2d_shipped["bytes"] += sum(v.nbytes for v in arrays.values())
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


StepFn = Callable[..., Tuple[TrainState, Dict[str, Tensor]]]


def make_train_step(mc: qg_model.ModelConfig, optimizer: Transform, *,
                    dtype: torch.dtype = torch.bfloat16,
                    accum_steps: int = 1, process_group=None,
                    zero1: bool = False, fsdp: bool = False,
                    grid: Optional[multihost.Grid] = None,
                    sp_mesh: Optional[multihost.Grid] = None,
                    sp_gather_free: bool = False) -> StepFn:
    """``train_step(state, batch, generator, *, audio_cap=None,
    frames_cap=None) -> (state, metrics)``: one optimizer update from
    ``batch`` (tensors on the model's device), in place on ``state``.
    Metrics are 0-d device tensors: ``objective``, ``loss``
    (reference-style per-sample loss), ``loss_per_token`` and
    ``grad_norm`` (over every gradient leaf).

    ``audio_cap``/``frames_cap`` bound the AV encoders (see
    ``qg_model.encode``); padded slots are masked, so the gradients do not
    change. The batch is split into ``accum_steps`` microbatches (the whole
    batch when it is 1), one backward each, with each microbatch's
    gradient weighted by its share of the valid samples, and one update is
    taken -- the JAX package's accumulated step. Batchnorm running
    statistics advance once per microbatch, in order.

    ``process_group``: data-parallel training, one process per device,
    each calling the step on its row block of the global batch (the JAX
    package's step under a mesh, one program over the global batch). The
    samples are weighted by the GLOBAL valid count (one all-reduce), the
    gradients are summed over the processes as one flat bucket before the
    optimizer, so every process takes the same update, and the metrics
    are the global batch's. The model's batchnorms take their statistics
    over the group too (``qg_model.set_process_group``, which the caller
    sets). With accumulation, microbatch i is every process's i-th slice
    of its block.

    ``zero1`` (ZeRO-1) and ``fsdp`` (which implies it), with a process
    group of more than one: the state is split over the data axis
    (``parallel.zero.shard``, done here on the first call if the caller
    has not): the gradients are reduce-scattered into the optimizer
    state's slices instead of all-reduced, the optimizer updates the
    slices, and the parameters are all-gathered after the update (ZeRO-1)
    or at the start of the next step (FSDP). The update equals the
    all-reduced step's. Without a data axis both are no-ops, as in the
    JAX package.

    ``grid`` (a ``multihost.Grid``, in place of ``process_group``): the
    step on a ``(data, model)`` mesh of processes. The data group plays
    ``process_group``'s part. A model axis larger than 1 stores the state
    by JAX's ``param_shardings`` (``parallel.model_axis.shard``, done here
    on the first call if the caller has not): the split leaves are
    gathered over the model group at the start of the step, the ranks of a
    model group compute the same whole step on their data row's rows --
    but for the vocab projection, column-parallel -- and each keeps its
    slice of the gradients; the optimizer updates the slices (its norm
    summed over both axes), and the whole copies are freed. ZeRO-1/FSDP
    split the slices further over the data axis.

    ``sp_mesh`` (a grid; JAX's ``make_train_step(sp_mesh=)``): training-side
    sequence parallelism, the text memory split over the grid's model axis
    through the teacher-forced decode and its backward
    (``mesh.sequence_constraint``); ``sp_gather_free`` runs the decoder's
    text attention as ``ops.attention_sp.trimodal_attention_sp``. Without
    a model axis both are no-ops."""
    if grid is not None and process_group is not None:
        raise ValueError("pass a grid or a process group, not both")
    group = process_group
    model_group = None
    if grid is not None:
        group = grid.data_group if grid.dp > 1 else None
        model_group = grid.model_group if grid.tp > 1 else None
    sharded = ((zero1 or fsdp) and group is not None
               and multihost.world(group)[1] > 1)
    mem_constraint, attn_fn = None, None
    if sp_mesh is not None and sp_mesh.tp > 1:
        mem_constraint = sequence_constraint(sp_mesh)
        if sp_gather_free:
            attn_fn = partial(trimodal_attention_sp,
                              group=sp_mesh.model_group)

    def train_step(ts: TrainState, batch: Dict[str, Tensor], generator, *,
                   audio_cap: Optional[int] = None,
                   frames_cap: Optional[int] = None):
        A = accum_steps
        B = batch["target_ids"].shape[0]
        if B % A:
            raise ValueError(f"batch {B} not divisible by accum_steps {A}")
        if model_group is not None and ts.model.tp is None:
            model_axis.shard(ts, grid)
        if sharded:
            if ts.shards is None:
                zero.shard(ts, group, fsdp=fsdp)
            elif ts.shards.fsdp != fsdp:
                raise ValueError(f"the state is split with fsdp="
                                 f"{ts.shards.fsdp}, the step has {fsdp}")
            ts.shards.gather_params()
        elif ts.shards is not None:
            raise ValueError("the state is split over a data axis: make the "
                             "step with zero1/fsdp and its process group")
        tp = ts.model.tp
        if tp is not None:
            tp.gather()
        params = qg_model.param_tree(ts.model)
        for p in tree_leaves(params):
            p.grad = None
        m = B // A
        # grad = sum_i n_i g_i / sum_i n_i (loss_fn normalises each
        # microbatch by its own valid count); the weights stay on the device
        n_all = batch["valid"].sum().float()
        if group is not None:
            n_all, = all_reduce_flat([n_all], group)
        n_all = torch.clamp(n_all, min=1.0)
        parts = []
        for i in range(A):
            mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            w = mb["valid"].sum().float() / n_all
            with profiling.annotate("train.forward"):
                obj, aux = qg_model.loss_fn(
                    ts.model, mc, mb, train=True, generator=generator,
                    dtype=dtype, audio_cap=audio_cap, frames_cap=frames_cap,
                    mem_constraint=mem_constraint, attn_fn=attn_fn)
            with profiling.annotate("train.backward"):
                (obj * w).backward()
            qg_model.load_model_state(ts.model, aux["state"])
            parts.append((w, obj.detach(), aux["loss_per_sample"].detach(),
                          aux["loss_per_token"].detach(), aux["n_tokens"]))
        metrics = {"objective": sum(w * o for w, o, _, _, _ in parts),
                   "loss": sum(w * ls for w, _, ls, _, _ in parts)}
        ntok = sum(p[4] for p in parts)
        if group is None:
            ntok = torch.clamp(ntok, min=1)
            metrics["loss_per_token"] = sum(lt * (n / ntok)
                                            for _, _, _, lt, n in parts)
        else:
            obj, loss, ce, ntok = all_reduce_flat([torch.stack([
                metrics["objective"], metrics["loss"],
                sum(lt * n for _, _, _, lt, n in parts),
                ntok.float()])], group)[0]
            metrics = {"objective": obj, "loss": loss,
                       "loss_per_token": ce / torch.clamp(ntok, min=1.0)}
        with profiling.annotate("train.optimizer"):
            grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                             else p.grad, params)
            if tp is not None:
                # each rank's slice of the replicas' whole gradients; the
                # parameters go back to their slices for the update
                grads = tp.own_grads(grads)
                for p in tree_leaves(params):
                    p.grad = None
                tp.release()
            shards = ts.shards
            if shards is not None:
                grads = shards.reduce_scatter(grads)
                targets = shards.param_slices()
            else:
                targets = params
                if group is not None:
                    leaves = []
                    tree_map(leaves.append, grads)
                    summed = iter(all_reduce_flat(leaves, group))
                    grads = tree_map(lambda _: next(summed), grads)
            # sharded, the clip's norm and the metric's sum every process's
            # slices
            norm = None
            if tp is not None:
                norm = partial(tp.norm_buckets, data_dims=(
                    shards.param_dims if shards is not None else {}),
                    data_group=group)
            elif shards is not None:
                norm = shards.global_norm
            with norm_over(norm) if norm is not None else nullcontext():
                updates, ts.opt_state = optimizer.update(grads, ts.opt_state,
                                                         targets)
                metrics["grad_norm"] = global_norm(grads).detach()
            apply_updates(targets, updates)
        for p in tree_leaves(params):
            p.grad = None
        if shards is not None:
            shards.publish()
        ts.step += 1
        return ts, metrics

    return train_step


def make_validate_step(mc: qg_model.ModelConfig, *,
                       dtype: torch.dtype = torch.bfloat16):
    """``validate_step(model, batch, audio_cap, frames_cap) ->
    (per_sample_loss (B,), tokens (B, T))``: the greedy-fed validation
    decode (``train.make_validate_step``). Encode runs through K1, each of
    the ``target_steps`` decode steps through K2 on the card (the attention
    decoder) or reads the AV vector (the non-attention decoder); argmax
    feeds the next step and the CE is taken against the target at every
    step, averaged per sample over its target length. A column-parallel
    vocab projection (a model axis) takes the log-softmax and the argmax
    over the axis (``parallel.model_axis``)."""
    @torch.no_grad()
    def validate_step(model: qg_model.QGModel, batch: Dict[str, Tensor],
                      audio_cap: Optional[int] = None,
                      frames_cap: Optional[int] = None):
        mem, state = DEC.encode(model, mc, batch, audio_cap=audio_cap,
                                frames_cap=frames_cap, dtype=dtype)
        target = batch["target_ids"].long()
        B, T = target.shape
        dec = model.decoder
        inputs = dec.step_inputs(mem, dtype)
        tok = torch.full((B,), START_ID, dtype=torch.long,
                         device=target.device)
        ces, toks = [], []
        vocab = dec.out.column_group     # a column-parallel projection
        for t in range(T):
            logits, state, _ = dec.step(model.embedding, tok, inputs, state,
                                        dtype=dtype)
            ces.append(-model_axis.log_prob(logits, target[:, t], vocab))
            tok = model_axis.argmax(logits, vocab)
            toks.append(tok)
        ces = torch.stack(ces, dim=1)
        target_len = batch["target_len"]
        mask = (torch.arange(T, device=target.device)[None, :]
                < target_len[:, None])
        per_sample = (ces * mask).sum(1) / torch.clamp(target_len, min=1)
        return per_sample, torch.stack(toks, dim=1).to(torch.int32)

    return validate_step


def evaluate_bleu(tokens: np.ndarray, questions, index_to_word,
                  valid: np.ndarray,
                  compat: bool = False) -> Tuple[Dict[str, float], int]:
    """Host-side BLEU suite over a batch of decoded tokens
    (``train.evaluate_bleu``). Returns (per-metric averages, number of
    scored samples)."""
    sums = {k: 0.0 for k in M.BLEU_WEIGHTS}
    n = 0
    for words, q, ok in zip(DEC.tokens_to_words(tokens, index_to_word),
                            questions, valid):
        if not ok:
            continue
        for k, v in M.bleu_suite(q, words, compat=compat).items():
            sums[k] += v
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}, n


class Trainer:
    """The training loop (``train.Trainer``): AV-bucketed train steps,
    lag-2 metric reads, validation with BLEU, best/last msgpack
    checkpoints, resume, SIGTERM-safe ``fit`` and ``stats.json``.

    ``device`` is where this process's model trains; it computes in
    bfloat16, as the JAX trainer does.

    Data parallelism (the JAX Trainer's ``mesh``): one process per device,
    each with a ``Trainer`` on its card and the same ``process_group``
    (``parallel.multihost.initialize_multihost``). ``mesh`` is the data
    axis over those processes; without a group it takes the default group
    (its size must be the mesh's data axis). Every global batch -- each
    process builds the same, or packs only its own rows with a sharded
    ``StreamingLoader`` -- is padded to the data axis and each process
    trains on its contiguous row block (``make_train_step(process_group=)``:
    global valid count, batchnorm statistics and gradient sums), with the
    AV caps agreed over the group (``global_max_int``). Validation decodes
    each process's rows and gathers them (``to_host``); BLEU is scored on
    the primary. The primary writes checkpoints and ``stats.json``, the
    others wait at a barrier; every process loads on resume. Dropout draws
    from a generator seeded with (seed, rank). ``config.zero1`` and
    ``config.fsdp`` (which implies it) split the optimizer state, and the
    parameters, over the data axis (``parallel.zero``): ``validate``
    gathers FSDP's parameters for its duration, ``save`` gathers the whole
    state on every process before the primary writes (a collective), and
    ``resume`` keeps each process's slices of the loaded state. Without a
    data axis they are no-ops, as in the JAX package.

    A ``(data, model)`` mesh (``grid``, a ``multihost.Grid`` over the
    processes; or ``mesh`` with a model axis larger than 1, whose grid is
    built over ``process_group``): every process of a model group trains
    on its data row's block, the state stored over the model axis by
    JAX's rules (``make_train_step(grid=)``); the dropout generator and
    the row block follow the data index, the batchnorm statistics and
    gradient sums the data group, and the checkpoints gather the model
    axis's slices too. ``config.sequence_parallel_train`` (and
    ``sp_gather_free``) split the text memory over the model axis; no-ops
    without one, as in the JAX package.

    ``profile_dir``: a ``torch.profiler`` trace (``utils.profiling
    .trace``) of the first batch whose AV-bucket variant has already run
    once, so a warm step, from its H2D to its loss read; the lag-2 backlog
    is drained first."""

    def __init__(self, config, mc: qg_model.ModelConfig, emb_weights,
                 train_ds: QGDataset, val_ds: QGDataset, *, device="cuda",
                 mesh: Optional[Mesh] = None, process_group=None,
                 grid: Optional[multihost.Grid] = None,
                 log_fn=print, profile_dir=None):
        qg_model.check_supported(mc)
        self.config = config
        self.mc = mc
        self.device = torch.device(device)
        self.dtype = torch.bfloat16
        self.optimizer = make_optimizer(config)
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.accum_steps = getattr(config, "grad_accum_steps", 1) or 1
        if grid is None and mesh is not None and mesh.tp > 1:
            grid = multihost.Grid((mesh.dp, mesh.tp), process_group)
        if grid is not None:
            if mesh is not None and (mesh.dp, mesh.tp) != grid.shape:
                raise ValueError(f"{mesh} is not the grid's {grid.shape}")
            process_group = grid.data_group
            self.rank, self.dp = grid.data_index, grid.dp
        else:
            if mesh is not None and process_group is None and mesh.dp > 1:
                process_group = dist.group.WORLD
            self.rank, self.dp = (multihost.world(process_group)
                                  if process_group is not None else (0, 1))
            if mesh is not None and mesh.dp != self.dp:
                raise ValueError(f"{mesh} has a data axis of {mesh.dp}, but "
                                 f"the process group has {self.dp} "
                                 "processes (one process per device of the "
                                 "data axis)")
        self.grid = grid if grid is not None and grid.tp > 1 else None
        # the group the collectives run over: none on one device
        self.group = process_group if self.dp > 1 else None
        # checkpoints and stats: the primary of every process there is
        self.primary = multihost.is_primary()
        self.ckpt_group = ((grid.group or dist.group.WORLD)
                           if self.grid is not None else
                           self.group if self.group is not None else
                           dist.group.WORLD if multihost.world()[1] > 1
                           else None)
        # training-side SP: only with a model axis to split the context
        # over (a no-op otherwise, as in the JAX package)
        self.sp_mesh = (self.grid if getattr(config,
                                             "sequence_parallel_train", False)
                        else None)
        self.sp_gather_free = (bool(getattr(config, "sp_gather_free", False))
                               and self.sp_mesh is not None)
        self.log = log_fn if self.primary else (lambda *a, **k: None)
        self.profile_dir = profile_dir
        self._profiled = False
        self._steps_used = set()        # AV-bucket variants run once
        # ZeRO-1 / FSDP: only with a data axis to split over (no-ops
        # otherwise, so one config serves one and several devices)
        self.fsdp = bool(getattr(config, "fsdp", False)) and \
            self.group is not None
        self.zero1 = (bool(getattr(config, "zero1", False)) or self.fsdp) \
            and self.group is not None
        if self.group is not None:
            rows = padded_rows(config.batch_size, self.dp) // self.dp
            if rows % self.accum_steps:
                raise ValueError(
                    f"batch_size {config.batch_size} pads to "
                    f"{rows * self.dp} on the {self.dp}-way data axis, "
                    f"{rows} rows a process, which do not split into "
                    f"grad_accum_steps {self.accum_steps} microbatches; "
                    "pick batch_size so that they do")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed + (self.rank << 32))
        self.train_state = init_train_state(mc, emb_weights, self.optimizer,
                                            seed=config.seed,
                                            device=self.device)
        qg_model.set_process_group(self.train_state.model, self.group)
        if self.grid is not None:
            model_axis.shard(self.train_state, self.grid)
        if self.zero1:
            zero.shard(self.train_state, self.group, fsdp=self.fsdp)
        self.train_step = make_train_step(
            mc, self.optimizer, dtype=self.dtype,
            accum_steps=self.accum_steps,
            process_group=self.group if self.grid is None else None,
            zero1=self.zero1, fsdp=self.fsdp, grid=self.grid,
            sp_mesh=self.sp_mesh, sp_gather_free=self.sp_gather_free)
        self.av_bucketing = getattr(config, "train_av_bucketing", True)
        self.av_bucket_granularity = int(
            getattr(config, "train_av_bucket_granularity", 8))
        self.validate_step = make_validate_step(mc, dtype=self.dtype)
        self.epoch_stats = {"train": {"loss": []},
                            "val": {"loss": [], "bleu": [], "bleu_1": [],
                                    "bleu_2": [], "bleu_3": [], "bleu_4": []}}
        self.best_val = float("inf")
        self.best_epoch = -1
        self.start_epoch = 0

    def _global_max(self, value) -> int:
        """``value``'s max over the data axis: host decisions that shape
        the work must agree on every process."""
        if self.group is None:
            return int(value)
        return multihost.global_max_int(int(value), self.group)

    def _local_rows(self, arrays: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
        """This process's row block of a global host batch, padded to the
        data axis first; the batch itself on one device."""
        if self.group is None:
            return arrays
        arrays = pad_batch(arrays, self.dp)
        lo, hi = row_block(self.rank, self.dp, len(arrays["valid"]))
        return {k: v[lo:hi] for k, v in arrays.items()}

    # ------------------------------------------------------------- epochs
    def caps_for(self, arrays: Dict[str, np.ndarray]) -> Dict[str, int]:
        """The ``audio_cap``/``frames_cap`` keywords of the train step for
        this batch (``train.Trainer._step_for``): its AV buckets at
        ``train_av_bucket_granularity``, from the host arrays (no device
        round trip), for the modalities the mode encodes; none in mode
        text or without AV bucketing. Data-parallel, the needs are the
        maxima over the processes (a sharded loader sees its own rows)."""
        if not self.av_bucketing or self.mc.mode == "text":
            return {}
        av = self.mc.av_max_length
        g = self.av_bucket_granularity

        def bucket(need):
            return DEC._bucket(min(max(need, 1), av), av, granularity=g)

        caps = {"frames_cap": bucket(
            self._global_max(np.max(arrays["frames_len"])))}
        if self.mc.mode == "trimodal":
            caps["audio_cap"] = bucket(self._global_max(
                DEC.audio_examples_needed(self.mc, arrays["audio_len"])))
        return caps

    def run_epoch(self, epoch: int) -> float:
        bs = self.config.batch_size
        total, n = 0.0, 0
        rng_np = np.random.default_rng(self.config.seed + epoch)
        # reading a loss waits for the device: hold two steps in flight so
        # the next batch is packed and shipped while the device still runs
        pending: deque = deque()

        def drain(k: int):
            nonlocal total, n
            while len(pending) > k:
                loss, size = pending.popleft()
                with profiling.annotate("train.loss_read"):
                    total += float(loss) * size
                n += size

        for batch in self.train_ds.batches(bs, shuffle=True, rng=rng_np):
            arrays = batch_arrays(batch)
            caps = self.caps_for(arrays)
            variant = tuple(sorted(caps.items()))
            profiled = bool(self.profile_dir and not self._profiled
                            and variant in self._steps_used)
            with ExitStack() as traced:
                if profiled:
                    drain(0)  # the trace holds one step, not the backlog
                    traced.enter_context(profiling.trace(self.profile_dir))
                    traced.enter_context(profiling.annotate("train_step"))
                inputs = to_device(self._local_rows(arrays), self.device)
                self.train_state, metrics = self.train_step(
                    self.train_state, inputs, self.generator, **caps)
                pending.append((metrics["loss"], batch.size))
                # traced, the step's loss is read inside: the device too
                drain(0 if profiled else 2)
            self._profiled |= profiled
            self._steps_used.add(variant)
        drain(0)
        return total / max(n, 1)

    def validate(self) -> Dict[str, float]:
        shards = self.train_state.shards
        with shards.gathered() if shards is not None else nullcontext(), \
                model_axis.whole(self.train_state.model):
            return self._validate()

    def _validate(self) -> Dict[str, float]:
        bs = self.config.eval_batch_size
        loss_sum, n = 0.0, 0
        bleu_sums = {k: 0.0 for k in M.BLEU_WEIGHTS}
        mc = self.mc

        av = mc.av_max_length

        def dispatch(batch):
            arrays = batch_arrays(batch)
            # the JAX package validates uncapped; R(2+1)D's memories depend
            # on the frames cap (a defect of the reference, ROADMAP queue
            # 3), so it is validated at av_max_length as there; the others
            # give the same answers at their buckets (over every process's
            # rows, data-parallel)
            fneed = self._global_max(np.max(arrays["frames_len"]))
            aneed = self._global_max(
                DEC.audio_examples_needed(mc, arrays["audio_len"]))
            fcap = (av if mc.video_encoder == "resnet"
                    else DEC._bucket(max(1, min(fneed, av)), av))
            return self.validate_step(
                self.train_state.model,
                to_device(self._local_rows(arrays), self.device),
                DEC._bucket(max(1, min(aneed, av)), av), fcap)

        def finalize(out, batch):
            # every process's rows, in order, the padding's cut
            per_sample, toks = (multihost.to_host(x, self.group,
                                                  rows=len(batch.valid))
                                if self.group is not None
                                else x.cpu().numpy() for x in out)
            loss = float(per_sample[batch.valid].sum())
            suite, k = {}, 0
            if self.primary:
                suite, k = evaluate_bleu(toks, batch.questions,
                                         self.val_ds.index_to_word,
                                         batch.valid)
            return loss, suite, k, batch.size

        # the host scores batch i's BLEU while the device decodes i+1, i+2
        for loss, suite, k, size in pipelined(self.val_ds.batches(bs),
                                              dispatch, finalize):
            loss_sum += loss
            for key, v in suite.items():
                bleu_sums[key] += v * k
            n += size
        out = {"loss": loss_sum / max(n, 1)}
        out.update({k: v / max(n, 1) for k, v in bleu_sums.items()})
        return out

    def fit(self, epochs: Optional[int] = None) -> Tuple[Dict, int]:
        """Train, checkpointing "last" every epoch and "best" on a new best
        validation loss. An exception or SIGTERM (converted to
        KeyboardInterrupt while fit runs on the main thread) saves "last"
        and the stats before it propagates, so ``resume('last')`` restarts
        from the last completed epoch."""
        epochs = epochs or self.config.epochs
        prev_handler, installed = None, False
        if threading.current_thread() is threading.main_thread():
            def _on_term(signum, frame):
                raise KeyboardInterrupt("SIGTERM (preemption)")
            prev_handler = signal.signal(signal.SIGTERM, _on_term)
            installed = True
        try:
            return self._fit_inner(epochs)
        except BaseException:
            if self.start_epoch > 0 or self.epoch_stats["train"]["loss"]:
                last_done = len(self.epoch_stats["train"]["loss"]) - 1
                # no barrier: the other processes may not get here
                self.save("last", max(last_done, 0), sync=False)
                self.write_stats()
            raise
        finally:
            if installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None
                              else signal.SIG_DFL)
            ckpt.wait_for_pending()   # queued writes land before return

    def _fit_inner(self, epochs: int) -> Tuple[Dict, int]:
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            train_loss = self.run_epoch(epoch)
            val = self.validate()
            self.epoch_stats["train"]["loss"].append(train_loss)
            self.epoch_stats["val"]["loss"].append(val["loss"])
            for k in ("bleu", "bleu_1", "bleu_2", "bleu_3"):
                self.epoch_stats["val"][k].append(val[k])
            self.log(f"epoch {epoch}: train_loss={train_loss:.3f} "
                     f"val_loss={val['loss']:.3f} val_bleu={val['bleu']:.3f} "
                     f"({time.time() - t0:.1f}s)")
            improved = val["loss"] < self.best_val
            if improved:
                self.best_val = val["loss"]
                self.best_epoch = epoch
            self.save("last", epoch)
            if improved:
                ckpt.copy_checkpoint(
                    self.config.checkpoint_dir, "last", "best",
                    backend=getattr(self.config, "checkpoint_backend",
                                    "msgpack"),
                    async_copy=getattr(self.config, "checkpoint_async",
                                       False), group=self.ckpt_group)
        if self.profile_dir and not self._profiled:
            self.log("warning: --profile-dir set but no warm step was "
                     "traced (every batch hit a fresh AV-bucket variant: "
                     "too few batches per bucket)")
        self.write_stats()
        return self.epoch_stats, self.best_epoch

    # -------------------------------------------------------- persistence
    def save(self, alias: str, epoch: int, *, sync: bool = True) -> None:
        """Write the ``alias`` checkpoint: on the primary only, the other
        processes waiting at a barrier until it is published, or queued
        with ``checkpoint_async`` (unless ``sync`` is False: the path of a
        failure, where the other processes may not get here). A state split
        over the data axis is first gathered on every process (a
        collective), so after a failure (``sync`` False) it is not saved:
        ``last`` stays the last completed epoch's."""
        ts = self.train_state
        if (ts.shards is not None or ts.model.tp is not None) and not sync:
            self.log("warning: the train state is split over the mesh; "
                     "after a failure it is not gathered (a collective) and "
                     "not saved")
            return
        group = self.ckpt_group if sync else None
        if group is None and not self.primary:
            return
        if ts.model.tp is not None:
            host = ts.model.tp.host_state(ts)
        elif ts.shards is not None:
            host = ts.shards.host_state(ts)
        else:
            host = (train_state_to_numpy(ts.model, ts.opt_state, ts.step)
                    if self.primary else None)
        ckpt.save_checkpoint(
            self.config.checkpoint_dir, alias,
            host if self.primary else None,
            metadata={"epoch": epoch, "best_val": self.best_val,
                      "best_epoch": self.best_epoch,
                      "mode": self.mc.mode, "n_vocab": self.mc.n_vocab},
            backend=getattr(self.config, "checkpoint_backend", "msgpack"),
            async_save=getattr(self.config, "checkpoint_async", False),
            group=group)

    def resume(self, alias: str = "last") -> bool:
        """Restore a checkpoint (msgpack or orbax, the port's or the JAX
        package's) and its epoch, best validation loss and stats history.
        False when there is none. Every process calls it: the primary's
        queued writes land first (``wait_for_pending``'s barrier), and a
        state split over the data axis keeps each process's slices."""
        ckpt_dir = self.config.checkpoint_dir
        ckpt.wait_for_pending(self.ckpt_group)
        if not ckpt.has_checkpoint(ckpt_dir, alias):
            return False
        ts = self.train_state
        state = ckpt.load_checkpoint(ckpt_dir, alias)
        if ts.model.tp is not None:
            ts.model.tp.load(ts, state)
        elif ts.shards is not None:
            ts.shards.load(ts, state)
        else:
            ts.opt_state, ts.step = load_train_state(ts.model, state,
                                                     ts.opt_state)
        meta = ckpt.load_metadata(ckpt_dir, alias)
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_val = float(meta.get("best_val", float("inf")))
        self.best_epoch = int(meta.get("best_epoch", -1))
        # keep the pre-resume epochs' curves, cut to the completed epochs
        try:
            with open(self.config.stats_json_path) as f:
                prior = json.load(f)
            for section, series in self.epoch_stats.items():
                for key in series:
                    series[key] = list(
                        prior.get(section, {}).get(key, []))[:self.start_epoch]
        except (FileNotFoundError, json.JSONDecodeError):
            pass
        return True

    def write_stats(self) -> None:
        """stats.json and the config snapshot (``config.json``), by the
        primary."""
        if not self.primary:
            return
        self.config.ensure_dirs()
        with open(self.config.stats_json_path, "w") as f:
            json.dump(self.epoch_stats, f)
        self.config.save()


# ---------------------------------------------------------------- the CLI

def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train the QG model (PyTorch port)")
    parser.add_argument("-c", "--config_path", type=str, default=None)
    parser.add_argument("--mode", type=str, default="trimodal",
                        choices=["text", "text_video", "trimodal"])
    parser.add_argument("--decoder", type=str, default="attn",
                        choices=["attn", "non_attn"])
    parser.add_argument("--video-encoder", type=str, default=None,
                        choices=["conv_lstm", "resnet"],
                        help="video backbone: conv_lstm or resnet "
                             "(R(2+1)D-18); overrides config video_encoder "
                             "and is recorded in the saved config snapshot")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="resume from a checkpoint (the port's or the "
                             "JAX package's msgpack)")
    parser.add_argument("--resume-alias", default="last",
                        help="checkpoint alias --resume starts from")
    parser.add_argument("--data-parallel", action="store_true",
                        help="train over every visible card: one worker "
                             "process per card, each with its row block of "
                             "every batch; gradients and batchnorm "
                             "statistics all-reduce over NCCL (gloo for "
                             "--device cpu, one worker a process)")
    parser.add_argument("--zero1", action="store_true",
                        help="ZeRO-1: split the optimizer state 1/dp over "
                             "the data axis (with --data-parallel); the "
                             "gradients reduce-scatter and the parameters "
                             "all-gather, the same volume as the "
                             "all-reduce; sets config zero1")
    parser.add_argument("--fsdp", action="store_true",
                        help="FSDP: split the parameters 1/dp over the "
                             "data axis too (implies --zero1; with "
                             "--data-parallel); gathered at the start of "
                             "each step and freed after the update; sets "
                             "config fsdp")
    parser.add_argument("--sequence-parallel", action="store_true",
                        help="training-side SP: split the context axis of "
                             "the text attention memory over the mesh's "
                             "model axis (needs --data-parallel and "
                             "mesh_shape with model axis > 1); sets config "
                             "sequence_parallel_train")
    parser.add_argument("--sp-gather-free", action="store_true",
                        help="with --sequence-parallel: run the decoder's "
                             "text attention as the gather-free "
                             "distributed softmax (O(B*H) communication a "
                             "step whatever the context length, "
                             "ops/attention_sp.py) instead of gathering "
                             "the memory once; sets config sp_gather_free")
    parser.add_argument("--streaming", action="store_true",
                        help="stream batches from disk (double-buffered "
                             "C++ pack pool) instead of materialising the "
                             "corpus in host RAM; data-parallel, each "
                             "process packs its own rows only (the "
                             "default of --data-parallel's per-card "
                             "workers, which would otherwise each hold "
                             "the whole corpus)")
    parser.add_argument("--grad-accum", type=int, default=None,
                        help="gradient-accumulation microbatches per "
                             "optimizer update (overrides config "
                             "grad_accum_steps)")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace (Chrome/perfetto "
                             "JSON) of one warm train step into this "
                             "directory")
    parser.add_argument("--nan-debug", action="store_true",
                        help="raise at the first non-finite value: "
                             "autograd anomaly mode for the backward, and "
                             "each module's and autograd Function's "
                             "forward output checked, naming where it "
                             "came from")
    parser.add_argument("--multihost", action="store_true",
                        help="join a multi-process run: one command per "
                             "host, combine with --data-parallel for DP "
                             "across hosts (global rank = process id x "
                             "local cards + local index); rank 0 owns "
                             "checkpoints and stats")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port where --multihost processes meet "
                             "(omit to read MASTER_ADDR/MASTER_PORT)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; the kernels run there) or "
                             "'cpu' (the kernels' plain versions)")
    return parser


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _train(args, device: torch.device, rank: int, world: int,
           coordinator: Optional[str], data_parallel: bool) -> None:
    """One training process: joins the process group when ``world`` > 1
    (data-parallel over it when ``data_parallel``), loads the splits and
    trains."""
    if world > 1:
        multihost.initialize_multihost(coordinator, world, rank,
                                       device=device)
    try:
        config = (Config.load(args.config_path) if args.config_path
                  else Config())
        if args.grad_accum:
            config = config.replace(grad_accum_steps=args.grad_accum)
        if args.video_encoder:
            config = config.replace(video_encoder=args.video_encoder)
        if args.zero1:
            config = config.replace(zero1=True)
        if args.fsdp:
            config = config.replace(fsdp=True)
        config = _sp_flags(args, config)
        if multihost.is_primary():
            config.ensure_dirs()
        multihost.barrier()     # the others find the directories made
        group = dist.group.WORLD if data_parallel and world > 1 else None
        grid = None
        if group is not None and tuple(config.mesh_shape) != (1, 1):
            # an explicit (data, model) layout over the processes
            grid = multihost.Grid(tuple(config.mesh_shape), group)
            group = grid.data_group
        load_media = args.mode != "text"
        if args.streaming:
            # data-parallel: each process packs media for its rows only
            def split(path, bs):
                return StreamingLoader(
                    config, path, batch_size=bs, load_media=load_media,
                    local_rows=(multihost.loader_local_rows(bs, group)
                                if group is not None else None))
            train_ds = split(config.train_file, config.batch_size)
            val_ds = split(config.val_file, config.eval_batch_size)
        else:
            train_ds = QGDataset(config, config.train_file,
                                 load_media=load_media)
            val_ds = QGDataset(config, config.val_file, load_media=True)
        mc = qg_model.ModelConfig.from_config(
            config, n_vocab=len(train_ds.vocab), mode=args.mode,
            dec=args.decoder)
        qg_model.check_supported(mc)
        emb = np.load(config.weights_matrix_file).astype(np.float32)
        trainer = Trainer(config, mc, emb, train_ds, val_ds, device=device,
                          process_group=None if grid is not None else group,
                          grid=grid, profile_dir=args.profile_dir)
        if args.resume and trainer.resume(args.resume_alias):
            trainer.log(f"resumed at epoch {trainer.start_epoch} "
                        f"(alias {args.resume_alias!r})")
        with profiling.nan_debugging(args.nan_debug,
                                     model=trainer.train_state.model):
            _, best_epoch = trainer.fit(args.epochs)
        trainer.log(f"Best epoch - {best_epoch} !")
        trainer.log("Done !")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _sp_flags(args, config):
    """``--sequence-parallel`` and ``--sp-gather-free`` into the config,
    with the JAX CLI's check."""
    if args.sequence_parallel:
        config = config.replace(sequence_parallel_train=True)
    if args.sp_gather_free:
        if not (args.sequence_parallel or config.sequence_parallel_train):
            raise SystemExit("--sp-gather-free requires --sequence-parallel "
                             "(it selects HOW the SP attention communicates)")
        config = config.replace(sp_gather_free=True)
    return config


def _check_mesh(config, world: int) -> None:
    """SystemExit unless ``config.mesh_shape`` is (1, 1) (every process on
    the data axis) or a ``(data, model)`` layout of the ``world``
    processes, as the JAX CLI's ``make_mesh`` requires of its devices."""
    if tuple(config.mesh_axis_names) != ("data", "model"):
        raise SystemExit("mesh_axis_names must stay ('data', 'model'): the "
                         "sharding rules (parallel/mesh.py) name those axes")
    shape = tuple(config.mesh_shape)
    if shape != (1, 1) and shape[0] * shape[1] != world:
        raise SystemExit(f"mesh shape {shape} != {world} devices")


def _worker(args, devices, base: int, world: int, coordinator: str,
            local: int) -> None:
    """Entry point of a spawned per-card process."""
    device = devices[local]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _train(args, device, base + local, world, coordinator, True)


def _spawn(args, devices, base: int, world: int, coordinator: str) -> None:
    """One process per local device, started together; the first to fail
    stops the others (they would wait at a collective)."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(args, devices, base, world,
                                                coordinator, i))
             for i in range(len(devices))]
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed:
                raise SystemExit(f"training worker {procs.index(failed[0])} "
                                 f"exited with {failed[0].exitcode}")
            time.sleep(0.5)
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise SystemExit(f"training workers exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()


def main(argv: Optional[List[str]] = None) -> None:
    """``mmqg-train`` (``cli.train_main``) for the port.

    ``--data-parallel`` trains over every visible card, as the JAX CLI's
    mesh does, in the port's idiom: one worker process per card (spawned
    here, the kernels built first so that the workers find them), joined
    by NCCL. The workers stream their batches (``--streaming`` is
    implied), so the host holds no copy of the corpus per card.
    ``--multihost`` runs one such command per host: each host's cards take
    global ranks ``process_id x local cards + local index``, and
    the group meets at ``--coordinator``. On the CPU (``--device cpu``) a
    process is one worker over gloo, so a CPU data-parallel run is
    ``--multihost`` processes."""
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to train on the CPU")
    if args.data_parallel and device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    per_host = len(devices) if args.data_parallel else 1
    if args.multihost:
        if args.coordinator is not None and (args.num_processes is None
                                             or args.process_id is None):
            raise SystemExit("--coordinator needs --num-processes and "
                             "--process-id")
        nproc = args.num_processes or int(os.environ.get("WORLD_SIZE", 1))
        pid = (args.process_id if args.process_id is not None
               else int(os.environ.get("RANK", 0)))
        world, base, coordinator = nproc * per_host, pid * per_host, \
            args.coordinator
        if not args.data_parallel:
            # without a data axis each process trains an identical copy,
            # and all but rank 0's are thrown away
            print("warning: --multihost without --data-parallel runs N "
                  "identical copies of the job (no data axis spans the "
                  "processes); add --data-parallel to shard the batch "
                  "across hosts")
    else:
        world, base = per_host, 0
        coordinator = f"localhost:{_free_port()}" if world > 1 else None
    config = _sp_flags(args, Config.load(args.config_path)
                       if args.config_path else Config())
    if args.data_parallel and world > 1:
        _check_mesh(config, world)
    if args.data_parallel:
        if world > 1:
            shape = tuple(config.mesh_shape)
            print(f"data-parallel over {world} processes ({per_host} on "
                  "this host)" + ("" if shape == (1, 1) else
                                  f", mesh (data, model) {shape}"))
        else:
            print("warning: --data-parallel requested but only one device "
                  "is visible; training single-device")
    if args.multihost and coordinator is None and world > 1 \
            and per_host > 1:
        # env:// would give every local worker the host's RANK
        raise SystemExit("--multihost --data-parallel over several local "
                         "cards needs --coordinator")
    if per_host > 1:
        if not args.streaming:
            # a materialised split would be held once per worker
            print(f"data-parallel: the {per_host} workers stream their "
                  "batches, each packing only its own rows' media")
            args.streaming = True
        native.get_lib()  # built once, before the workers look for it
        if device.type == "cuda":
            from mmqg_tpu_torch.ops import _build
            _build.library()
        _spawn(args, devices, base, world, coordinator)
    else:
        _train(args, devices[0], base, world, coordinator,
               args.data_parallel)


if __name__ == "__main__":
    main()
