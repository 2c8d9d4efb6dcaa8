"""Training for the PyTorch port (``mmqg_tpu/train.py``).

    python -m mmqg_tpu_torch.train -c config.json --epochs 10   # on the card
    python -m mmqg_tpu_torch.train -c config.json --device cpu
    python -m mmqg_tpu_torch.train -c config.json --data-parallel  # all cards

One train step: ``qg_model.loss_fn`` (train-mode encode, the text and video
LSTMs through K4, teacher-forced decode) under autograd, in any mode,
decoder and video backbone (``--mode``, ``--decoder``,
``--video-encoder``), then the optimizer of ``mmqg_tpu_torch.optim``
(optax's Adam/AdamW/SGD, schedules, clipping and the
``text_non_trainable`` freeze, in optax's state layout). Validation
is the greedy-fed CE decode through K1 and K2 plus BLEU. Checkpoints are the
JAX package's msgpack train state, so each package resumes the other's.

Data parallelism (``--data-parallel``, ``--multihost``; ``Trainer``'s
``process_group``) runs one process per device, each with its row block of
every global batch, and all-reduces what one program over the global
batch would share: the valid count, the batchnorm statistics and the
gradients. ``--streaming`` reads batches with ``data.streaming``'s pack
pool. Not ported: the model axis of the mesh (tensor and sequence
parallelism, ZeRO-1/FSDP; ROADMAP item 19b), ``--profile-dir`` and
``--nan-debug`` (item 21), orbax and asynchronous checkpoints (item 23);
``--compile-cache`` is left out (nothing is compiled ahead). ``Config``,
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
from dataclasses import dataclass
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
                                  tree_leaves, tree_map)
from mmqg_tpu_torch.parallel import multihost
from mmqg_tpu_torch.parallel.mesh import (Mesh, pad_batch, padded_rows,
                                          row_block)
from mmqg_tpu_torch.parallel.multihost import all_reduce_flat
from mmqg_tpu_torch.utils.device import resolve_device
from mmqg_tpu_torch.utils.pipelining import pipelined

Tensor = torch.Tensor

__all__ = ["TrainState", "Trainer", "batch_arrays", "evaluate_bleu",
           "init_train_state", "learning_rate_schedule", "make_optimizer",
           "make_train_step", "make_validate_step", "to_device"]


@dataclass
class TrainState:
    """The model (parameters and batchnorm state), the optimizer state in
    optax's layout, and the number of optimizer updates taken."""
    model: qg_model.QGModel
    opt_state: Any
    step: int = 0


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


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


StepFn = Callable[..., Tuple[TrainState, Dict[str, Tensor]]]


def make_train_step(mc: qg_model.ModelConfig, optimizer: Transform, *,
                    dtype: torch.dtype = torch.bfloat16,
                    accum_steps: int = 1, process_group=None) -> StepFn:
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
    of its block."""
    group = process_group
    def train_step(ts: TrainState, batch: Dict[str, Tensor], generator, *,
                   audio_cap: Optional[int] = None,
                   frames_cap: Optional[int] = None):
        A = accum_steps
        B = batch["target_ids"].shape[0]
        if B % A:
            raise ValueError(f"batch {B} not divisible by accum_steps {A}")
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
            obj, aux = qg_model.loss_fn(
                ts.model, mc, mb, train=True, generator=generator,
                dtype=dtype, audio_cap=audio_cap, frames_cap=frames_cap)
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
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                         else p.grad, params)
        if group is not None:
            leaves = []
            tree_map(leaves.append, grads)
            summed = iter(all_reduce_flat(leaves, group))
            grads = tree_map(lambda _: next(summed), grads)
        updates, ts.opt_state = optimizer.update(grads, ts.opt_state, params)
        apply_updates(params, updates)
        metrics["grad_norm"] = global_norm(grads).detach()
        for p in tree_leaves(params):
            p.grad = None
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
    step, averaged per sample over its target length."""
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
        for t in range(T):
            logits, state, _ = dec.step(model.embedding, tok, inputs, state,
                                        dtype=dtype)
            logp = torch.log_softmax(logits.float(), dim=-1)
            ces.append(-logp.gather(-1, target[:, t:t + 1])[:, 0])
            tok = torch.argmax(logits, dim=-1)
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
    from a generator seeded with (seed, rank). ZeRO-1 and FSDP over the
    data axis (``config.zero1``/``fsdp``) are ROADMAP item 19b and raise;
    without a data axis they are no-ops, as in the JAX package."""

    def __init__(self, config, mc: qg_model.ModelConfig, emb_weights,
                 train_ds: QGDataset, val_ds: QGDataset, *, device="cuda",
                 mesh: Optional[Mesh] = None, process_group=None,
                 log_fn=print):
        qg_model.check_supported(mc)
        self.config = config
        self.mc = mc
        self.device = torch.device(device)
        self.dtype = torch.bfloat16
        self.optimizer = make_optimizer(config)
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.accum_steps = getattr(config, "grad_accum_steps", 1) or 1
        if mesh is not None and process_group is None and mesh.dp > 1:
            process_group = dist.group.WORLD
        self.rank, self.dp = (multihost.world(process_group)
                              if process_group is not None else (0, 1))
        if mesh is not None and mesh.dp != self.dp:
            raise ValueError(f"{mesh} has a data axis of {mesh.dp}, but the "
                             f"process group has {self.dp} processes (one "
                             "process per device of the data axis)")
        # the group the collectives run over: none on one device
        self.group = process_group if self.dp > 1 else None
        # checkpoints and stats: the primary of every process there is
        self.primary = multihost.is_primary()
        self.ckpt_group = (self.group if self.group is not None else
                           dist.group.WORLD if multihost.world()[1] > 1
                           else None)
        self.log = log_fn if self.primary else (lambda *a, **k: None)
        if self.group is not None:
            if getattr(config, "zero1", False) or getattr(config, "fsdp",
                                                          False):
                raise NotImplementedError(
                    "zero1/fsdp: sharding the optimizer state or the "
                    "parameters over the data axis is not ported (ROADMAP "
                    "queue 1, item 19b)")
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
        self.train_step = make_train_step(mc, self.optimizer,
                                          dtype=self.dtype,
                                          accum_steps=self.accum_steps,
                                          process_group=self.group)
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
                total += float(loss) * size
                n += size

        for batch in self.train_ds.batches(bs, shuffle=True, rng=rng_np):
            arrays = batch_arrays(batch)
            caps = self.caps_for(arrays)
            self.train_state, metrics = self.train_step(
                self.train_state,
                to_device(self._local_rows(arrays), self.device),
                self.generator, **caps)
            pending.append((metrics["loss"], batch.size))
            drain(2)
        drain(0)
        return total / max(n, 1)

    def validate(self) -> Dict[str, float]:
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
        self.write_stats()
        return self.epoch_stats, self.best_epoch

    # -------------------------------------------------------- persistence
    def save(self, alias: str, epoch: int, *, sync: bool = True) -> None:
        """Write the ``alias`` checkpoint: on the primary only, the other
        processes waiting until it is published (unless ``sync`` is
        False)."""
        group = self.ckpt_group if sync else None
        if group is None and not self.primary:
            return
        ts = self.train_state
        ckpt.save_checkpoint(
            self.config.checkpoint_dir, alias,
            train_state_to_numpy(ts.model, ts.opt_state, ts.step)
            if self.primary else None,
            metadata={"epoch": epoch, "best_val": self.best_val,
                      "best_epoch": self.best_epoch,
                      "mode": self.mc.mode, "n_vocab": self.mc.n_vocab},
            backend=getattr(self.config, "checkpoint_backend", "msgpack"),
            async_save=getattr(self.config, "checkpoint_async", False),
            group=group)

    def resume(self, alias: str = "last") -> bool:
        """Restore a msgpack checkpoint (the port's or the JAX package's)
        and its epoch, best validation loss and stats history. False when
        there is none."""
        ckpt_dir = self.config.checkpoint_dir
        if not ckpt.has_checkpoint(ckpt_dir, alias):
            return False
        ts = self.train_state
        ts.opt_state, ts.step = load_train_state(
            ts.model, ckpt.load_checkpoint(ckpt_dir, alias), ts.opt_state)
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
        if multihost.is_primary():
            config.ensure_dirs()
        multihost.barrier()     # the others find the directories made
        group = dist.group.WORLD if data_parallel and world > 1 else None
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
                          process_group=group)
        if args.resume and trainer.resume(args.resume_alias):
            trainer.log(f"resumed at epoch {trainer.start_epoch} "
                        f"(alias {args.resume_alias!r})")
        _, best_epoch = trainer.fit(args.epochs)
        trainer.log(f"Best epoch - {best_epoch} !")
        trainer.log("Done !")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


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
    if args.data_parallel:
        if world > 1:
            print(f"data-parallel over {world} processes ({per_host} on "
                  "this host)")
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
        native.get_host_lib()  # built once, before the workers look for it
        if device.type == "cuda":
            from mmqg_tpu_torch.ops import _build
            _build.library()
        _spawn(args, devices, base, world, coordinator)
    else:
        _train(args, devices[0], base, world, coordinator,
               args.data_parallel)


if __name__ == "__main__":
    main()
