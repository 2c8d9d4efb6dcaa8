"""Training for the PyTorch port (``mmqg_tpu/train.py``), on one device.

    python -m mmqg_tpu_torch.train -c config.json --epochs 10   # on the card
    python -m mmqg_tpu_torch.train -c config.json --device cpu

One train step: ``qg_model.loss_fn`` (train-mode encode, the text and video
LSTMs through K4, teacher-forced decode) under autograd, in any mode,
decoder and video backbone (``--mode``, ``--decoder``,
``--video-encoder``), then the optimizer of ``mmqg_tpu_torch.optim``
(optax's Adam/AdamW/SGD, schedules, clipping and the
``text_non_trainable`` freeze, in optax's state layout). Validation
is the greedy-fed CE decode through K1 and K2 plus BLEU. Checkpoints are the
JAX package's msgpack train state, so each package resumes the other's.

The JAX Trainer's mesh, multihost, streaming, profile, nan-debug,
compile-cache, orbax and asynchronous-checkpoint options are not ported
(ROADMAP queue 1, items 19, 21, 22 and 23). ``Config``, ``QGDataset``, BLEU
and the pipelining helper are the port's own copies of the JAX package's
modules; either package's ``config.json`` loads.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch import metrics as M
from mmqg_tpu_torch.compat.from_jax import (load_train_state,
                                            params_from_numpy,
                                            train_state_to_numpy)
from mmqg_tpu_torch.config import Config
from mmqg_tpu_torch.data.dataset import Batch, QGDataset
from mmqg_tpu_torch.data.vocab import START_ID
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.optim import (Transform, apply_updates, global_norm,
                                  learning_rate_schedule, make_optimizer,
                                  tree_leaves, tree_map)
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
                    accum_steps: int = 1) -> StepFn:
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
    statistics advance once per microbatch, in order."""
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
        n_all = torch.clamp(batch["valid"].sum().float(), min=1.0)
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
        ntok = torch.clamp(sum(p[4] for p in parts), min=1)
        metrics = {"objective": sum(w * o for w, o, _, _, _ in parts),
                   "loss": sum(w * ls for w, _, ls, _, _ in parts),
                   "loss_per_token": sum(lt * (n / ntok)
                                         for _, _, _, lt, n in parts)}
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                         else p.grad, params)
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
    """The training driver (``train.Trainer``) on one device: AV-bucketed
    train steps, lag-2 metric reads, validation with BLEU, best/last
    msgpack checkpoints, resume, SIGTERM-safe ``fit`` and ``stats.json``.

    ``device`` is where the model trains; it computes in bfloat16, as the
    JAX trainer does."""

    def __init__(self, config, mc: qg_model.ModelConfig, emb_weights,
                 train_ds: QGDataset, val_ds: QGDataset, *, device="cuda",
                 log_fn=print):
        qg_model.check_supported(mc)
        self.config = config
        self.mc = mc
        self.device = torch.device(device)
        self.dtype = torch.bfloat16
        self.optimizer = make_optimizer(config)
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.log = log_fn
        self.accum_steps = getattr(config, "grad_accum_steps", 1) or 1
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.train_state = init_train_state(mc, emb_weights, self.optimizer,
                                            seed=config.seed,
                                            device=self.device)
        self.train_step = make_train_step(mc, self.optimizer,
                                          dtype=self.dtype,
                                          accum_steps=self.accum_steps)
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

    # ------------------------------------------------------------- epochs
    def caps_for(self, arrays: Dict[str, np.ndarray]) -> Dict[str, int]:
        """The ``audio_cap``/``frames_cap`` keywords of the train step for
        this batch (``train.Trainer._step_for``): its AV buckets at
        ``train_av_bucket_granularity``, from the host arrays (no device
        round trip), for the modalities the mode encodes; none in mode
        text or without AV bucketing."""
        if not self.av_bucketing or self.mc.mode == "text":
            return {}
        av = self.mc.av_max_length
        g = self.av_bucket_granularity

        def bucket(need):
            return DEC._bucket(min(max(need, 1), av), av, granularity=g)

        caps = {"frames_cap": bucket(int(np.max(arrays["frames_len"])))}
        if self.mc.mode == "trimodal":
            caps["audio_cap"] = bucket(DEC.audio_examples_needed(
                self.mc, arrays["audio_len"]))
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
            self.train_state, metrics = self.train_step(
                self.train_state, to_device(arrays, self.device),
                self.generator, **self.caps_for(arrays))
            pending.append((metrics["loss"], batch.size))
            drain(2)
        drain(0)
        return total / max(n, 1)

    def validate(self) -> Dict[str, float]:
        bs = self.config.eval_batch_size
        loss_sum, n = 0.0, 0
        bleu_sums = {k: 0.0 for k in M.BLEU_WEIGHTS}
        mc = self.mc

        def dispatch(batch):
            arrays = batch_arrays(batch)
            # the JAX package validates uncapped; R(2+1)D's memories depend
            # on the frames cap (a defect of the reference, ROADMAP queue
            # 3), so it is validated at av_max_length as there; the others
            # give the same answers at their buckets
            fcap = (mc.av_max_length if mc.video_encoder == "resnet"
                    else DEC.frames_bucket(mc, arrays["frames_len"]))
            return self.validate_step(
                self.train_state.model, to_device(arrays, self.device),
                DEC.audio_bucket(mc, arrays["audio_len"]), fcap)

        def finalize(out, batch):
            per_sample, toks = (x.cpu().numpy() for x in out)
            loss = float(per_sample[batch.valid].sum())
            suite, k = evaluate_bleu(toks, batch.questions,
                                     self.val_ds.index_to_word, batch.valid)
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
                self.save("last", max(last_done, 0))
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
                                       False))
        self.write_stats()
        return self.epoch_stats, self.best_epoch

    # -------------------------------------------------------- persistence
    def save(self, alias: str, epoch: int) -> None:
        ts = self.train_state
        ckpt.save_checkpoint(
            self.config.checkpoint_dir, alias,
            train_state_to_numpy(ts.model, ts.opt_state, ts.step),
            metadata={"epoch": epoch, "best_val": self.best_val,
                      "best_epoch": self.best_epoch,
                      "mode": self.mc.mode, "n_vocab": self.mc.n_vocab},
            backend=getattr(self.config, "checkpoint_backend", "msgpack"),
            async_save=getattr(self.config, "checkpoint_async", False))

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
        """stats.json and the config snapshot (``config.json``)."""
        self.config.ensure_dirs()
        with open(self.config.stats_json_path, "w") as f:
            json.dump(self.epoch_stats, f)
        self.config.save()


# ---------------------------------------------------------------- the CLI

def main(argv: Optional[List[str]] = None) -> None:
    """``mmqg-train`` (``cli.train_main``) for the port."""
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
    parser.add_argument("--grad-accum", type=int, default=None,
                        help="gradient-accumulation microbatches per "
                             "optimizer update (overrides config "
                             "grad_accum_steps)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; the kernels run there) or "
                             "'cpu' (the kernels' plain versions)")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to train on the CPU")
    config = Config.load(args.config_path) if args.config_path else Config()
    if args.grad_accum:
        config = config.replace(grad_accum_steps=args.grad_accum)
    if args.video_encoder:
        config = config.replace(video_encoder=args.video_encoder)
    config.ensure_dirs()
    train_ds = QGDataset(config, config.train_file,
                         load_media=args.mode != "text")
    mc = qg_model.ModelConfig.from_config(config, n_vocab=len(train_ds.vocab),
                                          mode=args.mode, dec=args.decoder)
    qg_model.check_supported(mc)
    val_ds = QGDataset(config, config.val_file, load_media=True)
    emb = np.load(config.weights_matrix_file).astype(np.float32)
    trainer = Trainer(config, mc, emb, train_ds, val_ds, device=device)
    if args.resume and trainer.resume(args.resume_alias):
        print(f"resumed at epoch {trainer.start_epoch} "
              f"(alias {args.resume_alias!r})")
    _, best_epoch = trainer.fit(args.epochs)
    print(f"Best epoch - {best_epoch} !")
    print("Done !")


if __name__ == "__main__":
    main()
