"""Training: ``Trainer.run_epoch`` over an in-memory corpus, epoch after
epoch, for the whole window.

Set-up builds one ``Trainer`` (its model and Adam state) on the seeded
weights, fills its ``QGDataset`` with the corpus from the seed, and runs
the first epoch through ``run_epoch`` itself, which warms every AV bucket
the corpus has. Its first ``mix["follow_steps"]`` steps are recorded as
they happen (each step's loss, the first gradient from Adam's first
moment after step one, the change of every leaf after the last step
followed, and which corpus rows each batch held); that same object then
runs the window. The judge has the f32 reference follow the same steps on
the same rows from the same weights.

End to end: ``train_samples_per_s``, the samples of the epochs the window
ran over the time from its start to the end of its last epoch. Traced
run: the profiler over the first ``mix["trace_steps"]`` steps of one more
``run_epoch``, then four single steps timed apart, each ending in a
synchronise.
"""

from __future__ import annotations

import itertools
import json
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from mmqg_tpu_torch.config import Config
from mmqg_tpu_torch.data.dataset import QGDataset
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.optim import tree_leaves
from mmqg_tpu_torch.train import Trainer, batch_arrays, to_device
from portbench import gen, trace
from portbench.reference import inputs as RI
from portbench.reference import train as RT

B1 = 0.9   # Adam's first-moment decay: mu after one step is (1 - B1) g


def trainer_config(cfg: Dict, mix: Dict, seed: int, out: Path) -> Config:
    """The ``Config`` the Trainer reads, from the configuration's widths
    and the mix's job settings."""
    return Config(
        output_path=out, glove_emb_dim=cfg["word_emb_dim"],
        text_lstm_hidden_dim=cfg["hidden_dim"],
        dec_lstm_hidden_dim=cfg["hidden_dim"],
        text_lstm_layers=cfg["text_layers"], dec_lstm_layers=cfg["dec_layers"],
        text_lstm_dropout=cfg["text_dropout"], dec_lstm_dropout=cfg["dropout"],
        video_hidden_dim=cfg["video_hidden_dim"],
        audio_emb=cfg["audio_emb_dim"],
        flatten_dim=cfg["flatten_dim"], frame_size=cfg["frame_size"],
        context_max_length=cfg["context_max_length"],
        av_max_length=cfg["av_max_length"],
        question_max_length=cfg["target_steps"] - 1,
        batch_size=mix["batch"], lr=mix["lr"], optim="adam",
        seed=int(seed) & 0x7FFFFFFF, train_av_bucketing=True)


def build(run, stage: Path):
    cfg, mix = run.cfg, run.mix
    pipe_params = run.model_weights()
    corpus = gen.train_corpus(cfg, mix, run.seed, run.device)
    N = len(corpus["contexts"])
    records = [{"context": c, "question": q, "question_id": i,
                "video_id": i} for i, (c, q) in
               enumerate(zip(corpus["contexts"], corpus["questions"]))]
    qfile = stage / "train_questions.json"
    qfile.write_text(json.dumps(records))
    config = trainer_config(cfg, mix, run.seed, stage / "out")
    ds = QGDataset(config, qfile, vocab=run.vocab,
                   index_to_word=run.index_to_word, load_media=False)
    for i in range(N):
        f = corpus["frames"][i][:cfg["av_max_length"]]
        ds.frames[i, :len(f)] = f
        ds.frames_len[i] = max(1, len(f))
        a = corpus["audio"][i]
        if a is not None:
            s = min(len(a), ds.audio_pcm.shape[1])
            ds.audio_pcm[i, :s] = a[:s]
            ds.audio_len[i] = s
    params, state = pipe_params
    mc = run.model_config()
    trainer = Trainer(config, mc, params["embedding"]["table"], ds, ds,
                      device=run.device, log_fn=lambda *a, **k: None)
    model = trainer.train_state.model
    ours = RT.leaves(params)
    with torch.no_grad():
        for name, p in RT.leaves(qg_model.param_tree(model)).items():
            p.copy_(torch.from_numpy(ours[name]))
        if "video_enc" in state:
            for bn, st in zip(model.video_enc.bns, state["video_enc"]["bns"]):
                bn.mean.copy_(torch.from_numpy(st["mean"]))
                bn.var.copy_(torch.from_numpy(st["var"]))
    return trainer, ds, corpus


class Follow:
    """Wraps the Trainer's step for its first ``n`` steps: records each
    step's rows and loss, the first gradient's leaf norms and the leaf
    norms of the change after step ``n``."""

    def __init__(self, trainer: Trainer, n: int, ds: QGDataset):
        self.trainer, self.n, self.step_fn = trainer, n, trainer.train_step
        self.k = 0
        self.rows: List[List[int]] = []
        self.loss: List[torch.Tensor] = []
        self.grad: Dict[str, float] = {}
        self.grad_vectors: Dict[str, torch.Tensor] = {}
        self.change: Dict[str, float] = {}
        self.first = None
        self.index = {ds.context_ids[i].tobytes() + ds.target_ids[i].tobytes():
                      i for i in range(len(ds))}

    def __call__(self, ts, batch, generator, **caps):
        self.k += 1
        if self.k > self.n:
            return self.step_fn(ts, batch, generator, **caps)
        ctx = batch["context_ids"].cpu().numpy()
        tgt = batch["target_ids"].cpu().numpy()
        self.rows.append([self.index[c.tobytes() + t.tobytes()]
                          for c, t in zip(ctx, tgt)])
        named = RT.leaves(qg_model.param_tree(ts.model))
        if self.k == 1:
            self.first = {n: p.detach().clone() for n, p in named.items()}
        ts, metrics = self.step_fn(ts, batch, generator, **caps)
        self.loss.append(metrics["loss"].detach().clone())
        with torch.no_grad():
            if self.k == 1:
                mu = RT.leaves(ts.opt_state[0]["mu"])
                self.grad = {n: float(mu[n].norm()) / (1 - B1) for n in mu}
                self.grad_vectors = {n: (mu[n] / (1 - B1)).cpu()
                                     for n in mu}
            if self.k == self.n:
                self.change = {n: float((p - self.first[n]).norm())
                               for n, p in named.items()}
                self.first = None
        return ts, metrics


class Stretch:
    """The first ``k`` batches of every epoch of ``ds``, recording the rows
    they hold: ``run_epoch`` over it is a stretch of a whole epoch."""

    def __init__(self, ds: QGDataset, k: int):
        self.ds, self.k = ds, k
        self.rows: List[int] = []

    def batches(self, *args, **kw):
        for batch in itertools.islice(self.ds.batches(*args, **kw), self.k):
            self.rows.extend(int(i) for i in batch.question_id[batch.valid])
            yield batch


def drive(run) -> Dict:
    stage = Path(tempfile.mkdtemp(prefix="portbench-train-"))
    try:
        return _drive(run, stage)
    finally:
        shutil.rmtree(stage, ignore_errors=True)


def _drive(run, stage: Path) -> Dict:
    cfg, mix = run.cfg, run.mix
    trainer, ds, corpus = build(run, stage)
    on_card = run.device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    follow = Follow(trainer, mix["follow_steps"], ds)
    trainer.train_step = follow
    trainer.run_epoch(0)                # the first steps and every bucket
    trainer.train_step = follow.step_fn
    sync()

    t0 = run.window_start()
    epochs, end = 0, t0
    while end - t0 < run.seconds or not epochs:
        epochs += 1
        trainer.run_epoch(epochs)
        end = time.perf_counter()
    e2e = {"train_samples_per_s": epochs * len(ds) / (end - t0)}

    layer: Dict = {}
    tr = None
    if run.trace:
        caps: List[Dict] = []
        step_fn = trainer.train_step

        def record(ts, batch, generator, **kw):
            caps.append(dict(kw, rows=batch["target_ids"].shape[0]))
            return step_fn(ts, batch, generator, **kw)
        trainer.train_step = record
        stretch = Stretch(ds, mix["trace_steps"])
        trainer.train_ds = stretch
        tr = trace.capture(lambda: trainer.run_epoch(epochs + 1))
        trainer.train_ds = ds
        trainer.train_step = step_fn
        layer["steps"] = caps
        layer["train_flops"] = 3.0 * sum(_sample_flops(cfg, ds, i)
                                         for i in stretch.rows)
        spans = []
        rng = np.random.default_rng(0)
        for k, batch in enumerate(ds.batches(mix["batch"], shuffle=True,
                                             rng=rng)):
            if k == 4:
                break
            sync()
            a = time.perf_counter()
            arrays = batch_arrays(batch)
            kw = trainer.caps_for(arrays)
            trainer.train_state, m = trainer.train_step(
                trainer.train_state, to_device(arrays, trainer.device),
                trainer.generator, **kw)
            float(m["loss"])
            sync()
            spans.append(time.perf_counter() - a)
        layer["spans"] = {"step": spans}
    follow.trainer = follow.step_fn = None
    del trainer

    losses = [float(l) for l in follow.loss]
    batches = [_rows(cfg, run.vocab, corpus, rows) for rows in follow.rows]

    def judge(control: bool = False) -> Dict[str, float]:
        ref = RT.follow(cfg, run.params, run.state, batches, mix["lr"],
                        run.device)
        out = compare(losses, follow.grad, follow.change, ref,
                      follow.grad_vectors)
        if control:
            low = RT.follow(cfg, run.params, run.state, batches, mix["lr"],
                            run.device, "fp8")
            out.update({f"control_{k}": v for k, v in compare(
                low["loss"], low["grad"], low["change"], ref,
                low["grad_vectors"]).items()})
        return out

    return {"e2e": e2e, "attempted": epochs * len(ds), "failed": 0,
            "trace": tr, "layer": layer, "judge": judge}


def compare(loss: List[float], grad: Dict[str, float],
            change: Dict[str, float], ref: Dict,
            grad_vectors: Dict[str, torch.Tensor]) -> Dict:
    """The numbers ``correct`` compares, and what the look at them needs.
    Compared: ``grad_diff_median``, the median leaf's norm of the first
    gradient's difference from the reference's (``train.leaf_differences``),
    and ``change_gap``, the worst leaf's gap between the two norms of its
    change after the steps followed (``train.leaf_gaps``). Read beside
    them: the worst step's loss gap, and by the worst and the median leaf
    the gap of the first gradient's norm and of the change's, with the
    worst leaves' names. Leaves whose reference gradient is under a
    thousandth of the median leaf's (moved by round-off alone under Adam)
    are left out."""
    g = ref["grad"]
    med = sorted(g.values())[len(g) // 2]
    keep = [n for n in g if g[n] >= 1e-3 * med]
    diffs = RT.leaf_differences(grad_vectors, ref["grad_vectors"], keep)
    out = {"loss_gap": max(abs(p - r) / abs(r)
                           for p, r in zip(loss, ref["loss"])),
           "leaves_left_out": len(g) - len(keep),
           "grad_diff_median": sorted(diffs.values())[len(diffs) // 2],
           "grad_diff_worst": max(diffs.values())}
    for name, prog, want in (("grad", grad, g),
                             ("change", change, ref["change"])):
        gaps = RT.leaf_gaps(prog, want, keep)
        worst = max(gaps, key=gaps.get)
        out[f"{name}_gap"] = gaps[worst]
        out[f"{name}_gap_median"] = sorted(gaps.values())[len(gaps) // 2]
        out[f"{name}_worst_leaf"] = worst
        out[f"{name}_leaf_gaps"] = gaps
    return out


def _rows(cfg: Dict, vocab: Dict[str, int], corpus: Dict, rows: List[int]):
    """One batch as the reference takes it, from the raw corpus."""
    ids = [RI.context_ids(corpus["contexts"][i], vocab,
                          cfg["context_max_length"])[0] for i in rows]
    frames = [RI.frames_u8(corpus["frames"][i], cfg["av_max_length"])
              for i in rows]
    pcms = [corpus["audio"][i] for i in rows]
    Td = cfg["target_steps"]
    targets = [([vocab[w] for w in corpus["questions"][i].split()]
                + [vocab["<end>"]])[:Td] for i in rows]
    return ids, frames, pcms, targets


def _sample_flops(cfg: Dict, ds: QGDataset, i: int) -> float:
    from portbench import arith

    win, hop, per = cfg["stft_window"], cfg["stft_hop"], cfg["mel_frames"]
    ex = min(max(0, (int(ds.audio_len[i]) - win) // hop + 1) // per,
             cfg["av_max_length"]) if cfg["mode"] == "trimodal" else 0
    return arith.request_flops(cfg, max(1, int(ds.context_len[i])),
                               int(ds.frames_len[i]), ex,
                               int(ds.target_len[i]))
