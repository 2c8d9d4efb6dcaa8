"""Bulk greedy serving with the Video Swin Transformer (``swin3d_b``) as
the video encoder: the closed loop of ``serve_bulk`` (the same pool,
warm-up, window and ``questions_per_s``, and its ``shapes``) on a
``QGPipeline`` built from ``reference/swin3d.py``'s weights, judged by
that file's ``Swin3DReference``.

The trunk masks each clip's padded tokens as keys, so a row's memory does
not depend on the clip length its batch was encoded at: the judge runs
``judge.served_gaps`` once over every sampled answer, with the reference
in the base reference's place, the fp8 control always.

The numbers compared are ``logit_gap_vs_fp8``, as in the R(2+1)D cell
(``serve_bulk_r2plus1d.vs_fp8``): the served tokens' summed gaps below
the f32 reference's best over those of the fp8 reference's first choices
at the same positions, the control's own reading 1; and
``memory_gap_f32`` (``memory_gaps``), the trunk held to the reference in
float32, where a fault confined to it shows although the served tokens
hide it.

Traced run: the profiler over one pass of the pool, whose calls' shapes
(rows, buckets, real lengths, served steps) the readers take; no split
pass.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.pipeline import QGPipeline
from portbench import gen, judge, trace
from portbench.reference import inputs as RI
from portbench.reference import swin3d
from portbench.traffic.serve_bulk import shapes
from portbench.traffic.serve_bulk_r2plus1d import vs_fp8


def drive(run) -> Dict:
    cfg, mix = run.cfg, run.mix
    run.params, run.state = swin3d.make(cfg, run.seed, run.device)
    run.vocab, run.index_to_word = gen.vocab(cfg["n_vocab"])
    mc = run.model_config()
    pipe = QGPipeline(None, mc, run.params, run.state, run.vocab,
                      run.index_to_word, device=run.device,
                      dtype=getattr(torch, cfg["compute_dtype"]))
    pool = gen.bulk_pool(cfg, mix, run.seed, run.device)
    caps = [dict(frames_cap=DEC.frames_bucket(mc, [len(f) for f in b[1]]),
                 audio_cap=DEC.audio_bucket(mc, [len(a) for a in b[2]]))
            for b in pool]
    on_card = run.device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for batch in pool:                 # the shapes the window runs
        pipe.generate(*batch, strategy="greedy")
    sync()

    t0 = run.window_start()
    calls = []
    end = t0
    while end - t0 < run.seconds or not calls:
        i = len(calls) % len(pool)
        calls.append((i, pipe.generate(*pool[i], strategy="greedy")))
        end = time.perf_counter()
    n_q = sum(len(q) for _, q in calls)
    e2e = {"questions_per_s": n_q / (end - t0)}

    layer: Dict = {}
    tr = None
    if run.trace:
        served: List = []
        tr = trace.capture(lambda: served.extend(
            pipe.generate(*b, strategy="greedy") for b in pool))
        layer["calls"] = [dict(shapes(cfg, b, cp), steps=[
            len(q.split()) + (len(q.split()) < cfg["target_steps"] - 1)
            for q in qs]) for b, qs, cp in zip(pool, served, caps)]
    del pipe

    answers = []
    for i, qs in calls:
        contexts, frames, audio = pool[i]
        for j, q in enumerate(qs):
            answers.append(judge.Answer(
                lambda c=contexts[j], f=frames[j], a=audio[j]: (c, f, a), q))
    chosen = [answers[k] for k in judge.sample(answers, mix["judge_sample"],
                                               run.seed)]
    return {"e2e": e2e, "attempted": n_q, "failed": 0, "trace": tr,
            "layer": layer, "judge": lambda control=False: judged(
                run, chosen)}


def judged(run, answers: List) -> Dict:
    """``judge.served_gaps`` of ``answers`` under ``Swin3DReference``, with
    the fp8 control, and ``logit_gap_vs_fp8`` of the program and of the
    control."""
    saved = judge.Reference
    judge.Reference = swin3d.Swin3DReference
    try:
        out = judge.served_gaps(run.cfg, run.params, run.state, run.vocab,
                                answers, run.device, control=True)
    finally:
        judge.Reference = saved
    for pre in ("", "control_"):
        out[pre + "logit_gap_vs_fp8"] = vs_fp8(out, pre)
    out.update(memory_gaps(run, answers))
    return out


TRUNK_CLIPS = 4     # the judged requests whose memory is compared in f32


def memory_gaps(run, answers: List) -> Dict:
    """The trunk below bf16's rounding: the first ``TRUNK_CLIPS`` of
    ``answers``' requests encoded in float32 through the program's
    serving path (``_pack``, ``decode.encode`` at their own frames
    bucket), their video memory (every step, zero past each clip's live
    steps) against ``Swin3DReference``'s in float32: ``memory_gap_f32``,
    the largest difference over the reference's largest value, and
    ``control_memory_gap_f32``, the fp8 reference's. The served bf16
    memory sits about 1e-2 of its max from the reference, as far as a
    dropped shift mask or relative-position bias moves it at these
    weights, and the served tokens show neither; in float32 the program
    sits at float32's rounding."""
    cfg = run.cfg
    contexts, frames, audio = (list(x) for x in zip(
        *(a.load() for a in answers[:TRUNK_CLIPS])))
    clips = [RI.frames_u8(f, cfg["av_max_length"]) for f in frames]
    with torch.no_grad():
        want, _ = swin3d.Swin3DReference(
            cfg, run.params, run.state, run.device).video(clips)
        low, _ = swin3d.Swin3DReference(
            cfg, run.params, run.state, run.device, "fp8").video(clips)
        pipe = QGPipeline(None, run.model_config(), run.params, run.state,
                          run.vocab, run.index_to_word, device=run.device,
                          dtype=torch.float32)
        mc = pipe.mc
        host = pipe._pack(contexts, frames, audio)
        mem, _ = DEC.encode(
            pipe.model, mc, pipe._to_device(host), dtype=torch.float32,
            frames_cap=DEC.frames_bucket(mc, host["frames_len"]),
            audio_cap=DEC.audio_bucket(mc, host["audio_len"]))
        got = mem.enc_video[:len(clips)].float()   # past them: padding rows
        del pipe, mem
    full = torch.zeros_like(got)
    full[:, :want.shape[1]] = want
    scale = float(full.abs().max())
    out = {}
    for pre, other in (("", got), ("control_", low)):
        mine = torch.zeros_like(got)
        mine[:, :other.shape[1]] = other
        out[pre + "memory_gap_f32"] = float(
            (mine - full).abs().max()) / scale
    return out
