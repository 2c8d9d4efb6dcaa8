"""Bulk greedy serving with R(2+1)D-18 as the video encoder: the closed
loop of ``serve_bulk`` (the same pool, warm-up, window and
``questions_per_s``) on a ``QGPipeline`` built from
``reference/r2plus1d.py``'s weights, judged by that file's reference.

A row's video memory depends on the clip length its batch was encoded at,
the pipeline's frames bucket of the batch's longest row (the trunk's SAME
temporal convs carry eval batchnorm's shift from the zeroed padding into
the last live steps). So each answer keeps its batch's clip length, and
the judge runs ``judge.served_gaps`` once per clip length, with
``R2Plus1DReference`` at that length in the base reference's place for
that call, and sums the groups' readings.

The number compared is ``logit_gap_vs_fp8``: the served tokens' gaps
below the f32 reference's best, summed over the positions judged, over
the sum of the gaps of the fp8 reference's first choices at the same
positions. ``logit_gap_per_tie`` (reported, not compared) swings with the
seed's weights by two orders of magnitude, for the program and the fp8
control alike, while at any one seed the control loses tens of times what
the program loses; dividing by the control's loss at the same positions
reads the program's rounding against fp8's at those weights. So the fp8
reference runs in every judge, and its own reading is 1.

Traced run: the profiler over one pass of the pool, whose calls' shapes
(rows, buckets, real lengths, served steps) the readers take; no split
pass (no reader of this cell times the parts from outside).
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List

import torch

from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.pipeline import QGPipeline
from portbench import gen, judge, trace
from portbench.reference import r2plus1d
from portbench.traffic.serve_bulk import shapes


def drive(run) -> Dict:
    cfg, mix = run.cfg, run.mix
    run.params, run.state = r2plus1d.make(cfg, run.seed, run.device)
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

    answers, clips = [], []
    for i, qs in calls:
        contexts, frames, audio = pool[i]
        for j, q in enumerate(qs):
            answers.append(judge.Answer(
                lambda c=contexts[j], f=frames[j], a=audio[j]: (c, f, a), q))
            clips.append(caps[i]["frames_cap"])
    groups: Dict[int, List] = {}
    for k in judge.sample(answers, mix["judge_sample"], run.seed):
        groups.setdefault(clips[k], []).append(answers[k])
    return {"e2e": e2e, "attempted": n_q, "failed": 0, "trace": tr,
            "layer": layer, "judge": lambda control=False: judged(
                run, groups, control)}


def judged(run, groups: Dict[int, List], control: bool = False) -> Dict:
    """``judge.served_gaps`` of each clip length's answers under the
    R(2+1)D reference at that length, with the fp8 control always (the
    ``control`` flag changes nothing), summed into one reading, and
    ``logit_gap_vs_fp8`` of the program and of the control."""
    parts = []
    for clip, answers in sorted(groups.items()):
        saved = judge.Reference
        judge.Reference = functools.partial(r2plus1d.R2Plus1DReference,
                                            clip_frames=clip)
        try:
            parts.append(judge.served_gaps(
                run.cfg, run.params, run.state, run.vocab, answers,
                run.device, control=True))
        finally:
            judge.Reference = saved
    out = merged(parts)
    for pre in ("", "control_"):
        out[pre + "logit_gap_vs_fp8"] = vs_fp8(out, pre)
    return out


def vs_fp8(reading: Dict, pre: str = "") -> float:
    """The summed gaps of the served tokens (``pre`` "control_": of the fp8
    reference's first choices) over those of the fp8 reference's first
    choices at the same positions: both ``logit_gap_per_tie`` share their
    number of near ties. Where the fp8 reference lost nothing, 0 if the
    served tokens did not either, else ``judge.NOTHING``; nothing judged
    is ``judge.NOTHING``."""
    mine = reading.get(pre + "logit_gap_per_tie", judge.NOTHING)
    fp8 = reading.get("control_logit_gap_per_tie", judge.NOTHING)
    if mine >= judge.NOTHING or fp8 >= judge.NOTHING:
        return judge.NOTHING
    if fp8 == 0:
        return 0.0 if mine == 0 else judge.NOTHING
    return mine / fp8


def merged(parts: List[Dict]) -> Dict:
    """One reading of several groups': the counts summed, and of the gaps
    (``control_`` too) the widest, the mean over every position compared
    and the sum over every near tie, as ``judge.served_gaps`` gives them
    over all the answers at once."""
    ties = sum(p["near_ties"] for p in parts)
    out = {"logit_gap": judge.NOTHING, "logit_gap_mean": judge.NOTHING,
           "logit_gap_per_tie": judge.NOTHING,
           "tokens": sum(p["tokens"] for p in parts), "near_ties": ties,
           "unservable": sum(p["unservable"] for p in parts)}
    for pre in ("", "control_"):
        live = [p for p in parts if p["tokens"] and pre + "logit_gap" in p]
        if not live:
            continue
        total = sum(p[pre + "logit_gap_per_tie"] * max(p["near_ties"], 1)
                    for p in live)
        out[pre + "logit_gap"] = max(p[pre + "logit_gap"] for p in live)
        out[pre + "logit_gap_mean"] = total / sum(p["tokens"] for p in live)
        out[pre + "logit_gap_per_tie"] = total / max(ties, 1)
    return out
