"""Bulk greedy serving, closed loop: one ``QGPipeline.generate()`` of a
batch at a time, cycling through a pool of batches made from the seed at
set-up, for the whole window.

End to end: ``questions_per_s``, every question the window's calls
returned over the time from the window's start to the end of its last
call. Traced run: the profiler over one pass of the pool, then one more
pass split as ``generate()`` runs it (pack and H2D, encode, decode), each
part ending in a synchronise.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from mmqg_tpu_torch import decode as DEC
from portbench import gen, trace
from portbench.judge import Answer, sample, served_gaps


def shapes(cfg: Dict, batch, caps: Dict) -> Dict:
    """What one generate() of ``batch`` runs: rows (a power of two), the
    frame and audio buckets ``caps`` the port chose for it, and each
    request's real lengths."""
    contexts, frames, audio = batch
    n = len(contexts)
    rows = 1 << (n - 1).bit_length()
    av = cfg["av_max_length"]
    words = [min(len(c.split()), cfg["context_max_length"]) for c in contexts]
    nf = [min(len(f), av) for f in frames] if frames is not None else [1] * n
    ex = [0] * n
    if audio is not None:
        win, hop, per = cfg["stft_window"], cfg["stft_hop"], cfg["mel_frames"]
        ex = [min(max(0, (len(a) - win) // hop + 1) // per, av) for a in audio]
    return {"n": n, "rows": rows, "fcap": caps["frames_cap"],
            "acap": caps["audio_cap"], "text": words, "frames": nf,
            "examples": ex}


def drive(run) -> Dict:
    cfg, mix = run.cfg, run.mix
    pipe = run.pipeline()
    pool = gen.bulk_pool(cfg, mix, run.seed, run.device)
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
        served = []
        tr = trace.capture(lambda: served.extend(
            pipe.generate(*b, strategy="greedy") for b in pool))
        spans = {"pack": [], "encode": [], "decode": []}
        bucket_caps = []
        mc = pipe.mc
        for b in pool:
            sync()
            a = time.perf_counter()
            host = pipe._pack(*b)
            dev = pipe._to_device(host)
            sync()
            bt = time.perf_counter()
            caps = dict(audio_cap=DEC.audio_bucket(mc, host["audio_len"]),
                        frames_cap=DEC.frames_bucket(mc, host["frames_len"]))
            mem, st = DEC.encode(pipe.model, mc, dev, dtype=pipe.dtype,
                                 **caps)
            sync()
            c = time.perf_counter()
            DEC.decode_from_memories(pipe.model, mem, st,
                                     max_len=mc.target_steps - 1,
                                     dtype=pipe.dtype)
            sync()
            d = time.perf_counter()
            spans["pack"].append(bt - a)
            spans["encode"].append(c - bt)
            spans["decode"].append(d - c)
            bucket_caps.append(caps)
            del host, dev, mem, st
        layer["spans"] = spans
        layer["calls"] = [dict(shapes(cfg, b, cp), steps=[
            len(q.split()) + (len(q.split()) < cfg["target_steps"] - 1)
            for q in qs]) for b, qs, cp in zip(pool, served, bucket_caps)]
    del pipe

    answers = []
    for i, qs in calls:
        contexts, frames, audio = pool[i]
        for j, q in enumerate(qs):
            answers.append(Answer(
                lambda c=contexts[j], f=frames[j],
                a=(audio[j] if audio is not None else None): (c, f, a), q))
    chosen = [answers[k] for k in sample(answers, mix["judge_sample"],
                                         run.seed)]
    return {"e2e": e2e, "attempted": n_q, "failed": 0, "trace": tr,
            "layer": layer, "judge": lambda control=False: served_gaps(
                cfg, run.params, run.state, run.vocab, chosen, run.device,
                control=control)}
