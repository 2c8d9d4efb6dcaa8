"""JSONL serving daemon: requests on stdin, micro-batched decode on the
card, responses on stdout (``mmqg_tpu/serve.py``).

A request waits at most ``--linger-ms`` for companions; each gathered wave
is decoded as one batch per AV bucket pair. Media prep runs on a
``--prep-workers`` thread pool, so a raw-video request's decode on the host
overlaps the batches on the card. SIGTERM drains: everything read is
answered, nothing more is read.

Request (staged media):
          {"id": <any>, "context": "...", "frames_npy": "path.npy"?,
           "audio_wav": "path.wav"?}
Request (raw video, one span a request):
          {"id": <any>, "video": "lecture.mp4", "span": ["0:45", "1:10"],
           "subtitles": "lecture.srt"?, "context": "..."?}
Response: {"id": <any>, "question": "...", "batch_size": N,
           "latency_ms": F}   (or {"id", "error"} for a bad request)

Usage:
  python -m mmqg_tpu_torch.serve -c results/config.json --best -s beam \\
      --max-batch 32 --linger-ms 25                   # on the card
  python -m mmqg_tpu_torch.serve -c results/config.json --best -s greedy \\
      --device cpu                                    # the plain versions

``--data-parallel`` serves over every visible card, one model replica each
(``QGPipeline.shard``); with one card it warns and serves on it.
``--compile-cache`` is left out, since the port has no compiled programs
to cache.
"""

from __future__ import annotations

import argparse
import json
import queue
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from mmqg_tpu_torch.config import Config
from mmqg_tpu_torch.data import saliency
from mmqg_tpu_torch.data import wav as wavio
from mmqg_tpu_torch.data.subtitles import (extract_context,
                                           parse_subtitle_file, span_seconds)
from mmqg_tpu_torch.data.text_prep import preprocess_text
from mmqg_tpu_torch.parallel.mesh import data_parallel_mesh, visible_devices
from mmqg_tpu_torch.pipeline import QGPipeline, count_audio_route
from mmqg_tpu_torch.utils.device import resolve_device


def _load_media(req: dict, pipe):
    """One request -> (context, frames, audio) on the host. The raw-video
    form runs ``generate_from_video``'s prep for its one span (salient
    frames, the span's audio by ``pipe._span_audio``, the subtitles'
    context); ``frames_npy`` and ``audio_wav`` take the place of the
    video's frames and audio."""
    mc = pipe.mc
    context = req.get("context", "")
    frames = audio = None
    if req.get("video"):
        def _sec(v):
            return float(span_seconds(v)) if isinstance(v, str) else float(v)

        a, b = (_sec(v) for v in req["span"])
        frames = saliency.extract_salient_frames_for_video(
            req["video"], [(int(a * 1000), int(b * 1000))],
            frame_dim=(mc.frame_size, mc.frame_size))[0]
        if not context and req.get("subtitles"):
            caps = parse_subtitle_file(req["subtitles"])
            context = extract_context(caps, a, b) or ""
        context = preprocess_text(context) or ""
        if not req.get("audio_wav"):
            spans_audio = pipe._span_audio(req["video"], [(a, b)])
            audio = spans_audio[0] if spans_audio else None
    if req.get("frames_npy"):
        frames = np.load(req["frames_npy"])
    if req.get("audio_wav"):
        audio = wavio.load_mono_16k(req["audio_wav"],
                                    target_rate=mc.sample_rate)
        count_audio_route("wav")
    return context, frames, audio


def serve(pipe, *, strategy: str, max_batch: int, linger_ms: float,
          topk: int = 1, top_p: float = 0.9, seed: int = 0,
          inp=None, out=None, prep_workers: int = 4,
          bucket_group: bool = True, stop=None) -> int:
    """Run the serve loop until EOF on ``inp``; returns requests served.

    ``pipe``: anything with ``mc``, ``generate``, ``generate_async``,
    ``av_bucket_key`` and ``_span_audio`` (a ``QGPipeline``).

    ``stop``: optional ``threading.Event``; once set, no more input is
    accepted, the requests already read still prep, decode and answer, and
    the call returns when that backlog drains (``main`` sets it on
    SIGTERM).

    Threads: a reader parses ``inp`` into a bounded queue; a feeder
    submits each request to a ``prep_workers``-wide pool (``_load_media``),
    blocking while ``8 * max_batch`` preps are outstanding, so that a
    producer faster than the card is held back at ``inp``; this thread
    gathers prepped requests in completion order into waves, dispatches
    them and reads their questions back; one writer thread owns ``out`` and
    writes the finished responses in order, so a slow reader of ``out``
    does not stall batching.

    ``bucket_group=True`` dispatches one batch per (frames bucket, audio
    bucket) pair of a wave (``pipe.av_bucket_key``, the grouping of
    ``generate_from_videos(coalesce=True)``); False, one batch at the
    wave's largest buckets.

    The sampling strategies draw from a per-request stream keyed by
    (seed, arrival index): at a fixed seed, a request's question does not
    depend on how the requests were batched.

    A request's ``latency_ms`` runs from the moment it was read off
    ``inp`` to the moment its question was on the host."""
    inp = inp if inp is not None else sys.stdin
    out = out if out is not None else sys.stdout
    q: "queue.Queue[Optional[dict]]" = queue.Queue(maxsize=8 * max_batch)

    def reader():
        try:
            for line in inp:
                line = line.strip()
                if not line:
                    continue
                try:
                    q.put(json.loads(line))
                except json.JSONDecodeError as e:
                    q.put({"_parse_error": str(e)})
        finally:
            q.put(None)  # EOF, even if the read loop raised

    threading.Thread(target=reader, daemon=True).start()

    # ``ready`` holds prepped requests in completion order; with the
    # semaphore, decoded media of at most 8 * max_batch requests is held
    ready: "queue.Queue[Optional[dict]]" = queue.Queue(maxsize=8 * max_batch)
    pool = ThreadPoolExecutor(max_workers=max(1, prep_workers))
    outstanding = threading.BoundedSemaphore(8 * max_batch)

    def prep_one(req: dict, seq: int, t_read: float):
        entry = {"seq": seq, "t": t_read,
                 "id": req.get("id") if isinstance(req, dict) else None}
        try:
            try:
                if "_parse_error" in req:
                    raise ValueError(req["_parse_error"])
                c, f, a = _load_media(req, pipe)
                entry.update(ctx=c, frames=f, audio=a)
            except Exception as e:  # a bad request errors alone
                entry["err"] = str(e)
            ready.put(entry)
        finally:
            outstanding.release()

    def feeder():
        # arrival order assigns ``seq``, the request's sampling identity,
        # before prep completion order scrambles the requests
        seq = 0

        def submit(req) -> bool:
            nonlocal seq
            if req is None:
                return False
            outstanding.acquire()
            pool.submit(prep_one, req, seq, time.monotonic())
            seq += 1
            return True

        try:
            while True:
                if stop is not None and stop.is_set():
                    # drain: serve everything already read. The reader may
                    # hold a request it read but has not queued yet, so
                    # keep taking until the queue stays quiet for 0.5 s
                    deadline = time.monotonic() + 0.5
                    while time.monotonic() < deadline:
                        try:
                            req = q.get(timeout=0.1)
                        except queue.Empty:
                            continue
                        if not submit(req):
                            break
                        deadline = time.monotonic() + 0.5
                    break
                try:
                    req = q.get(timeout=0.25 if stop is not None else None)
                except queue.Empty:
                    continue
                if not submit(req):
                    break
        finally:
            pool.shutdown(wait=True)  # every entry is in ready before EOF
            ready.put(None)

    threading.Thread(target=feeder, daemon=True).start()

    # the writer: response lines in the order they were finished
    lines_q: "queue.Queue[Optional[List[str]]]" = queue.Queue()
    write_error: List[BaseException] = []

    def writer():
        while True:
            lines = lines_q.get()
            if lines is None:
                return
            if write_error:
                continue  # out failed: drop the rest, serve() raises
            try:
                out.write("".join(lines))
                out.flush()
            except Exception as e:
                write_error.append(e)

    write_thread = threading.Thread(target=writer, daemon=True)
    write_thread.start()

    def emit(records: List[dict]) -> None:
        if records:
            lines_q.put([json.dumps(r) + "\n" for r in records])

    served = 0
    done = False
    in_flight: List[dict] = []  # dispatched, not yet read back

    def flush(infl) -> None:
        """Read a dispatched batch back and hand its responses over."""
        records = []
        try:
            questions = infl["finalize"]()
        except Exception as e:  # a runtime failure errors the whole batch
            records = [{"id": rid, "error": str(e)} for rid in infl["ids"]]
            questions = []
        now = time.monotonic()  # after the questions are on the host
        for rid, t_read, question in zip(infl["ids"], infl["ts"], questions):
            if question is None:
                continue  # this request failed alone: its error is in errs
            records.append({"id": rid, "question": question,
                            "batch_size": infl["n"],
                            "latency_ms": round((now - t_read) * 1000.0, 1)})
        records += [{"id": rid, "error": err} for rid, err in infl["errs"]]
        emit(records)

    def flush_all():
        for infl in in_flight:
            flush(infl)
        in_flight.clear()

    def dispatch_group(grp: List[dict], caps) -> dict:
        """One batch at fixed caps for one bucket group; returns its
        in-flight record (a per-request finalizer if packing fails)."""
        ids = [e["id"] for e in grp]
        ts = [e["t"] for e in grp]
        errs: List = []
        try:
            finalize = pipe.generate_async(
                [e["ctx"] for e in grp], [e["frames"] for e in grp],
                [e["audio"] for e in grp], strategy=strategy, topk=topk,
                top_p=top_p, seed=seed,
                row_seeds=[e["seq"] for e in grp],
                frames_cap=caps[0], audio_cap=caps[1])
        except Exception:
            # a request that loaded fine can still break packing (wrong
            # frame geometry): one call a request, so it errors alone
            def finalize(grp=grp, infl_errs=errs):
                qs = []
                for e in grp:
                    try:
                        qs.append(pipe.generate(
                            [e["ctx"]], [e["frames"]], [e["audio"]],
                            strategy=strategy, topk=topk, top_p=top_p,
                            seed=seed, row_seeds=[e["seq"]])[0])
                    except Exception as exc:
                        infl_errs.append((e["id"], str(exc)))
                        qs.append(None)  # keeps the ids aligned
                return qs

        return {"finalize": finalize, "ids": ids, "ts": ts, "n": len(grp),
                "errs": errs}

    try:
        while not done:
            if write_error:
                raise write_error[0]
            # idle: read the in-flight batches back before blocking, so
            # their responses do not wait for the next request
            if in_flight and ready.empty():
                flush_all()
            first = ready.get()
            if first is None:
                break
            pending: List[dict] = [first]
            # take what is already prepped without waiting: a backlog is
            # shipped as one wave even with linger_ms=0
            while len(pending) < max_batch:
                try:
                    nxt = ready.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    done = True
                    break
                pending.append(nxt)
            # then linger for companions while there is budget and room
            deadline = time.monotonic() + linger_ms / 1000.0
            while not done and len(pending) < max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = ready.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    done = True
                    break
                pending.append(nxt)

            good = [e for e in pending if "err" not in e]
            # prep and parse failures need no device: answer them now
            emit([{"id": e["id"], "error": e["err"]}
                  for e in pending if "err" in e])

            if bucket_group:
                groups: dict = {}
                for e in good:
                    groups.setdefault(
                        pipe.av_bucket_key(e["frames"], e["audio"]),
                        []).append(e)
                waves = [(key, groups[key])
                         for key in sorted(groups, key=str)]
            else:
                waves = [((None, None), good)] if good else []

            # each batch dispatched, the batches before it are read back
            # while it decodes: per batch, not per wave as in the JAX
            # package, since a dispatch here runs the decode loop on the
            # host (tens of ms), and a wave's answers would otherwise wait
            # for every dispatch of the next wave
            for caps, grp in waves:
                infl = dispatch_group(grp, caps)
                flush_all()
                in_flight.append(infl)
            served += len(pending)

        flush_all()
    finally:
        lines_q.put(None)
        write_thread.join()
    if write_error:
        raise write_error[0]
    return served


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="JSONL QG serving daemon (PyTorch port)")
    parser.add_argument("-c", "--config_path", type=str, required=True)
    parser.add_argument("-b", "--best", action="store_true")
    parser.add_argument("-l", "--last", action="store_true")
    parser.add_argument("-s", "--strategy", type=str, default="beam",
                        choices=["greedy", "sampling", "topk", "topp",
                                 "beam"])
    parser.add_argument("--mode", type=str, default="trimodal",
                        choices=["text", "text_video", "trimodal"])
    parser.add_argument("--decoder", type=str, default="attn",
                        choices=["attn", "non_attn"])
    parser.add_argument("--top-k", type=int, default=1,
                        help="k for -s topk")
    parser.add_argument("--top-p", type=float, default=0.9,
                        help="nucleus mass for -s topp")
    parser.add_argument("--seed", type=int, default=0,
                        help="base PRNG seed for sampling strategies")
    parser.add_argument("--max-batch", type=int, default=32)
    parser.add_argument("--linger-ms", type=float, default=25.0)
    parser.add_argument("--prep-workers", type=int, default=4,
                        help="host media-prep thread pool width")
    parser.add_argument("--no-bucket-group", action="store_true",
                        help="one batch at the wave's largest AV buckets "
                             "instead of one per bucket pair")
    parser.add_argument("--data-parallel", action="store_true",
                        help="serve over every visible card, one model "
                             "replica each (QGPipeline.shard); it buys no "
                             "questions/s while the decode is host-bound: "
                             "one interpreter pays every replica's "
                             "launches")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; the kernels run there) or "
                             "'cpu' (the kernels' plain versions)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device, caller="serve --device")
    config = Config.load(args.config_path)
    alias = "last" if args.last and not args.best else "best"
    pipe = QGPipeline.from_checkpoint(config, alias=alias, mode=args.mode,
                                      decoder=args.decoder, device=device)
    if args.data_parallel:
        mesh = data_parallel_mesh(
            config, visible_devices() if device.type == "cuda" else [device],
            log=lambda msg: print(msg, file=sys.stderr))
        if mesh is not None:
            pipe.shard(mesh)
    print(f"ready alias={alias} strategy={args.strategy} "
          f"max_batch={args.max_batch} device={device}", file=sys.stderr,
          flush=True)

    # SIGTERM: accept no more, answer everything already read, exit 0;
    # the previous handler is restored before returning
    stop = threading.Event()

    def _on_term(signum, frame):
        print("SIGTERM: draining in-flight requests, accepting no more",
              file=sys.stderr, flush=True)
        stop.set()

    prev = signal.signal(signal.SIGTERM, _on_term)
    try:
        n = serve(pipe, strategy=args.strategy, max_batch=args.max_batch,
                  topk=args.top_k, top_p=args.top_p, seed=args.seed,
                  linger_ms=args.linger_ms, prep_workers=args.prep_workers,
                  bucket_group=not args.no_bucket_group, stop=stop)
    finally:
        signal.signal(signal.SIGTERM,
                      prev if callable(prev) or prev in
                      (signal.SIG_IGN, signal.SIG_DFL) else signal.SIG_DFL)
    print(f"served {n} requests", file=sys.stderr)


if __name__ == "__main__":
    main()
