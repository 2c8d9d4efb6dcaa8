"""The program's own spans in a traced stretch, for the per-layer readers.

``mmqg_tpu_torch`` opens a named host range at each layer boundary of
``generate()`` and of the train step (``utils.profiling.annotate``:
``serve.pack``, ``model.decode``, ``train.backward``, ...). The profiler
records them beside the card's kernels and copies, on the same clock, so
they arrive in ``ctx["trace"].host`` and the device's idle time inside any
of them can be read from ``ctx["trace"].device``. Every function returns
None where the trace holds no such span (a program without them).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import numpy as np

Interval = Tuple[float, float]


def occurrences(ctx: Dict, name: str) -> List[Interval]:
    """(start, end) seconds of every span called ``name``, in order."""
    tr = ctx.get("trace")
    if tr is None:
        return []
    return sorted((s, e) for n, s, e in tr.host if n == name)


def busy_intervals(ctx: Dict) -> List[Interval]:
    """The union of the device's kernel and copy intervals, in order."""
    merged: List[List[float]] = []
    for _, s, e in sorted(ctx["trace"].device, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_s(busy: List[Interval], start: float, end: float) -> float:
    """Seconds of [start, end] in which no interval of ``busy`` (the
    ordered, disjoint union of ``busy_intervals``) ran."""
    i = max(0, bisect.bisect_right(busy, (start, start)) - 1)
    covered = 0.0
    for s, e in busy[i:]:
        if s >= end:
            break
        covered += max(0.0, min(e, end) - max(s, start))
    return (end - start) - covered


def median_ms(ctx: Dict, name: str) -> Optional[float]:
    """The median duration of the span ``name``, ms."""
    xs = [e - s for s, e in occurrences(ctx, name)]
    return float(np.median(xs)) * 1e3 if xs else None


def idle_median_ms(ctx: Dict, name: str) -> Optional[float]:
    """The median, over the occurrences of ``name``, of the device's idle
    ms inside each."""
    occ = occurrences(ctx, name)
    if not occ:
        return None
    busy = busy_intervals(ctx)
    return float(np.median([idle_s(busy, s, e) for s, e in occ])) * 1e3


def per_step_median_ms(ctx: Dict, name: str) -> Optional[float]:
    """The median over train steps of the summed durations of ``name`` (a
    span each microbatch opens), ms. A step's spans are those that end by
    the end of its ``train.optimizer`` span (one a step, after its
    microbatches) and after the previous step's."""
    occ = occurrences(ctx, name)
    ends = [e for _, e in occurrences(ctx, "train.optimizer")]
    if not occ or not ends:
        return None
    sums = [0.0] * len(ends)
    for s, e in occ:
        k = bisect.bisect_left(ends, e)
        if k < len(ends):
            sums[k] += e - s
    return float(np.median(sums)) * 1e3


def shipped_mb(counter: Optional[Dict[str, int]]) -> Optional[float]:
    """MB (1e6 bytes) a call of a program's H2D counter
    (``{"calls", "bytes"}``)."""
    if not counter or not counter.get("calls"):
        return None
    return counter["bytes"] / counter["calls"] / 1e6
