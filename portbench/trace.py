"""Device traces: ``torch.profiler`` (CUPTI) around a stretch of the timed
path, reduced to what the per-layer readers and the result line take:
the device's busy seconds (the union of kernel and copy intervals), the
traced window, kernel time by name, the device operations that took most
time and the idle gaps named by the host operation running through them.
"""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import torch

Span = Tuple[str, float, float]          # (name, start s, end s)
LOOKBACK = 400


@dataclass
class Trace:
    window_s: float
    device: List[Span] = field(default_factory=list)
    host: List[Span] = field(default_factory=list)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0.0, None
        start = None
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if end is None or s > end:
                if end is not None:
                    busy += end - start
                start, end = s, e
            else:
                end = max(end, e)
        if end is not None:
            busy += end - start
        return busy

    def kernels(self, patterns: Sequence[str]) -> List[Span]:
        """Device spans whose name matches any of the regexes."""
        rx = re.compile("|".join(f"(?:{p})" for p in patterns))
        return [sp for sp in self.device if rx.search(sp[0])]

    def device_ops(self, n: int = 10) -> List[list]:
        """[name, total seconds] of the ``n`` device operations that took
        most time."""
        tot: Dict[str, float] = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """[host operation, total seconds] of the device's idle gaps inside
        the traced device activity, each gap named by the outermost host
        operation running at its midpoint ("host: python" where none is)."""
        merged: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        host = sorted(self.host, key=lambda x: x[1])
        starts = [h[1] for h in host]
        tot: Dict[str, float] = {}
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            mid = 0.5 * (e0 + s1)
            name, best = "host: python", -1.0
            # the host ops that started before the midpoint, nearest first;
            # a few hundred back reach any op still open there
            i = bisect.bisect_right(starts, mid)
            for hn, hs, he in reversed(host[max(0, i - LOOKBACK):i]):
                if he >= mid and he - hs > best:
                    name, best = hn, he - hs
            tot[name] = tot.get(name, 0.0) + (s1 - e0)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in top]


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def capture(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` under the profiler, from a synchronised start to a
    synchronised end; the window is that host-clock interval. Without a
    card only the host is traced (the CPU tests)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            dev.append(span)
        elif e.device_type == DeviceType.CPU and not e.name.startswith(
                ("cuda", "ProfilerStep")):
            host.append(span)
    return Trace(window, dev, host)
