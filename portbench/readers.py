"""Shared arithmetic of the per-layer readers (``metrics/<name>.py``).

A reader gets ``ctx``: ``trace`` (``trace.Trace`` of the traced stretch),
``cfg`` (the configuration), and what the driver recorded: ``calls`` (the
traced generate() calls' shapes and served steps, or the traced train
steps' ``steps`` and ``train_flops``) and ``spans`` (host-clock seconds of
the split pass, by part). It returns a number in its unit, or None where
there is nothing to read.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np

from portbench import arith


def span_median_ms(ctx: Dict, part: str) -> Optional[float]:
    xs = ctx.get("spans", {}).get(part)
    return float(np.median(xs)) * 1e3 if xs else None


def idle_pct(ctx: Dict) -> Optional[float]:
    tr = ctx.get("trace")
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu_pct(ctx: Dict) -> Optional[float]:
    """Model FLOPs of the traced calls' requests at their real lengths and
    served steps, over the traced window, as a share of the bf16 peak."""
    tr, calls, cfg = ctx.get("trace"), ctx.get("calls"), ctx["cfg"]
    if tr is None or not calls:
        return None
    flops = sum(arith.request_flops(cfg, max(1, t), f, e, s)
                for c in calls for t, f, e, s in zip(
                    c["text"], c["frames"], c["examples"], c["steps"]))
    return 100.0 * flops / tr.window_s / arith.PEAK["bf16"]


def roofline_pct(ctx: Dict, patterns: Sequence[str],
                 launches: Callable[[Dict, Dict], Iterable[Dict]],
                 peak: str) -> Optional[float]:
    """Sum of the launches' bound times over the sum of the device time of
    the kernels matching ``patterns``, in per cent. ``launches(cfg,
    call)`` gives each traced call's launches as {"ops", "bytes"}."""
    tr, calls = ctx.get("trace"), ctx.get("calls")
    if tr is None or not calls:
        return None
    spans = tr.kernels(patterns)
    device_s = sum(e - s for _, s, e in spans)
    if device_s <= 0:
        return None
    bound = sum(arith.bound_s(l["ops"], l["bytes"], peak)
                for c in calls for l in launches(ctx["cfg"], c))
    return 100.0 * bound / device_s
