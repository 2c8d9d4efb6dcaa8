"""The readers of the program's spans (``portbench/spans.py`` and the
``metrics/*`` files that use it) on hand-built traces."""

import pytest

from portbench import run as R
from portbench import spans
from portbench.trace import Trace


def _read(metric, ctx):
    return R.load_module(R.HERE / "metrics" / f"{metric}.py").read(ctx)


def _serving_trace():
    """Two calls. Call 1: encode open 10-20 ms over kernels 12-15 and
    18-25 (the second straddles its end), idle 2 + 3 = 5 ms inside it;
    decode 20-40 over 22-30 (25-30 of the kernel at 18-25 covers 20-25
    too): idle 20-40 less 20-30 = 10 ms. Call 2: a copy 55-75 straddles
    the start of encode 50-60, idle 5 ms, and covers decode 60-70, idle
    0."""
    ms = 1e-3
    host = [("serve.pack", 0 * ms, 6 * ms), ("serve.h2d", 6 * ms, 10 * ms),
            ("model.encode", 10 * ms, 20 * ms),
            ("model.decode", 20 * ms, 40 * ms),
            ("serve.readback", 40 * ms, 41 * ms),
            ("aten::mm", 11 * ms, 12 * ms),
            ("serve.pack", 42 * ms, 46 * ms), ("serve.h2d", 46 * ms, 50 * ms),
            ("model.encode", 50 * ms, 60 * ms),
            ("model.decode", 60 * ms, 70 * ms),
            ("serve.readback", 70 * ms, 73 * ms)]
    device = [("k", 12 * ms, 15 * ms), ("k", 18 * ms, 25 * ms),
              ("k", 22 * ms, 30 * ms), ("Memcpy HtoD", 55 * ms, 75 * ms)]
    return Trace(0.075, device, host)


def test_idle_inside_a_span_counts_gaps_across_its_edges():
    ms = 1e-3
    ctx = {"trace": _serving_trace()}
    busy = spans.busy_intervals(ctx)
    assert busy == [(12 * ms, 15 * ms), (18 * ms, 30 * ms),
                    (55 * ms, 75 * ms)]
    assert spans.idle_s(busy, 10 * ms, 20 * ms) == pytest.approx(5 * ms)
    assert spans.idle_s(busy, 20 * ms, 40 * ms) == pytest.approx(10 * ms)
    assert spans.idle_s(busy, 50 * ms, 60 * ms) == pytest.approx(5 * ms)
    assert spans.idle_s(busy, 60 * ms, 70 * ms) == pytest.approx(0.0)
    assert spans.idle_s([], 0.0, 1.0) == pytest.approx(1.0)
    # medians over the two calls: encode (5, 5), decode (10, 0)
    assert _read("encode_idle_ms.serve", ctx) == pytest.approx(5.0)
    assert _read("decode_idle_ms.serve", ctx) == pytest.approx(5.0)
    assert _read("pack_host_ms.serve", ctx) == pytest.approx(5.0)
    assert _read("h2d_ms.serve", ctx) == pytest.approx(4.0)
    assert _read("readback_ms.serve", ctx) == pytest.approx(2.0)


def test_microbatch_spans_are_summed_per_step():
    """Three steps; the second runs two microbatches (forward 3 + 5 ms,
    backward 4 + 6 ms): per step 2, 8, 1 ms of forward and 3, 10, 2 of
    backward."""
    ms = 1e-3
    host = [("data.batch", 0, 1 * ms), ("train.h2d", 1 * ms, 2 * ms),
            ("train.forward", 2 * ms, 4 * ms),
            ("train.backward", 4 * ms, 7 * ms),
            ("train.optimizer", 7 * ms, 9 * ms),
            ("train.forward", 10 * ms, 13 * ms),
            ("train.backward", 13 * ms, 17 * ms),
            ("train.forward", 17 * ms, 22 * ms),
            ("train.backward", 22 * ms, 28 * ms),
            ("train.optimizer", 28 * ms, 29 * ms),
            ("train.loss_read", 29 * ms, 35 * ms),
            ("train.forward", 40 * ms, 41 * ms),
            ("train.backward", 41 * ms, 43 * ms),
            ("train.optimizer", 43 * ms, 46 * ms)]
    ctx = {"trace": Trace(0.05, [], host)}
    assert _read("forward_ms.train", ctx) == pytest.approx(2.0)
    assert _read("backward_ms.train", ctx) == pytest.approx(3.0)
    assert _read("optimizer_ms.train", ctx) == pytest.approx(2.0)
    assert _read("loss_wait_ms.train", ctx) == pytest.approx(6.0)
    assert _read("batch_ms.train", ctx) == pytest.approx(1.0)
    assert _read("h2d_ms.train", ctx) == pytest.approx(1.0)
    # microbatches after the last optimizer span belong to no step
    late = Trace(0.05, [], host + [("train.forward", 47 * ms, 60 * ms)])
    assert _read("forward_ms.train", {"trace": late}) == pytest.approx(2.0)


@pytest.mark.parametrize("metric", [
    "pack_host_ms.serve", "h2d_ms.serve", "encode_idle_ms.serve",
    "decode_idle_ms.serve", "readback_ms.serve", "batch_ms.train",
    "h2d_ms.train", "forward_ms.train", "backward_ms.train",
    "optimizer_ms.train", "loss_wait_ms.train"])
def test_a_span_with_no_occurrence_reads_none(metric):
    """A program without the spans (the trace holds aten ops alone), or a
    run without a trace, reads nothing."""
    tr = Trace(0.01, [("k", 0.0, 0.005)], [("aten::mm", 0.0, 0.004)])
    assert _read(metric, {"trace": tr}) is None
    assert _read(metric, {}) is None


def test_shipped_mb_reads_a_counter_or_nothing():
    assert spans.shipped_mb({"calls": 4, "bytes": 6_000_000}) == 1.5
    assert spans.shipped_mb({"calls": 0, "bytes": 0}) is None
    assert spans.shipped_mb(None) is None
