"""Profiling hooks and debug toggles (``mmqg_tpu/utils/profiling.py``).

* :func:`trace` -- a ``torch.profiler`` capture (CPU, and CUDA where a card
  is visible) written as a Chrome/perfetto trace into a directory;
* :func:`annotate` -- a named span in that trace, as a decorator or a
  context manager: the program's one span entry point, on the profiler's
  clock while a profiler records and a flag test otherwise;
* :func:`nan_debugging` -- the stand-in for the reference's
  ``torch.autograd.set_detect_anomaly``: anomaly mode for the backward and
  a forward check that raises at the first non-finite output, naming the
  module or the ``autograd.Function`` (K4's among them) that produced it;
* :class:`StepTimer`, :func:`param_mem_mb`, :func:`device_memory_report`.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

Tensor = torch.Tensor


@contextlib.contextmanager
def trace(log_dir: Path) -> Iterator[torch.profiler.profile]:
    """Capture a trace of the enclosed block into ``log_dir`` as
    ``trace_<pid>_<ns>.json`` (Chrome trace format; perfetto and
    chrome://tracing read it): ``with profiling.trace(d): step(...)``.
    Yields the profiler, whose ``events()`` hold the same records."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            str(log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


# A host range at function scope: unlike ``record_function``'s user scope,
# the profiler does not mirror it onto the card's stream as a device-side
# annotation, so a trace's device events stay kernels and copies alone.
_range = torch._C._profiler._RecordFunctionFast
_recording = torch.autograd._profiler_enabled


class _Span:
    """What :func:`annotate` returns: opens the range only while a profiler
    records, tested at each entry, so a function decorated before the
    profiler started records under it."""

    __slots__ = ("name", "_open")

    def __init__(self, name: str):
        self.name = name
        self._open = None

    def __enter__(self) -> "_Span":
        if _recording():
            self._open = _range(self.name)
            self._open.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._open is not None:
            self._open.__exit__(*exc)
            self._open = None

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _range(name):
                return fn(*args, **kwargs)
        return spanned


def annotate(name: str) -> _Span:
    """A named span in profiler traces (``torch.profiler``, so on the clock
    of the device events it records), as a decorator or a context manager.
    With no profiler recording it costs a flag test."""
    return _Span(name)


def _non_finite(out) -> bool:
    """Whether a floating tensor in ``out`` (a tensor, or tuples, lists and
    dicts of them) holds a NaN or an infinity."""
    if isinstance(out, Tensor):
        return out.is_floating_point() and not bool(torch.isfinite(out).all())
    if isinstance(out, (tuple, list)):
        return any(_non_finite(o) for o in out)
    if isinstance(out, dict):
        return any(_non_finite(o) for o in out.values())
    return False


def _port_functions() -> list:
    """The ``torch.autograd.Function`` subclasses the port defines."""
    found, todo = [], list(torch.autograd.Function.__subclasses__())
    while todo:
        cls = todo.pop()
        todo.extend(cls.__subclasses__())
        if cls.__module__.startswith("mmqg_tpu_torch."):
            found.append(cls)
    return found


def _checked_apply(cls):
    apply = cls.apply      # the inherited classmethod, bound to cls

    def checked(_, *args, **kwargs):
        out = apply(*args, **kwargs)
        if _non_finite(out):
            raise FloatingPointError(
                f"non-finite output of {cls.__module__}.{cls.__qualname__} "
                "(autograd.Function forward)")
        return out
    return classmethod(checked)


@contextlib.contextmanager
def nan_debugging(enable: bool = True, model: Optional[torch.nn.Module] = None
                  ) -> Iterator[None]:
    """Raise at the first non-finite value, forward or backward.

    Backward: ``torch.autograd.set_detect_anomaly(enable)`` (a backward
    function that returns NaN raises, with the forward's traceback).
    Forward, which anomaly mode does not check: every module call and
    every ``autograd.Function`` of the port (K4's ``lstm_layer_train``,
    the max pool, the batchnorm over every position, the all-reduce) is
    checked as it returns, and the first non-finite output raises
    FloatingPointError naming it -- the module by its path in ``model``
    when given (``text_enc.lstm``), else by its class. Module calls nest,
    so the innermost module that produced the value is named. The previous
    anomaly state is restored on exit, and the checks are removed."""
    if not enable:
        yield
        return
    names = ({id(m): n or type(m).__name__ for n, m in model.named_modules()}
             if model is not None else {})

    def hook(module, args, out):
        if _non_finite(out):
            name = names.get(id(module), type(module).__name__)
            raise FloatingPointError(
                f"non-finite output of module {name} "
                f"({type(module).__name__}.forward)")

    prev = torch.is_anomaly_enabled()
    prev_check = torch.is_anomaly_check_nan_enabled()
    functions = _port_functions()
    saved = {cls: cls.__dict__.get("apply") for cls in functions}
    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        for cls in functions:
            cls.apply = _checked_apply(cls)
        yield
    finally:
        handle.remove()
        for cls, own in saved.items():
            if own is None:
                del cls.apply
            else:
                cls.apply = own
        torch.autograd.set_detect_anomaly(prev, check_nan=prev_check)


class StepTimer:
    """Wall-clock time a step, sampled every ``sync_every`` steps after a
    synchronisation: CUDA launches return before the device finishes, so
    the clock is read once the result is on the host (or, with no result
    tensor, after ``torch.cuda.synchronize()``)."""

    def __init__(self, sync_every: int = 10):
        self.sync_every = sync_every
        self.samples = []
        self._count = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> Optional[float]:
        self._count += 1
        if self._count % self.sync_every:
            return None
        leaf = _first_tensor(result)
        if leaf is not None:
            leaf.detach().cpu()          # waits for the device
        elif torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.samples.append(dt / self.sync_every)
        self._t0 = time.perf_counter()
        return self.samples[-1]

    @property
    def median(self) -> float:
        import numpy as np

        return float(np.median(self.samples)) if self.samples else float("nan")


def _first_tensor(tree) -> Optional[Tensor]:
    if isinstance(tree, Tensor):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def _leaves(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def param_mem_mb(tree) -> float:
    """Memory of the tensors, numpy arrays or ``nn.Module``s (parameters and
    buffers) in ``tree`` in MB (2**20 bytes): the reference's
    ``get_mem_usage`` over trees, the JAX function's arithmetic."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += leaf.nbytes
        elif hasattr(leaf, "size") and hasattr(leaf, "dtype"):
            total += leaf.size * leaf.dtype.itemsize
    return total / (1024 * 1024)


def device_memory_report(tensors=None) -> Dict[str, Dict[str, float]]:
    """Per-device memory in MB (1e6 bytes): for each visible card
    ``torch.cuda.memory_stats`` (``bytes_in_use_mb``: allocated now,
    ``peak_bytes_mb``: the peak since the last reset). Without a card the
    CPU has no allocator statistics: its entry's ``bytes_in_use_mb``
    counts the storages of ``tensors`` (a tree as ``param_mem_mb`` takes;
    each storage once), which is what the port can count there."""
    report = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            report[f"cuda:{i}"] = {
                "bytes_in_use_mb": stats.get("allocated_bytes.all.current",
                                             0) / 1e6,
                "peak_bytes_mb": stats.get("allocated_bytes.all.peak",
                                           0) / 1e6}
        return report
    seen, live = set(), 0
    for leaf in _leaves(tensors if tensors is not None else []):
        if isinstance(leaf, Tensor) and leaf.device.type == "cpu":
            storage = leaf.untyped_storage()
            if storage.data_ptr() not in seen:
                seen.add(storage.data_ptr())
                live += storage.nbytes()
    report["cpu"] = {"bytes_in_use_mb": live / 1e6}
    return report
