"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is ``workloads/<cell>.json``; its
configuration, ``configs/<config>.json``; its traffic mix,
``mixes/<traffic>.json``, whose ``kind`` names the driver
``traffic/<kind>.py``; ``BENCHMARK.json`` names the metrics the cell
reports, and each per-layer metric is read by ``metrics/<metric>.py``.

A run: the driver builds the system under test (``QGPipeline`` or
``Trainer`` on seeded weights), warms the cell's shapes, measures for
``--seconds`` and, with ``--trace 1``, traces a stretch of the same path.
Then the peak memory is read, the program's state is freed, the driver's
judge compares what the timed path produced with the f32 reference, and
the result is printed: the checks on standard error and
one JSON line last on standard output. Without CUDA or with fewer cards
than the cell asks for, or with ``jax``, ``jaxlib``, ``flax``, ``optax``,
``orbax`` or ``mmqg_tpu`` loaded once the window has closed, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()   # process start, as near as Python allows

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mmqg_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A driver or reader by its file path (names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is a JAX one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Run:
    """What a traffic driver gets: the cell, its configuration and mix, the
    run's arguments, and the hooks that build the system and mark the
    window."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", root: Path = HERE):
        self.cell, self.seed, self.seconds, self.trace = (cell, seed, seconds,
                                                          trace)
        self.device = device
        self.root = root
        self.workload = load_json(root / "workloads" / f"{cell}.json")
        self.cfg = load_json(root / "configs" /
                             f"{self.workload['config']}.json")
        self.mix = load_json(root / "mixes" /
                             f"{self.workload['traffic']}.json")
        self.setup_s: Optional[float] = None
        self.params = self.state = None
        self.vocab = self.index_to_word = None

    def model_config(self):
        """The port's ``ModelConfig`` of the configuration file."""
        from mmqg_tpu_torch.models import qg_model

        return qg_model.ModelConfig(**{
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in self.cfg.items() if k in qg_model.ModelConfig._fields})

    def model_weights(self):
        """(params, model_state) drawn from the seed, and the vocabulary;
        kept for the judge."""
        from portbench import gen, weights

        self.params, self.state = weights.make(self.cfg, self.seed,
                                               self.device)
        self.vocab, self.index_to_word = gen.vocab(self.cfg["n_vocab"])
        return self.params, self.state

    def pipeline(self):
        """The system under test for serving: ``QGPipeline`` on weights
        from the seed, in the configuration's compute dtype."""
        import torch

        from mmqg_tpu_torch.pipeline import QGPipeline

        params, state = self.model_weights()
        return QGPipeline(None, self.model_config(), params, state,
                          self.vocab, self.index_to_word, device=self.device,
                          dtype=getattr(torch, self.cfg["compute_dtype"]))

    def window_start(self) -> float:
        """Set-up ends: the first timed request starts now."""
        now = time.perf_counter()
        self.setup_s = now - T0
        return now


def catalog(root: Path = HERE) -> Dict[str, List[str]]:
    """What the harness finds by name: cells, configurations, mixes,
    traffic drivers and per-layer readers."""
    names = lambda sub, pat: sorted(p.name[:-len(pat) + 1]
                                    for p in (root / sub).glob(pat))
    return {"workloads": names("workloads", "*.json"),
            "configs": names("configs", "*.json"),
            "mixes": names("mixes", "*.json"),
            "traffic": names("traffic", "*.py"),
            "metrics": names("metrics", "*.py")}


def metric_names(bench: Dict, cell: str, kind: str, moves: set) -> List[Dict]:
    """The metrics of ``kind`` (end_to_end / per_layer) this cell reports."""
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m.get("moves") in moves:
            out.append(m)
    return out


def checks_of(readings: Dict, limits: Dict) -> Dict[str, Dict]:
    return {name: {"value": readings[name], "limit": limit}
            for name, limit in limits.items()}


def passed(checks: Dict[str, Dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = HERE,
             bench_path: Optional[Path] = None) -> Dict:
    """One run; returns the result object (without printing)."""
    import torch

    run = Run(cell, seed, seconds, trace, device, root)
    bench = load_json(bench_path or Path("BENCHMARK.json"))
    driver = load_module(root / "traffic" / f"{run.mix['kind']}.py")
    res = driver.drive(run)
    on_card = device != "cpu"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    readings = res["judge"]()
    readings.update(res.get("readings", {}))
    checks = checks_of(readings, run.workload["limits"])
    correct = passed(checks)

    e2e = dict(res["e2e"], setup_s=run.setup_s)
    wanted = metric_names(bench, cell, "end_to_end", set())
    metrics: Dict[str, Dict] = {}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": run.workload["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": res["attempted"],
           "failed": res["failed"]}
    if not trace:
        for m in wanted:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    else:
        tr = res["trace"]
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        ctx = dict(res["layer"], trace=tr, cfg=run.cfg)
        moves = {m["name"] for m in wanted}
        for m in metric_names(bench, cell, "per_layer", moves):
            v = load_module(root / "metrics" / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["metrics"] = metrics
    out["device"] = dev
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if not (HERE / "workloads" / f"{a.workload}.json").exists():
        print(f"portbench: no workload {a.workload!r}", file=sys.stderr)
        return 2
    chips = load_json(HERE / "workloads" / f"{a.workload}.json")["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the line is out: leave without the interpreter's teardown
    os._exit(code)
