"""The readings a cell's limits are set from, on the card, in one process:
for each seed, the cell's own run (its driver, at its size, for a short
window) and its judge's readings; for the first ``--control-seeds`` of
them also the control's (the fp8 reference put in the program's place:
for serving, read at the same positions of the same prompts and tokens;
for training, following the same steps).

    python3 -m portbench.control --workload <cell> --seeds 11,12,... \\
        --control-seeds 3 --seconds 3 [--fault half_batch] [--out FILE]

``--fault half_batch`` plants a fault in the program for every seed: each
train step leaves the second half of its batch out and takes the mean
over the rest (the reading a training cell's number is also held
against). Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from portbench.run import HERE, Run, load_module


def readings(cell: str, seed: int, seconds: float, control: bool,
             device: str = "cuda", root: Path = HERE) -> dict:
    run = Run(cell, seed, seconds, False, device, root)
    driver = load_module(root / "traffic" / f"{run.mix['kind']}.py")
    res = driver.drive(run)
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out = res["judge"](control=control)
    out.update(seed=seed, cell=cell, judge_s=time.perf_counter() - t,
               setup_s=run.setup_s, **res.get("readings", {}))
    return out


def plant_half_batch() -> None:
    """Every loss the train step takes covers the first half of its rows."""
    from mmqg_tpu_torch.models import qg_model

    loss_fn = qg_model.loss_fn

    def half(model, mc, batch, **kw):
        valid = batch["valid"].clone()
        valid[valid.shape[0] // 2:] = False
        return loss_fn(model, mc, dict(batch, valid=valid), **kw)
    qg_model.loss_fn = half


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    if a.fault == "half_batch":
        plant_half_batch()
    seeds = [int(s) for s in a.seeds.split(",")]
    sink = open(a.out, "a") if a.out else None
    for i, seed in enumerate(seeds):
        r = dict(readings(a.workload, seed, a.seconds, i < a.control_seeds),
                 fault=a.fault)
        line = json.dumps(r)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
