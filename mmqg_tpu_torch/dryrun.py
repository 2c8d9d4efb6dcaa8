"""The multichip dry run (``__graft_entry__.py::dryrun_multichip``): one
train step on a ``(data, model)`` mesh of processes at tiny shapes, with
every parallel mode held to the one-process result.

    python -m mmqg_tpu_torch.dryrun                 # every visible card
    python -m mmqg_tpu_torch.dryrun 4 --device cpu  # four gloo processes

``n_devices`` processes form a ``dp x tp`` grid, tp = 2 when n is even
(hidden 16: 4H = 64 splits over it), one per card (NCCL) or all on the
first card or the CPU (gloo), and each runs, on JAX's tiny trimodal
configuration and batch:

* a bf16 train step on the grid (the state stored over the model axis by
  JAX's rules) with a finite loss, and a greedy decode with the updated
  weights (the vocab projection column-parallel);
* the sequence-parallel decode (``mesh.sp_greedy_decode``), both modes,
  token-identical to it;
* f32 comparisons against one process's step on the whole batch: the
  loss and the gradient norm of the tensor-parallel step and of both
  sequence-parallel steps, and the update of ZeRO-1 and FSDP (with a data
  axis) against the plain grid's;
* GPipe on toy stages over the model axis (the data axis when tp = 1):
  forward and parameter gradients against the sequential stack.

Rank 0 prints one line with the deltas, and every check raises.
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import sys
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

N_VOCAB = 64
FRAME = 32
# JAX's dryrun tolerances (f32): the loss, the gradient norm, and the
# update of ZeRO-1/FSDP relative to the update's size (Adam's first step
# is lr x sign(g), so a gradient at rounding noise flips a whole step)
LOSS_RTOL, NORM_RTOL, UPDATE_RTOL, PP_RTOL, PP_GRAD_RTOL = \
    1e-5, 1e-5, 0.15, 1e-6, 1e-5


def tiny_config(dp: int):
    """JAX's dryrun configuration (``__graft_entry__.py``)."""
    from mmqg_tpu_torch.config import Config
    from mmqg_tpu_torch.models.video_encoder import flatten_dim_for

    return Config(
        glove_emb_dim=8, batch_size=dp * 2, question_max_length=6,
        context_max_length=12, av_max_length=3, frame_size=FRAME,
        flatten_dim=flatten_dim_for(FRAME), video_hidden_dim=16,
        text_lstm_hidden_dim=16, text_lstm_layers=2, dec_lstm_hidden_dim=16,
        dec_lstm_layers=2, audio_emb=8, audio_sample_rate=1600,
        stft_window=64, stft_hop=32, mel_bins=16, mel_frames_per_example=16,
        use_pallas=False)


def tiny_batch(config, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """JAX's dryrun batch, drawn after the embedding table."""
    B = config.batch_size
    S = 2 * config.audio_sample_rate
    return {
        "context_ids": rng.randint(3, N_VOCAB, (B, 12)).astype(np.int32),
        "context_len": np.full((B,), 12, np.int32),
        "frames": rng.randint(0, 255, (B, 3, FRAME, FRAME, 3)).astype(
            np.uint8),
        "frames_len": np.full((B,), 3, np.int32),
        "audio_pcm": (rng.randn(B, S) * 3000).astype(np.int16),
        "audio_len": np.full((B,), S, np.int32),
        "target_ids": rng.randint(3, N_VOCAB, (B, 7)).astype(np.int32),
        "target_len": np.full((B,), 7, np.int32),
        "valid": np.ones((B,), bool)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _run(grid, device: torch.device) -> Optional[dict]:
    """One rank's checks; rank 0's deltas."""
    from mmqg_tpu_torch import decode as DEC
    from mmqg_tpu_torch.compat.from_jax import train_state_to_numpy
    from mmqg_tpu_torch.models import qg_model
    from mmqg_tpu_torch.optim import tree_leaves
    from mmqg_tpu_torch.parallel import model_axis, multihost
    from mmqg_tpu_torch.parallel.mesh import row_block, sp_greedy_decode
    from mmqg_tpu_torch.train import (init_train_state, make_optimizer,
                                      make_train_step, to_device)

    dp, tp = grid.shape
    config = tiny_config(dp)
    mc = qg_model.ModelConfig.from_config(config, n_vocab=N_VOCAB,
                                          mode="trimodal")
    rng = np.random.RandomState(0)
    emb = rng.randn(N_VOCAB, mc.word_emb_dim).astype(np.float32)
    batch = tiny_batch(config, rng)
    lo, hi = row_block(grid.data_index, dp, config.batch_size)
    mine = to_device({k: v[lo:hi] for k, v in batch.items()}, device)
    whole = to_device(batch, device)
    optimizer = make_optimizer(config)
    data = grid.data_group if dp > 1 else None

    def fresh():
        ts = init_train_state(mc, emb, optimizer, seed=0, device=device)
        qg_model.set_process_group(ts.model, data)
        return ts

    def grid_step(dtype, **kw):
        ts = fresh()
        step = make_train_step(mc, optimizer, dtype=dtype, grid=grid, **kw)
        ts, m = step(ts, mine, None)
        return ts, float(m["loss"]), float(m["grad_norm"])

    def host_params(ts):
        if ts.model.tp is not None:
            return ts.model.tp.host_state(ts)["params"]
        if ts.shards is not None:
            return ts.shards.host_state(ts)["params"]
        return train_state_to_numpy(ts.model, ts.opt_state, 0)["params"]

    # the bf16 step on the grid, then decodes with its weights
    ts, loss, _ = grid_step(torch.bfloat16)
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss on the {dp}x{tp} grid: {loss}")
    with torch.no_grad(), model_axis.whole(ts.model):
        toks = DEC.decode_batch(ts.model, mc, mine, strategy="greedy",
                                max_len=4)
    if tuple(toks.shape) != (hi - lo, 4):
        raise AssertionError(f"decode shape {tuple(toks.shape)}")
    for gather_free in (False, True):
        sp = sp_greedy_decode(ts.model, mc, mine, grid, max_len=4,
                              gather_free=gather_free)
        if not torch.equal(sp, toks):
            raise AssertionError(f"SP decode (gather_free={gather_free}) "
                                 "differs from the greedy decode")

    # f32: one process on the whole batch, and the grid's modes
    ref = fresh()
    ref_step = make_train_step(mc, optimizer, dtype=torch.float32)
    p0 = train_state_to_numpy(ref.model, ref.opt_state, 0)["params"]
    ref, m = ref_step(ref, whole, None)
    loss_ref, gn_ref = float(m["loss"]), float(m["grad_norm"])
    p_ref = train_state_to_numpy(ref.model, ref.opt_state, 1)["params"]
    out = {"mesh": (dp, tp), "loss": loss}
    ts_tp, loss_tp, gn_tp = grid_step(torch.float32)
    out["tp_dloss"], out["tp_dgnorm"] = _rel(loss_tp, loss_ref), \
        _rel(gn_tp, gn_ref)
    for name, kw in (("sp", {}), ("sp_gather_free", {"sp_gather_free":
                                                     True})):
        _, l_sp, g_sp = grid_step(torch.float32, sp_mesh=grid, **kw)
        out[f"{name}_dloss"], out[f"{name}_dgnorm"] = _rel(l_sp, loss_ref), \
            _rel(g_sp, gn_ref)
    for k, v in out.items():
        if k.endswith("dloss") and v > LOSS_RTOL or \
                k.endswith("dgnorm") and v > NORM_RTOL:
            raise AssertionError(f"{k} {v:.2e} on the {dp}x{tp} grid")

    def upd_err(p_new, p_want):
        worst = 0.0
        for a0, a, b in zip(tree_leaves(p0), tree_leaves(p_want),
                            tree_leaves(p_new)):
            upd = np.linalg.norm(np.asarray(a, np.float64) - a0)
            err = np.linalg.norm(np.asarray(b, np.float64) - a)
            worst = max(worst, err / (upd + 1e-30))
        return worst

    p_tp = host_params(ts_tp)
    out["tp_upd_relerr"] = upd_err(p_tp, p_ref)
    if dp > 1:
        for name in ("zero1", "fsdp"):
            ts_z, l_z, _ = grid_step(torch.float32, zero1=True,
                                     fsdp=name == "fsdp")
            out[f"{name}_upd_relerr"] = upd_err(host_params(ts_z), p_tp)
            if _rel(l_z, loss_tp) > LOSS_RTOL:
                raise AssertionError(f"{name} loss {l_z} vs {loss_tp}")
    for k, v in out.items():
        if k.endswith("upd_relerr") and v > UPDATE_RTOL:
            raise AssertionError(f"{k} {v:.2e} on the {dp}x{tp} grid")

    # GPipe: stages over the model axis (the data axis when tp is 1)
    pp = gpipe_deltas(grid, device, axis="model" if tp > 1 else "data")
    out["pp_fwd_relerr"], out["pp_grad_relerr"] = pp["fwd"], pp["grad"]
    out["pp"] = f"{pp['stages']} stages on {pp['axis']}"
    if out["pp_fwd_relerr"] > PP_RTOL or out["pp_grad_relerr"] > PP_GRAD_RTOL:
        raise AssertionError(f"GPipe vs sequential: {out}")
    multihost.barrier()
    return out if grid.rank == 0 else None


def gpipe_deltas(grid, device, *, axis: str = "model", width: int = 8,
                 n_micro: int = 4, mb: int = 2, seed: int = 1) -> dict:
    """GPipe on toy stages (tanh(x W + b), ``width`` wide) over ``grid``'s
    model axis, each data row on its own ``n_micro x mb`` rows (DP x PP),
    or over its data axis (``axis="data"``, one pipeline): the largest
    forward and stacked-gradient differences from the sequential stack on
    every row, over their largest values, and the forward + backward
    wall ms."""
    import time

    from mmqg_tpu_torch.parallel import model_axis
    from mmqg_tpu_torch.parallel.gpipe import (gpipe, microbatch,
                                               stack_stage_params,
                                               unmicrobatch)

    on_model = axis == "model"
    S = grid.tp if on_model else grid.dp
    group = grid.model_group if on_model else grid.data_group
    ranks = grid.model_ranks if on_model else grid.data_ranks
    n_rows, row = (grid.dp, grid.data_index) if on_model else (1, 0)
    rng = np.random.RandomState(seed)
    stacked = stack_stage_params([
        {"w": torch.tensor(rng.randn(width, width) / np.sqrt(width),
                           dtype=torch.float32, device=device),
         "b": torch.tensor(rng.randn(width) * 0.1, dtype=torch.float32,
                           device=device)} for _ in range(S)])
    rows = n_micro * mb
    x_all = torch.tensor(rng.randn(rows * n_rows, width),
                         dtype=torch.float32, device=device)

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    leaves = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    y = gpipe(stage_fn, leaves,
              microbatch(x_all[row * rows:(row + 1) * rows], n_micro),
              group=group, ranks=ranks)
    (y ** 2).sum().backward()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    grads = {k: v.grad.clone() for k, v in leaves.items()}
    if on_model:            # the data rows' parts of the batch
        for g in grads.values():
            model_axis.all_reduce_(g, grid.data_group)
    ref = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
    h = x_all
    for s in range(S):
        h = stage_fn({k: v[s] for k, v in ref.items()}, h)
    (h ** 2).sum().backward()
    want = h.detach()[row * rows:(row + 1) * rows]
    return {"fwd": float((unmicrobatch(y.detach()) - want).abs().max()
                         / want.abs().max()),
            "grad": max(float((grads[k] - ref[k].grad).abs().max()
                              / ref[k].grad.abs().max()) for k in grads),
            "ms": ms, "stages": S, "axis": axis}


def _worker(rank: int, world: int, port: int, device: str, backend: str,
            result: str) -> None:
    from mmqg_tpu_torch.parallel import multihost

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    multihost.initialize_multihost(f"localhost:{port}", world, rank,
                                   device=dev, backend=backend,
                                   timeout_s=600)
    tp = 2 if world % 2 == 0 else 1
    try:
        out = _run(multihost.Grid((world // tp, tp)), dev)
        if out is not None:
            torch.save(out, result)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dryrun_multichip(n_devices: Optional[int] = None, *, device="cuda",
                     timeout_s: float = 600.0) -> dict:
    """Run the dry run in ``n_devices`` processes (default: one per
    visible card) and return rank 0's deltas, printed as one line. On the
    card the processes take one card each and NCCL when there are as many
    cards, else they share the first card over gloo; ``device="cpu"``
    runs them on the CPU over gloo. Without CUDA the card's run raises."""
    import multiprocessing

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device is available; "
                           "pass device='cpu' for the CPU")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    n = int(n_devices or cards or 1)
    backend = "nccl" if dev.type == "cuda" and cards >= n else "gloo"
    if dev.type == "cuda":
        from mmqg_tpu_torch.ops import _build
        _build.library()           # built once, before the ranks look
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="mmqg_dryrun_") as tmp:
        result = str(Path(tmp) / "rank0.pt")
        procs = [ctx.Process(target=_worker, args=(r, n, port, dev.type,
                                                   backend, result))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * n:
            raise RuntimeError(f"dryrun_multichip: ranks exited with {codes}")
        out = torch.load(result, weights_only=False)
    out["backend"] = backend
    dp, tp = out["mesh"]
    print(f"dryrun_multichip OK: mesh=({dp} data, {tp} model), "
          f"{backend} on {dev.type}, loss={out['loss']:.4f}, "
          "sp_decode=token-identical (both modes), f32 deltas vs one "
          f"process: tp_dloss={out['tp_dloss']:.1e} "
          f"tp_dgnorm={out['tp_dgnorm']:.1e} "
          f"train_sp_dloss={out['sp_dloss']:.1e} "
          f"train_sp_dgnorm={out['sp_dgnorm']:.1e} "
          f"gather_free_dloss={out['sp_gather_free_dloss']:.1e} "
          f"tp_upd_relerr={out['tp_upd_relerr']:.1e} "
          + "".join(f"{k}={out[k]:.1e} " for k in ("zero1_upd_relerr",
                                                    "fsdp_upd_relerr")
                    if k in out)
          + f"pp_fwd_relerr={out['pp_fwd_relerr']:.1e} "
          f"pp_grad_relerr={out['pp_grad_relerr']:.1e} (gpipe {out['pp']})",
          flush=True)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Multichip dry run of the "
                                     "PyTorch port's (data, model) mesh")
    parser.add_argument("n_devices", nargs="?", type=int, default=None,
                        help="processes (default: the visible cards)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu' (gloo processes)")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main(sys.argv[1:])
