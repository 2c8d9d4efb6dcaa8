"""Build and drive the PyTorch + CUDA port (mmqg_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device   the card's name and power limit (nvidia-smi), torch/CUDA/nvcc
2. build    nvcc builds the kernels in mmqg_tpu_torch/csrc/ (seconds)
3. K1       lstm_seq kernel vs its plain PyTorch version, on the card, at
            the encoders' shapes and one edge case (B=5, T=1); the route must
            be the persistent sweep; at text layer 0 bf16 the persistent and
            per-step routes timed in turns beside cuDNN, the input GEMM
            alone, the sweep's barrier floor and the routes at B=128
4. K2       trimodal_attention's tiled route vs its plain version, on the
            card, at B = 1, 32, 33 and 128 and lengths random, 1, L and
            L - 3; at B=32 and 128 the tiled and the first (per_row) route
            timed in turns
5. main     QGPipeline at the flagship's full width (random weights from a
            seed) answers 32 greedy requests; K1 must launch 4x per encode,
            each by the persistent route, K2 21x per decode by the tiled
            route, and the int8 conv 5x (s8 route) and quantize_s8 5x per
            encode
6. card/cpu the same pipeline in f32 on 4 requests, on the card and on the
            CPU: identical greedy tokens, logits within a stated tolerance
7. K4       lstm_layer_train forward + backward kernels vs their plain
            versions at the encoders' shapes and one edge case (B=5, T=1),
            f32 and bf16, with times; the forward's and the backward's
            routes must be the persistent sweeps at the encoders' shapes; the
            forward's two routes timed in turns at text layer 0 bf16
8. train    Trainer.run_epoch at the flagship's full width, bf16, batch 32,
            on a synthetic in-memory corpus: K4 must launch 4x forward and
            4x backward per step, all persistent, K1/K2 none; one step timed
            and profiled
            (step ms, samples/s, device idle share); then validate(), which
            must launch K1 4x per batch and K2 22x per batch
9. train card/cpu  one f32 train step of 4 samples on the card and on the
            CPU (He-scaled VGGish convs and tone audio, so the audio
            attention has gradients to compare): loss, every gradient leaf
            and the updated parameters within stated tolerances
10. K3      vggish_conv kernel vs its plain version on the serving batch's
            1184 examples of 96 x 64 log-mel, f32 and bf16, with the cuDNN
            conv2..conv6 stack timed beside it, and in bf16 at two ragged
            sizes (1 and 37 examples); then the K3 path,
            AudioEncoder.forward(use_kernel=True), must launch it 5x
11. int8    vggish_conv_int8 (the s8 tensor-core route and the forced
            __dp4a one, timed in turns) vs its plain version on the same
            batch's quantized inputs, each of the five layers, dynamic and
            static scales: max |d| must be 0; the fused next-layer quantize
            and quantize_s8 vs quantize_activations: identical int8 and
            scales; the whole int8 stack (quantizes included) new vs old in
            turns, and at 1 and 37 examples; torch._int_mm as a yardstick
12. calibrate  QGPipeline.calibrate_audio_int8 on the card, then one greedy
            generate() with the static scales (quantize_s8 once: the later
            quantizes are the convs' epilogues)

Phase 5 serves with the int8 VGGish, the card's default (vggish_conv_int8
5x per encode), and times questions/s and encode ms with it and with the
bf16 cuDNN tower in turns (int8, bf16, bf16, int8). Phase 6 also compares
the int8 tower on the card with the CPU's plain int8, called through
AudioEncoder.forward(int8=True): identical greedy tokens, logits within a
stated tolerance.

The line before the last is the kernels' JSON summary (each kernel's
design, launches on its path, max |kernel - plain|, its ms, the plain
version's, its bound on the H100 and what bounds it, and one library call's
ms where one computes the same function); the last line is ``{"ok": true, "device":
{...}}``. Without a CUDA device the script exits non-zero before printing
any result. It imports nothing of JAX and nothing of the JAX package
``mmqg_tpu``, and checks at the end that no such module was loaded.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import List

import numpy as np
import torch
from torch.autograd import DeviceType

from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.data.vocab import END_ID
from mmqg_tpu_torch.models import frontends
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.models.qg_model import ModelConfig, init_params
from mmqg_tpu_torch.ops import _build
from mmqg_tpu_torch.ops import vggish as V
from mmqg_tpu_torch.ops.attention import (trimodal_attention,
                                          trimodal_attention_plain)
from mmqg_tpu_torch.ops.lstm import lstm_seq, lstm_seq_plain
from mmqg_tpu_torch.ops.lstm_train import (bwd_route, lstm_layer_train,
                                           lstm_train_bwd_plain,
                                           lstm_train_fwd_plain)
from mmqg_tpu_torch.optim import (apply_updates, make_optimizer, tree_leaves,
                                  tree_map)
from mmqg_tpu_torch.pipeline import QGPipeline
from mmqg_tpu_torch.train import Trainer, batch_arrays, to_device

SEED = 0
# Comparisons on the card run in true f32: cuBLAS matmuls and cuDNN convs
# would otherwise be free to use TF32 (cuDNN does by default).
TF32 = False


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``iters``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, names, iters: int = 50) -> float:
    """Mean device time in ms of one kernel whose name contains one of
    ``names``, over ``iters`` calls of ``fn()`` (one such launch each),
    from torch.profiler's CUDA activity: the kernels alone, without the
    gaps between launches that CUDA events count when the host, not the
    device, sets the pace. The mean is over the kernel records the
    profiler kept, so a dropped record does not bias it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and any(n in e.name for n in names)]
    if not spans:
        raise AssertionError(f"the profiler saw no device time in {names}")
    if len(spans) != iters:
        log(f"  device_ms: {len(spans)} kernel records of {iters} launches")
    return sum(spans) / len(spans) / 1e3


def max_abs(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


# Published peaks of one H100 SXM, dense (NVIDIA H100 datasheet)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
HBM_BYTES_S = 3.35e12


def bound(ops: float, nbytes: float, dtype) -> dict:
    """The least time the card could take: the larger of the operations at
    ``dtype``'s peak and the bytes at the memory rate, and which bounds."""
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------------- phases

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = TF32
    torch.backends.cudnn.allow_tf32 = TF32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]} python {sys.version.split()[0]}"
        f" tf32 matmul={TF32} cudnn={TF32}")
    return {"card": card, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> float:
    built = _build.build()
    _build.library()
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"build: {built.seconds:.1f} s ({built.path.name})")
    return built.seconds


# the encoders' LSTM layers at B=32 (K1 and K4), and the edges of the
# sweeps' grid barrier (one step) and of the GEMM tiles (5 rows, In = 300):
# checked, not timed against the path
LSTM_SHAPES = (("text layer 0", 32, 283, 300, 512),
               ("text layer 1", 32, 283, 512, 512),
               ("video", 32, 101, 1000, 512))
LSTM_EDGE = ("edge", 5, 1, 300, 512)


def routes_taken(counts: dict, before: dict) -> str:
    """The routes a call took, from a route counter before and after."""
    return ",".join(k for k, v in counts.items() if v - before[k])


def in_turns(fns: dict, iters: int = 5) -> dict:
    """{route: [ms, ms]}: each of two routes' callables timed twice, in the
    order a, b, b, a (the dict's order; persistent, per_step for K1/K4)."""
    a, b = fns
    out = {}
    for name in (a, b, b, a):
        out.setdefault(name, []).append(cuda_ms(fns[name], iters=iters))
    return out


def fmt_turns(times: dict) -> str:
    return ", ".join(f"{k} " + " / ".join(f"{t:.3f}" for t in v) + " ms"
                     for k, v in times.items())


def _k1_case(rng, B, T, In, H, dtype, dev):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    xs = t(rng.randn(B, T, In))
    wx = t(rng.randn(In, 4 * H) / np.sqrt(In))
    wh = t(rng.randn(H, 4 * H) / np.sqrt(H))
    b = t(rng.randn(4 * H) * 0.1)
    h0 = torch.zeros((B, H), device=dev)
    lens = torch.from_numpy(rng.randint(1, T + 1, B).astype(np.int32)).to(dev)
    args = (xs, wx, wh, b, h0, h0, lens)
    before = dict(lstm_seq.routes)
    got = lstm_seq(*args, dtype=dtype)
    route = routes_taken(lstm_seq.routes, before)
    ref = lstm_seq_plain(*args, dtype=dtype)
    torch.cuda.synchronize()
    err = max(max_abs(g, r) for g, r in zip(got, ref))
    ms = cuda_ms(lambda: lstm_seq(*args, dtype=dtype))
    plain_ms = cuda_ms(lambda: lstm_seq_plain(*args, dtype=dtype), iters=3)
    # every step of every row, input projection and recurrence
    bnd = bound(2 * B * T * (In + H) * 4 * H, nbytes(*args, *got), dtype)
    return err, ms, plain_ms, bnd, args, route


def cudnn_lstm(wx, wh, b, xs, lens, dtype):
    """(forward, forward + backward) callables of cuDNN's LSTM (torch.nn.LSTM)
    on K1/K4's weights in ``dtype``, over ``xs`` packed by ``lens``: the
    library yardstick for K1 and K4 (the port never calls it)."""
    In, H4 = wx.shape
    lstm = torch.nn.LSTM(In, H4 // 4, batch_first=True).to(xs.device, dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.t())
        lstm.weight_hh_l0.copy_(wh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    lstm.flatten_parameters()
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        xs.to(dtype), lens.cpu(), batch_first=True, enforce_sorted=False)
    x = packed.data.requires_grad_(True)
    packed = torch.nn.utils.rnn.PackedSequence(
        x, packed.batch_sizes, packed.sorted_indices, packed.unsorted_indices)
    cot = torch.randn((x.shape[0], H4 // 4), device=xs.device, dtype=dtype)

    def fwd():
        with torch.no_grad():
            return lstm(packed)

    def fwd_bwd():
        out, _ = lstm(packed)
        torch.autograd.backward(out.data, cot)
    return fwd, fwd_bwd


def cudnn_lstm_ms(wx, wh, b, xs, lens, dtype) -> dict:
    """cuDNN LSTM forward and backward ms (backward: forward + backward less
    the forward), or None each where cuDNN refuses ``dtype``. cuDNN runs
    only each row's valid steps (packed); K1 and K4 run all T steps of
    every row."""
    try:
        fwd, fwd_bwd = cudnn_lstm(wx, wh, b, xs, lens, dtype)
        f = cuda_ms(fwd, iters=5, warmup=2)
        return {"fwd": f, "bwd": cuda_ms(fwd_bwd, iters=5, warmup=2) - f}
    except RuntimeError as e:   # a yardstick only: the port never calls it
        log(f"  cuDNN LSTM in {dtype} refused: {str(e).splitlines()[0]}")
        return {"fwd": None, "bwd": None}


def fmt_ms(t) -> str:
    return "n/a" if t is None else f"{t:.3f} ms"


# max |kernel - plain| allowed. f32: the two differ only in summation order,
# carried through up to 283 recurrent steps. bf16: h is rounded to bf16
# before every Wh product, so one order-induced rounding flip moves h by a
# bf16 ulp (2^-8 relative) and the recurrence carries it on.
K1_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
# K2: both versions take the same operands and compute in f32 in either dtype
K2_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}


def _input_gemm(args, dtype, card: str) -> float:
    """Time the forward's input projection alone (x.Wx + b, the kernel K1
    and K4's forward both launch first) on K1's inputs ``args``, beside
    cuBLAS's matmul of the same operands; returns its ms."""
    xs, wx, _, b = args[:4]
    B, T, In = xs.shape
    N = wx.shape[1]
    x = xs.to(dtype).reshape(B * T, In).contiguous()
    w = wx.to(dtype).contiguous()
    out = torch.empty((B * T, N), device=xs.device)
    lib = _build.library()

    def run():
        _build.check(lib.mmqg_lstm_input_proj(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B * T,
            N, In, int(dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream), "mmqg_lstm_input_proj")
    run()
    err = max_abs(out, L.mm(x, w, dtype) + b)
    ms = cuda_ms(run, iters=20)
    lib_ms = cuda_ms(lambda: torch.matmul(x, w), iters=20)
    bnd = bound(2 * B * T * In * N, nbytes(x, w, b, out), dtype)
    log(f"K1/K4 input GEMM alone (x.Wx + b, M={B * T} N={N} K={In} "
        f"{str(dtype)[6:]}): {ms:.4f} ms, max|d| from plain {err:.2e}; "
        f"cuBLAS matmul ({str(dtype)[6:]} out) {lib_ms:.4f} ms; bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) [{card}]")
    if not err <= 1e-4 * float(out.abs().max()):
        raise AssertionError(f"input GEMM max|d| {err}")
    return ms


def phase_k1(card: str) -> dict:
    rng = np.random.RandomState(SEED)
    dev = torch.device("cuda")
    summary, failures = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, T, In, H in LSTM_SHAPES + (LSTM_EDGE,):
            err, ms, plain_ms, bnd, args, route = _k1_case(rng, B, T, In, H,
                                                           dtype, dev)
            lib = cudnn_lstm_ms(args[1], args[2], args[3], args[0], args[6],
                                dtype)
            log(f"K1 lstm_seq {name} B={B} T={T} In={In} H={H} "
                f"{str(dtype)[6:]}: route {route}; max|d|={err:.3e} (tol "
                f"{K1_TOL[dtype]:.0e}) kernel {ms:.3f} ms plain "
                f"{plain_ms:.3f} ms cuDNN LSTM fwd {fmt_ms(lib['fwd'])} bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; {T} dependent "
                f"steps) [{card}]")
            if not err <= K1_TOL[dtype]:
                failures.append(f"{name} {dtype}: max|d| {err}")
            if route != "persistent":
                failures.append(f"{name} {dtype}: route {route}")
            if dtype == torch.bfloat16 and name == "text layer 0":
                turns = in_turns({r: lambda r=r: lstm_seq(
                    *args, dtype=dtype, force_route=r)
                    for r in ("persistent", "per_step")})
                log(f"K1 text layer 0 bf16, both routes in turns: "
                    f"{fmt_turns(turns)}; cuDNN LSTM fwd {fmt_ms(lib['fwd'])}"
                    f" [{card}]")
                summary = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           **bnd, "library_ms": lib["fwd"],
                           "per_step_ms": min(turns["per_step"]),
                           "input_gemm_ms": _input_gemm(args, dtype, card)}
    # the latency floor of each design: 283 back-to-back launches of a
    # one-element kernel (one launch a step), and one cooperative launch of
    # the sweep's grid doing 283 grid barriers and nothing else
    one = torch.zeros(1, device=dev)
    floor = cuda_ms(lambda: [one.add_(1.0) for _ in range(283)], iters=5)
    log(f"K1 latency floor: 283 dependent one-element launches take "
        f"{floor:.3f} ms ({floor / 283 * 1e3:.2f} us each) [{card}]")
    lib = _build.library()
    sync = torch.empty(1, dtype=torch.int32, device=dev)

    def barrier_floor():
        _build.check(lib.mmqg_lstm_barrier_floor(
            sync.data_ptr(), 32, 512, 283,
            torch.cuda.current_stream().cuda_stream),
            "mmqg_lstm_barrier_floor")
    barriers = cuda_ms(barrier_floor, iters=5)
    log(f"K1/K4 barrier floor: one cooperative launch of the sweep's 64 x 2 "
        f"grid (B=32, H=512) doing 283 grid barriers takes {barriers:.3f} ms "
        f"({barriers / 283 * 1e3:.2f} us a barrier) [{card}]")
    # the batch a later benchmark serves
    both = (torch.bfloat16, torch.float32)

    def rows(entry, dtype):
        return str(16 * _build.sweep_rows(entry, 128, 512,
                                          dtype == torch.bfloat16, 0))
    log("routes at B=128, H=512 (bf16 / f32): K1 persistent, "
        + " / ".join(rows("mmqg_lstm_seq_rows", d) for d in both)
        + " rows a cooperative launch; K4 forward persistent, "
        + " / ".join(rows("mmqg_lstm_train_fwd_rows", d) for d in both)
        + " rows a launch; K4 backward "
        + " / ".join(bwd_route(128, 512, d) for d in both)
        + " (0 rows: per_step)")
    err, ms, _, _, args, route = _k1_case(rng, 128, 283, 300, 512,
                                          torch.bfloat16, dev)
    lib = cudnn_lstm_ms(args[1], args[2], args[3], args[0], args[6],
                        torch.bfloat16)
    log(f"K1 lstm_seq text layer 0 B=128 bf16: route {route}; max|d|="
        f"{err:.3e} (tol {K1_TOL[torch.bfloat16]:.0e}) kernel {ms:.3f} ms "
        f"cuDNN LSTM fwd {fmt_ms(lib['fwd'])} [{card}]")
    if not err <= K1_TOL[torch.bfloat16]:
        failures.append(f"B=128: max|d| {err}")
    if failures:
        raise AssertionError(f"K1 kernel and plain disagree: {failures}")
    return dict(summary, barrier_floor_ms=barriers)


# (B, lengths) of the K2 phase: the decode's batch and a later benchmark's
# (timed, both routes in turns), a lone row, a ragged batch tile (33 rows),
# and lengths 1, L and L - 3 (not a multiple of the tiled route's
# 16-position chunk)
K2_CASES = ((32, "random"), (128, "random"), (1, "random"), (33, "random"),
            (32, "one"), (33, "full"), (33, "ragged"))


def _k2_case(rng, B, dtype, dev, lengths="random"):
    Dq, Lt, La, Ht, Hv, Ha = 812, 283, 101, 512, 512, 128

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)
    w_t = t(rng.randn(Lt + 2 * La, Dq) / np.sqrt(Dq))
    b = t(rng.randn(Lt + 2 * La), torch.float32)
    q = t(rng.randn(B, Dq))
    mems = [t(rng.randn(B, L, Hm)) for L, Hm in ((Lt, Ht), (La, Hv), (La, Ha))]
    lens = [torch.from_numpy((rng.randint(1, L + 1, B) if lengths == "random"
                              else np.full(B, {"one": 1, "full": L,
                                               "ragged": L - 3}[lengths])
                              ).astype(np.int32)).to(dev)
            for L in (Lt, La, La)]
    args = (w_t, b, q, *mems, *lens)
    before = dict(trimodal_attention.routes)
    got = trimodal_attention(*args)
    route = routes_taken(trimodal_attention.routes, before)
    ref = trimodal_attention_plain(*args)
    torch.cuda.synchronize()
    err = max(max_abs(g, r) for g, r in zip(got[:3], ref[:3]))
    err = max([err] + [max_abs(got[3][k], ref[3][k]) for k in got[3]])
    # the weights and query once, each memory row below its length once
    # (the kernel skips the rest), the contexts and maps written once
    rows = [int(n.clamp(max=m.shape[1]).sum()) for n, m in zip(lens, mems)]
    mem_bytes = sum(r * m.shape[2] * m.element_size()
                    for r, m in zip(rows, mems))
    ops = 2 * B * Dq * (Lt + 2 * La) + 2 * sum(
        r * m.shape[2] for r, m in zip(rows, mems))
    bnd = bound(ops, nbytes(w_t, b, q, *lens, *got[:3], got[3]["text"],
                            got[3]["video"], got[3]["audio"]) + mem_bytes,
                dtype)
    return err, route, args, bnd


def phase_k2(card: str) -> dict:
    """The tiled route against the plain version at every K2_CASES entry,
    f32 and bf16; at B=32 and 128 with random lengths the tiled and the
    first (per_row) route timed in turns beside the plain version: each
    kernel's device time (torch.profiler), and the wrapper's calls back to
    back (CUDA events; the host sets that pace)."""
    rng = np.random.RandomState(SEED + 1)
    dev = torch.device("cuda")
    summary, failures = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        for B, lengths in K2_CASES:
            err, route, args, bnd = _k2_case(rng, B, dtype, dev, lengths)
            line = (f"K2 trimodal_attention B={B} Dq=812 L=283/101/101 "
                    f"lengths {lengths} {str(dtype)[6:]}: route {route}; "
                    f"max|d|={err:.3e} (tol {K2_TOL[dtype]:.0e})")
            if lengths == "random" and B in (32, 128):
                kernel = {"tiled": ("attn_tile_kernel",),
                          "per_row": ("trimodal_attention_kernel",)}
                dev_turns, call_turns = {}, {}
                for r in ("tiled", "per_row", "per_row", "tiled"):
                    def call(r=r):
                        return trimodal_attention(*args, force_route=r)
                    dev_turns.setdefault(r, []).append(
                        device_ms(call, kernel[r]))
                    call_turns.setdefault(r, []).append(
                        cuda_ms(call, iters=50))
                plain_ms = cuda_ms(lambda: trimodal_attention_plain(*args),
                                   iters=20)
                line += (f"; device time in turns: {fmt_turns(dev_turns)}; "
                         f"calls back to back (host-paced): "
                         f"{fmt_turns(call_turns)}; plain {plain_ms:.4f} ms;"
                         f" bound {bnd['bound_ms']:.4f} ms "
                         f"({bnd['bound_by']}; no library call computes it)")
                if dtype == torch.bfloat16 and B == 32:
                    summary = {"max_abs_err": err,
                               "ms": min(dev_turns["tiled"]),
                               "plain_ms": plain_ms, **bnd,
                               "library_ms": None,
                               "per_row_ms": min(dev_turns["per_row"]),
                               "call_ms": min(call_turns["tiled"])}
            log(f"{line} [{card}]")
            if not err <= K2_TOL[dtype] or route != "tiled":
                failures.append(f"B={B} {lengths} {dtype}: max|d| {err} "
                                f"route {route}")
    if failures:
        raise AssertionError(f"K2 kernel and plain disagree: {failures}")
    return summary


N_VOCAB = 2000        # the flagship's vocabulary (__graft_entry__._flagship)
N_REQUESTS = 32


def flagship():
    """The flagship model at full width (qg_model.ModelConfig defaults:
    GloVe 300, hidden 512, 3+3 LSTM layers, Lc 283, AV 101, 112 x 112
    frames, VGGish) with random weights from SEED, and a synthetic vocab."""
    mc = ModelConfig(n_vocab=N_VOCAB)
    params, state = init_params(mc, SEED)
    words = ["<pad>", "<start>", "<end>"] + [f"w{i}" for i in
                                             range(3, N_VOCAB)]
    vocab = {w: i for i, w in enumerate(words)}
    return mc, params, state, vocab, {str(i): w for i, w in enumerate(words)}


def requests(mc, n: int, seed: int):
    """Serving requests: transcripts of 40-400 words, uint8 frames of
    av_max_length/5 to av_max_length steps (20-101) at frame_size, int16 PCM
    of 8-32 s."""
    rng = np.random.RandomState(seed)
    contexts = [" ".join(f"w{w}" for w in rng.randint(3, mc.n_vocab,
                                                       rng.randint(40, 400)))
                for _ in range(n)]
    fs = mc.frame_size
    frames = [rng.randint(0, 256, (rng.randint(max(1, mc.av_max_length // 5),
                                               mc.av_max_length + 1),
                                   fs, fs, 3), np.uint8) for _ in range(n)]
    audio = [(rng.randn(rng.randint(8 * mc.sample_rate,
                                    32 * mc.sample_rate + 1)) * 3000
              ).astype(np.int16) for _ in range(n)]
    return contexts, frames, audio


def serving_mel(mc, pcm, audio_cap: int, dtype):
    """The log-mel examples encode computes from ``pcm``: (B, cap, 96, 64)."""
    return frontends.log_mel_examples(
        pcm, sample_rate=mc.sample_rate, window=mc.stft_window,
        hop=mc.stft_hop, mel_bins=mc.mel_bins, lower_hz=mc.mel_min_hz,
        upper_hz=mc.mel_max_hz, log_offset=mc.log_offset,
        frames_per_example=mc.mel_frames, max_examples=audio_cap, dtype=dtype)


def _encode_decode(pipe, req, int8_audio: bool = False):
    """(memories, tokens, logits) of one request batch, through the same
    functions generate() runs. ``int8_audio`` replaces the audio memory
    with the int8 tower's, called through AudioEncoder.forward(int8=True)
    on the pipeline's device (on the CPU too, where encode never takes
    it)."""
    host = pipe._pack(*req)
    batch = pipe._to_device(host)
    cap = DEC.audio_bucket(pipe.mc, host["audio_len"])
    mem, state = DEC.encode(pipe.model, pipe.mc, batch, audio_cap=cap,
                            frames_cap=DEC.frames_bucket(pipe.mc,
                                                         host["frames_len"]),
                            dtype=pipe.dtype)
    if int8_audio:
        mel = serving_mel(pipe.mc, batch["audio_pcm"], cap, pipe.dtype)
        enc = pipe.model.audio_enc(mel, mem.audio_len, dtype=pipe.dtype,
                                   int8=True)
        mem = mem._replace(enc_audio=torch.nn.functional.pad(
            enc, (0, 0, 0, pipe.mc.av_max_length - cap)))
    toks, logits = DEC.decode_from_memories(
        pipe.model, mem, state, max_len=pipe.mc.target_steps - 1,
        dtype=pipe.dtype, return_logits=True)
    return mem, toks, logits


def _time_serving(pipe, req):
    """(questions/s of one generate(), median encode ms, median decode ms,
    caps) of the request batch, each call ending in a synchronise."""
    mc = pipe.mc
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.generate(*req, strategy="greedy")
    wall = time.perf_counter() - t0
    enc_ms, dec_ms = [], []
    for _ in range(3):
        host = pipe._pack(*req)
        batch = pipe._to_device(host)
        caps = dict(audio_cap=DEC.audio_bucket(mc, host["audio_len"]),
                    frames_cap=DEC.frames_bucket(mc, host["frames_len"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mem, st = DEC.encode(pipe.model, mc, batch, dtype=pipe.dtype, **caps)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        DEC.decode_from_memories(pipe.model, mem, st,
                                 max_len=mc.target_steps - 1,
                                 dtype=pipe.dtype)
        torch.cuda.synchronize()
        enc_ms.append((t1 - t0) * 1e3)
        dec_ms.append((time.perf_counter() - t1) * 1e3)
    return (len(req[0]) / wall, wall * 1e3, float(np.median(enc_ms)),
            float(np.median(dec_ms)), caps)


def phase_main(card: str, model) -> dict:
    mc, params, state, vocab, i2w = model
    t0 = time.perf_counter()
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cuda",
                      dtype=torch.bfloat16)
    req = requests(mc, N_REQUESTS, SEED + 2)
    log(f"main: QGPipeline mode={mc.mode} decoder={mc.decoder} "
        f"video={mc.video_encoder} hidden={mc.hidden_dim} Lc="
        f"{mc.context_max_length} av={mc.av_max_length} vocab={mc.n_vocab} "
        f"bf16 on the card, built in {time.perf_counter() - t0:.1f} s; audio "
        f"tower: int8 VGGish (audio_int8_serving={mc.audio_int8_serving}, "
        "conv2..conv6 through vggish_conv_int8), as the JAX package serves "
        "off the CPU")
    pipe.generate(*req)                      # warm-up: cuDNN plans, caches
    torch.cuda.synchronize()

    _reset_launches()
    questions = pipe.generate(*req, strategy="greedy")
    torch.cuda.synchronize()
    launches = _launches()
    want = dict(ZERO_LAUNCHES, lstm_seq=mc.text_layers + 1,
                trimodal_attention=mc.target_steps - 1,
                vggish_conv_int8=len(V.POOLS), quantize_s8=len(V.POOLS))
    log(f"main: one generate() of {N_REQUESTS} requests launched {launches}"
        f" (want {want}: {mc.text_layers} text layers + 1 video layer, "
        f"{len(V.POOLS)} int8 convs and {len(V.POOLS)} activation quantizes"
        f" (dynamic scales) per encode, {mc.target_steps - 1} attention "
        "steps per decode)")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    check_routes("main: K1", lstm_seq.routes, want["lstm_seq"])
    check_only_route("main: K2", trimodal_attention.routes, "tiled",
                     want["trimodal_attention"])
    check_only_route("main: int8 conv", V.conv3x3_relu_int8.routes, "wgmma",
                     want["vggish_conv_int8"])
    if len(questions) != N_REQUESTS or not all(
            isinstance(q, str) for q in questions):
        raise AssertionError("generate() did not return one string a request")

    # the int8 tower (the default) and the bf16 cuDNN tower, in turns
    towers = {"int8": mc, "bf16": mc._replace(audio_int8_serving=False)}
    pipe.mc = towers["bf16"]
    pipe.generate(*req)                      # warm-up of the bf16 tower
    runs = {"int8": [], "bf16": []}
    for tower in ("int8", "bf16", "bf16", "int8"):
        pipe.mc = towers[tower]
        runs[tower].append(_time_serving(pipe, req))
    pipe.mc = mc
    for tower, rs in runs.items():
        caps = rs[0][4]
        log(f"main: greedy batch {N_REQUESTS}, {tower} VGGish: "
            + ", ".join(f"{r[0]:.1f}" for r in rs) + " questions/s ("
            + ", ".join(f"{r[1]:.1f}" for r in rs) + " ms generate(), host "
            "packing included); encode " + ", ".join(f"{r[2]:.2f}" for r in rs)
            + " ms, decode " + ", ".join(f"{r[3]:.2f}" for r in rs)
            + f" ms (medians of 3; runs in the order int8, bf16, bf16, int8;"
            f" caps audio={caps['audio_cap']} frames={caps['frames_cap']}) "
            f"[{card}]")

    # one decode under torch.profiler: wall, device busy, idle share, and
    # K2's share of the device time
    host = pipe._pack(*req)
    mem, st = DEC.encode(pipe.model, mc, pipe._to_device(host),
                         audio_cap=DEC.audio_bucket(mc, host["audio_len"]),
                         frames_cap=DEC.frames_bucket(mc, host["frames_len"]),
                         dtype=pipe.dtype)
    wall, busy, prof = _device_busy_ms(lambda: DEC.decode_from_memories(
        pipe.model, mem, st, max_len=mc.target_steps - 1, dtype=pipe.dtype))
    k2 = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and "attn_tile_kernel" in e.name]
    log(f"main: one greedy decode ({mc.target_steps - 1} steps) under "
        f"torch.profiler: wall {wall:.2f} ms, device busy "
        + ("not measured" if busy is None else
           f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}")
        + f"; K2 {sum(k2) / 1e3:.3f} ms of device time in {len(k2)} launches"
        f" [{card}]")

    mem, toks, logits = _encode_decode(pipe, req)
    finite = all(bool(torch.isfinite(m).all()) for m in mem[:3])
    if not (finite and bool(torch.isfinite(logits).all())):
        raise AssertionError("non-finite memories or logits")
    if tuple(logits.shape) != (N_REQUESTS, mc.target_steps - 1, mc.n_vocab):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    log(f"main: e.g. {questions[0][:80]!r}")
    return launches


def phase_card_vs_cpu(model) -> None:
    """The same f32 pipeline on 4 requests on the card (kernels) and on the
    CPU (plain versions), with the float audio tower on both: identical
    greedy tokens, logits within LOGIT_TOL. Then the int8 tower on both,
    called through AudioEncoder.forward(int8=True): identical greedy tokens,
    logits within INT8_LOGIT_TOL."""
    mc, params, state, vocab, i2w = model
    mc = mc._replace(audio_int8_serving=False)
    req = tuple(r[:4] for r in requests(mc, N_REQUESTS, SEED + 2))
    pipes = {d: QGPipeline(None, mc, params, state, vocab, i2w, device=d,
                           dtype=torch.float32) for d in ("cuda", "cpu")}
    failed = []
    for tower, tol in (("float", LOGIT_TOL), ("int8", INT8_LOGIT_TOL)):
        out = {}
        for device, pipe in pipes.items():
            mem, toks, logits = _encode_decode(pipe, req,
                                               int8_audio=tower == "int8")
            out[device] = (toks.cpu(), logits.cpu(), mem.enc_audio.cpu())
        same = torch.equal(out["cuda"][0], out["cpu"][0])
        err = max_abs(out["cuda"][1], out["cpu"][1])
        audio = max_abs(out["cuda"][2], out["cpu"][2])
        log(f"card vs cpu (f32, {tower} VGGish, 4 requests, "
            f"{mc.target_steps - 1} steps): greedy tokens identical={same}; "
            f"logits max|d|={err:.3e} (tol {tol:.0e}); audio memory "
            f"max|d|={audio:.3e} of max {float(out['cpu'][2].abs().max()):.3e}")
        if not same or not err <= tol:
            failed.append(tower)
    if failed:
        raise AssertionError(f"card and CPU disagree: {failed}")


# f32 logits, card vs CPU: the parity contract's 1e-5. cuBLAS/cuDNN and the
# CPU libraries sum in other orders through the VGGish stack and 283 + 21
# recurrent steps; measured 4.8e-7 on an H100 (700 W).
LOGIT_TOL = 1e-5
# f32 logits, card vs CPU, int8 tower: conv1 runs through cuDNN and the CPU
# conv, which differ in the last bit, so an example's dynamic scale (and
# any quantized activation whose quotient sits near a half) can move by one
# quantization step between the two; the kernel and the plain int8 conv are
# otherwise bit-equal (phase int8).
INT8_LOGIT_TOL = 1e-3


# ----------------------------------------------------------------- K4 phase

# max |kernel - plain| of the forward outputs (h and c sequences, hT, cT),
# as K1: f32 differs only in summation order; bf16 rounds h before every
# Wh product, so an order-induced rounding flip moves h by a bf16 ulp and
# the recurrence carries it.
K4_FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
# max |kernel - plain| / max |plain| of each gradient (dx, dWx, dWh, db,
# dh0, dc0). f32: summation order over up to B*T = 9056 rows. bf16: da is
# rounded to bf16 before every product, so a flip of that rounding moves
# dh by a bf16 ulp of da . Wh^T and the reverse sweep carries it.
K4_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
K4_NAMES = ("dwx", "dwh", "db", "dx", "dh0", "dc0")


def _k4_case(rng, B, T, In, H, dtype, dev):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    wx = t(rng.randn(In, 4 * H) / np.sqrt(In))
    wh = t(rng.randn(H, 4 * H) / np.sqrt(H))
    b = t(rng.randn(4 * H) * 0.1)
    xs = t(rng.randn(B, T, In))
    h0, c0 = t(rng.randn(B, H) * 0.5), t(rng.randn(B, H) * 0.5)
    cots = [t(rng.randn(B, T, H)), t(rng.randn(B, T, H)),
            t(rng.randn(B, H)), t(rng.randn(B, H))]
    leaves = [x.clone().requires_grad_(True) for x in (wx, wh, b, xs, h0, c0)]

    def kernel():
        for x in leaves:
            x.grad = None
        outs = lstm_layer_train(*leaves, dtype)
        torch.autograd.backward(outs, cots)
        return outs, [leaves[i].grad for i in (0, 1, 2, 3, 4, 5)]

    def plain():
        out, cseq, gates, hT, cT = lstm_train_fwd_plain(wx, wh, b, xs, h0,
                                                        c0, dtype)
        grads = lstm_train_bwd_plain(wx, wh, xs, h0, c0, out, cseq, gates,
                                     *cots, dtype)
        return (out, cseq, hT, cT), grads

    with torch.no_grad():
        ref_outs, ref_grads = plain()
    outs, grads = kernel()
    torch.cuda.synchronize()
    fwd_err = max(max_abs(g, r) for g, r in zip(outs, ref_outs))
    ref = dict(zip(K4_NAMES, ref_grads))
    # the Function's gradients come in its input order: wx, wh, b, xs, h0, c0
    got = dict(zip(("dwx", "dwh", "db", "dx", "dh0", "dc0"), grads))
    grad_abs = max(max_abs(got[k], ref[k]) for k in K4_NAMES)
    grad_rel = {k: max_abs(got[k], ref[k]) / float(ref[k].abs().max())
                for k in K4_NAMES}

    def kernel_fwd(force_route=None):
        with torch.no_grad():
            return lstm_layer_train(wx, wh, b, xs, h0, c0, dtype,
                                    force_route=force_route)

    with torch.no_grad():
        res = lstm_train_fwd_plain(wx, wh, b, xs, h0, c0, dtype)
        times = {
            "fwd": cuda_ms(kernel_fwd, iters=5, warmup=1),
            "plain_fwd": cuda_ms(lambda: lstm_train_fwd_plain(
                wx, wh, b, xs, h0, c0, dtype), iters=1, warmup=1),
            "plain_bwd": cuda_ms(lambda: lstm_train_bwd_plain(
                wx, wh, xs, h0, c0, res[0], res[1], res[2], *cots, dtype),
                iters=1, warmup=1)}
    # the backward alone: forward + backward less the forward
    times["bwd"] = cuda_ms(kernel, iters=3, warmup=1) - times["fwd"]
    # forward: K1's products, writing h, c and the gates; backward: the dh
    # recurrence and dx, dWx, dWh over all B*T rows
    gates = res[2]
    lens = torch.full((B,), T, dtype=torch.int64)
    bnds = {"fwd": bound(2 * B * T * (In + H) * 4 * H,
                         nbytes(wx, wh, b, xs, h0, c0, *res), dtype),
            "bwd": bound(4 * B * T * (In + H) * 4 * H,
                         nbytes(wx, wh, xs, h0, c0, res[0], res[1], gates,
                                *cots, *ref_grads), dtype)}
    lib = cudnn_lstm_ms(wx, wh, b, xs, lens, dtype)
    return fwd_err, grad_abs, grad_rel, times, bnds, lib, kernel_fwd


def phase_k4(card: str) -> dict:
    rng = np.random.RandomState(SEED + 3)
    dev = torch.device("cuda")
    summary, failures = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, T, In, H in LSTM_SHAPES + (LSTM_EDGE,):
            before = (dict(lstm_layer_train.fwd_routes),
                      dict(lstm_layer_train.bwd_routes))
            fwd_err, grad_abs, grad_rel, ms, bnds, lib, fwd = _k4_case(
                rng, B, T, In, H, dtype, dev)
            routes = (routes_taken(lstm_layer_train.fwd_routes, before[0]),
                      routes_taken(lstm_layer_train.bwd_routes, before[1]))
            worst = max(grad_rel.values())
            log(f"K4 lstm_layer_train {name} B={B} T={T} In={In} H={H} "
                f"{str(dtype)[6:]}: fwd max|d|={fwd_err:.3e} (tol "
                f"{K4_FWD_TOL[dtype]:.0e}); grads max|d|={grad_abs:.3e}, "
                f"max|d|/max|plain| "
                + " ".join(f"{k}={v:.2e}" for k, v in grad_rel.items())
                + f" (tol {K4_GRAD_TOL[dtype]:.0e}); routes forward "
                f"{routes[0]} backward {routes[1]}; kernel fwd "
                f"{ms['fwd']:.2f} ms bwd {ms['bwd']:.2f} ms, plain fwd "
                f"{ms['plain_fwd']:.2f} ms bwd {ms['plain_bwd']:.2f} ms, "
                f"cuDNN LSTM fwd {fmt_ms(lib['fwd'])} bwd "
                f"{fmt_ms(lib['bwd'])}, bound fwd "
                f"{bnds['fwd']['bound_ms']:.4f} ms ({bnds['fwd']['bound_by']})"
                f" bwd {bnds['bwd']['bound_ms']:.4f} ms "
                f"({bnds['bwd']['bound_by']}) [{card}]")
            if not (fwd_err <= K4_FWD_TOL[dtype]
                    and worst <= K4_GRAD_TOL[dtype]):
                failures.append(f"{name} {dtype}")
            if routes != ("persistent", "persistent"):
                failures.append(f"{name} {dtype}: routes {routes}")
            if dtype == torch.bfloat16 and name == "text layer 0":
                turns = in_turns({r: lambda r=r: fwd(r)
                                  for r in ("persistent", "per_step")})
                log(f"K4 forward text layer 0 bf16, both routes in turns: "
                    f"{fmt_turns(turns)}; cuDNN LSTM fwd {fmt_ms(lib['fwd'])}"
                    f" [{card}]")
                summary = {"fwd": {"max_abs_err": fwd_err, "ms": ms["fwd"],
                                   "plain_ms": ms["plain_fwd"], **bnds["fwd"],
                                   "library_ms": lib["fwd"],
                                   "per_step_ms": min(turns["per_step"])},
                           "bwd": {"max_abs_err": grad_abs, "ms": ms["bwd"],
                                   "plain_ms": ms["plain_bwd"], **bnds["bwd"],
                                   "library_ms": lib["bwd"]}}
    log(f"K4 routes over the phase: forward {lstm_layer_train.fwd_routes}, "
        f"backward {lstm_layer_train.bwd_routes}")
    if failures:
        raise AssertionError(f"K4 kernel and plain disagree: {failures}")
    return summary


# -------------------------------------------------------------- train phase

@dataclass
class SyntheticBatch:
    """The fields of ``mmqg_tpu_torch.data.dataset.Batch`` that training
    reads."""
    context_ids: np.ndarray
    context_len: np.ndarray
    frames: np.ndarray
    frames_len: np.ndarray
    audio_pcm: np.ndarray
    audio_len: np.ndarray
    target_ids: np.ndarray
    target_len: np.ndarray
    valid: np.ndarray
    questions: List[str]

    @property
    def size(self) -> int:
        return int(self.valid.sum())


def tones(rng, n: int, sr: int) -> np.ndarray:
    """int16 PCM of ``n`` samples at ``sr``: a tone whose pitch (100-4000
    Hz) and loudness change every second, over quiet noise. Unlike noise
    alone, its VGGish examples differ from each other, so the audio
    attention's scores get gradients well above f32 noise."""
    sec = np.arange(n) // sr
    k = int(sec[-1]) + 1
    freq = rng.uniform(100.0, 4000.0, k)[sec]
    amp = rng.uniform(1000.0, 12000.0, k)[sec]
    x = (amp * np.sin(2 * np.pi * freq * np.arange(n) / sr)
         + rng.standard_normal(n) * 300)
    return np.clip(x, -32768, 32767).astype(np.int16)


class SyntheticCorpus:
    """An in-memory stand-in for ``QGDataset``: ``n_batches`` batches of
    lecture spans at the flagship's shapes -- transcripts of 40-283 words,
    20-101 uint8 frames at frame_size, 8-32 s of int16 audio (``tones``),
    questions of 4-20 words + <end> -- made from ``seed``. Batch i is the same on every
    pass (``shuffle`` is ignored) and is made once, on first use, so a
    timed epoch does not include making it."""

    def __init__(self, mc, index_to_word, n_batches: int, batch_size: int,
                 seed: int, max_audio_s: int = 32):
        self.mc, self.index_to_word = mc, index_to_word
        self.n_batches, self.batch_size, self.seed = n_batches, batch_size, seed
        self.max_audio_s = max_audio_s
        self._made = {}

    def batches(self, batch_size: int, shuffle: bool = False, rng=None):
        if batch_size != self.batch_size:
            raise ValueError(f"batch size {batch_size}: the corpus holds "
                             f"batches of {self.batch_size}")
        for i in range(self.n_batches):
            yield self.batch(i)

    def batch(self, i: int) -> SyntheticBatch:
        if i not in self._made:
            self._made[i] = self._make(i)
        return self._made[i]

    def _make(self, i: int) -> SyntheticBatch:
        mc, B = self.mc, self.batch_size
        rng = np.random.default_rng(self.seed * 1000 + i)
        Lc, av, fs, sr = (mc.context_max_length, mc.av_max_length,
                          mc.frame_size, mc.sample_rate)
        ctx_len = rng.integers(min(40, Lc), Lc + 1, B).astype(np.int32)
        ctx = np.zeros((B, Lc), np.int32)
        f_len = rng.integers(max(1, av // 5), av + 1, B).astype(np.int32)
        frames = np.zeros((B, int(f_len.max()), fs, fs, 3), np.uint8)
        a_len = rng.integers(8 * sr, self.max_audio_s * sr + 1,
                             B).astype(np.int32)
        pcm = np.zeros((B, int(a_len.max())), np.int16)
        T = mc.target_steps
        tgt_len = rng.integers(min(5, T), T + 1, B).astype(np.int32)
        tgt = np.zeros((B, T), np.int32)
        questions = []
        for r in range(B):
            ctx[r, :ctx_len[r]] = rng.integers(3, mc.n_vocab, ctx_len[r])
            frames[r, :f_len[r]] = rng.integers(0, 256, frames.shape[1:],
                                                np.uint8)[:f_len[r]]
            pcm[r, :a_len[r]] = tones(rng, a_len[r], sr)
            words = rng.integers(3, mc.n_vocab, tgt_len[r] - 1)
            tgt[r, :tgt_len[r] - 1] = words
            tgt[r, tgt_len[r] - 1] = END_ID
            questions.append(" ".join(self.index_to_word[str(w)]
                                      for w in words))
        return SyntheticBatch(ctx, ctx_len, frames, f_len, pcm, a_len, tgt,
                              tgt_len, np.ones(B, bool), questions)


TRAIN_BATCHES = 4     # optimizer steps of the measured epoch (>= 3)
# K4's kernels in bf16 training by direction, as the profiler names them:
# the input projection is tc_gemm_kernel<true, false>, the gradient GEMMs
# the other two operand layouts
K4_PROFILE_KERNELS = {
    "forward": ("::fwd_sweep_kernel<", "::fwd_step_kernel<",
                "::tc_gemm_kernel<true, false>"),
    "backward": ("::bwd_sweep_kernel<", "::bwd_step_kernel<",
                 "::tc_gemm_kernel<true, true>",
                 "::tc_gemm_kernel<false, false>", "::colsum_kernel(")}
# one train step of this phase with K4's forward as first written (one
# launch a step, SIMT input GEMM) and the persistent backward, three runs on
# an NVIDIA H100 80GB HBM3 at 700 W: printed beside this run's numbers
EARLIER_TRAIN_STEP = ("one step 251.9-255.7 ms (median of 3), device busy "
                      "175.8-177.2 ms, idle share 0.567-0.609 [NVIDIA H100 "
                      "80GB HBM3, 700.00 W]")


ZERO_LAUNCHES = {"lstm_seq": 0, "trimodal_attention": 0,
                 "lstm_train_fwd": 0, "lstm_train_bwd": 0, "vggish_conv": 0,
                 "vggish_conv_int8": 0, "quantize_s8": 0}


def _launches():
    return {"lstm_seq": lstm_seq.launches,
            "trimodal_attention": trimodal_attention.launches,
            "lstm_train_fwd": lstm_layer_train.fwd_launches,
            "lstm_train_bwd": lstm_layer_train.bwd_launches,
            "vggish_conv": V.vggish_conv.launches,
            "vggish_conv_int8": V.conv3x3_relu_int8.launches,
            "quantize_s8": V.quantize_s8.launches}


def _reset_launches() -> None:
    lstm_seq.launches = trimodal_attention.launches = 0
    lstm_layer_train.fwd_launches = lstm_layer_train.bwd_launches = 0
    for counts in (lstm_seq.routes, lstm_layer_train.fwd_routes,
                   lstm_layer_train.bwd_routes, trimodal_attention.routes,
                   V.conv3x3_relu_int8.routes):
        counts.update(dict.fromkeys(counts, 0))
    V.vggish_conv.launches = V.conv3x3_relu_int8.launches = 0
    V.quantize_s8.launches = 0


def check_only_route(what: str, routes: dict, route: str,
                     launches: int) -> None:
    """Print a route counter; all ``launches`` must have taken ``route``."""
    want = {r: launches if r == route else 0 for r in routes}
    log(f"{what} routes {routes} (want {want})")
    if routes != want:
        raise AssertionError(f"{what} routes {routes}")


def check_routes(what: str, routes: dict, launches: int) -> None:
    """Print a route counter; every one of ``launches`` must be persistent."""
    log(f"{what} routes {routes} (want {{'persistent': {launches}, "
        f"'per_step': 0}})")
    if routes != {"persistent": launches, "per_step": 0}:
        raise AssertionError(f"{what} routes {routes}")


def _device_busy_ms(fn):
    """(wall ms, device-busy ms or None) of ``fn()`` under torch.profiler:
    the union of the CUDA kernel and copy intervals. None when the
    profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return wall, None, prof
    busy, (s0, e0) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > e0:
            busy += e0 - s0
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    busy += e0 - s0
    return wall, busy / 1e3, prof


def train_config(batch_size: int, **kw):
    """The config fields the Trainer and make_optimizer read, with the JAX
    package's Config defaults (Adam at lr 1e-4, no schedule or clip)."""
    base = dict(lr=1e-4, optim="adam", grad_clip_norm=0.0, seed=SEED,
                batch_size=batch_size, eval_batch_size=batch_size,
                grad_accum_steps=1, train_av_bucketing=True,
                train_av_bucket_granularity=8)
    base.update(kw)
    return SimpleNamespace(**base)


def phase_train(card: str, model) -> dict:
    mc, params, state, vocab, i2w = model
    B = 32
    t0 = time.perf_counter()
    train_ds = SyntheticCorpus(mc, i2w, TRAIN_BATCHES, B, SEED + 4)
    val_ds = SyntheticCorpus(mc, i2w, 1, B, SEED + 5)
    trainer = Trainer(train_config(B), mc, params["embedding"]["table"],
                      train_ds, val_ds, device="cuda", log_fn=log)
    log(f"train: Trainer mode={mc.mode} hidden={mc.hidden_dim} vocab="
        f"{mc.n_vocab} bf16 batch {B} on the card, Adam lr 1e-4, built in "
        f"{time.perf_counter() - t0:.1f} s")
    trainer.run_epoch(0)                     # warm-up: cuDNN plans, caches
    torch.cuda.synchronize()

    _reset_launches()
    t0 = time.perf_counter()
    loss = trainer.run_epoch(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = _launches()
    steps = TRAIN_BATCHES
    want = dict(ZERO_LAUNCHES,
                lstm_train_fwd=(mc.text_layers + 1) * steps,
                lstm_train_bwd=(mc.text_layers + 1) * steps)
    log(f"train: run_epoch of {steps} steps launched {launches} (want "
        f"{want}: {mc.text_layers} text layers + 1 video layer, forward and "
        f"backward, per step); mean loss {loss:.4f}; {epoch_s * 1e3:.1f} ms "
        f"({steps * B / epoch_s:.1f} samples/s; the batches were made in the "
        f"warm-up epoch, their host-to-device copies are included) [{card}]")
    if launches != want:
        raise AssertionError(f"train launches {launches} != {want}")
    check_routes("train: K4 forward", lstm_layer_train.fwd_routes,
                 want["lstm_train_fwd"])
    check_routes("train: K4 backward", lstm_layer_train.bwd_routes,
                 want["lstm_train_bwd"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite training loss {loss}")

    # one step alone: the step and AV caps Trainer.run_epoch uses, on a
    # batch already on the card
    host = batch_arrays(train_ds.batch(0))
    caps = trainer.caps_for(host)
    batch = to_device(host, "cuda")
    ts = trainer.train_state

    def one_step():
        return trainer.train_step(ts, batch, trainer.generator, **caps)[1]

    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = one_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    norm = float(metrics["grad_norm"])
    if not (np.isfinite(norm) and np.isfinite(float(metrics["loss"]))):
        raise AssertionError(f"non-finite step metrics {metrics}")
    # the step's parts, each ending in a synchronise: forward (loss_fn,
    # building the graph), forward + backward, and the optimizer update
    # from the gradients that leaves (its new state is dropped)
    params = qg_model.param_tree(ts.model)

    def forward():
        return qg_model.loss_fn(ts.model, mc, batch,
                                generator=trainer.generator,
                                dtype=torch.bfloat16, **caps)[0]

    def forward_backward():
        for p in tree_leaves(params):
            p.grad = None
        forward().backward()

    def optimizer():
        updates, _ = trainer.optimizer.update(
            tree_map(lambda p: p.grad, params), ts.opt_state, params)
        apply_updates(params, updates)

    parts = {}
    for part, fn in (("forward", forward), ("forward+backward",
                                            forward_backward),
                     ("optimizer", optimizer)):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        parts[part] = float(np.median(times))
    for p in tree_leaves(params):
        p.grad = None
    log(f"train: step parts (median of 3 each): forward {parts['forward']:.1f}"
        f" ms, backward {parts['forward+backward'] - parts['forward']:.1f} "
        f"ms, optimizer {parts['optimizer']:.1f} ms [{card}]")
    wall, busy, prof = _device_busy_ms(one_step)
    idle = "not measured" if busy is None else f"{1 - busy / wall:.3f}"
    step = float(np.median(step_ms))
    log(f"train: one step {step:.1f} ms (median of 3, batch on the card; "
        f"{B / step * 1e3:.1f} samples/s), loss {float(metrics['loss']):.4f}"
        f", grad norm {norm:.4f}; profiled step wall {wall:.1f} ms, device "
        f"busy {'not measured' if busy is None else f'{busy:.1f} ms'}, "
        f"idle share {idle} [{card}]")
    log(f"train: the earlier design (one launch a step of K4's forward, "
        f"SIMT input GEMM) read {EARLIER_TRAIN_STEP}")
    if busy is not None:
        averages = prof.key_averages()
        top = averages.table(sort_by="self_device_time_total", row_limit=12)
        for line in top.splitlines():
            log(f"  {line}")
        k4 = {part: [e for e in averages
                     if any(k in e.key for k in kernels)]
              for part, kernels in K4_PROFILE_KERNELS.items()}
        ms = {part: sum(e.self_device_time_total for e in es) / 1e3
              for part, es in k4.items()}
        log(f"train: K4 kernels in the profiled step: forward "
            f"{ms['forward']:.1f} ms, backward {ms['backward']:.1f} ms of "
            f"{busy:.1f} ms device busy [{card}]")
        for part, es in k4.items():
            log(f"  K4 {part}: " + "; ".join(
                re.search(r"\w+_kernel(<(true|false), (true|false)>)?",
                          e.key).group(0)
                + f" x{e.count} {e.self_device_time_total / 1e3:.2f} ms"
                for e in es))

    _reset_launches()
    t0 = time.perf_counter()
    val = trainer.validate()
    torch.cuda.synchronize()
    val_launches = _launches()
    # validation encodes as serving does: the int8 VGGish on the card
    val_want = dict(ZERO_LAUNCHES, lstm_seq=mc.text_layers + 1,
                    trimodal_attention=mc.target_steps,
                    vggish_conv_int8=len(V.POOLS), quantize_s8=len(V.POOLS))
    log(f"train: validate() of {B} samples launched {val_launches} (want "
        f"{val_want}), loss {val['loss']:.4f} bleu {val['bleu']:.4f}, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms [{card}]")
    if val_launches != val_want or not np.isfinite(val["loss"]):
        raise AssertionError(f"validate launches {val_launches} != "
                             f"{val_want} or non-finite loss")
    check_routes("train: validate() K1", lstm_seq.routes,
                 val_want["lstm_seq"])
    return launches


# f32 train step, card vs CPU (SGD, so the update is linear in the
# gradient): the loss within 1e-5 relative; the updated parameters within
# SGD_LR times the gradient band of the largest leaf; every gradient leaf
# within 1e-4 of its max |CPU| (a leaf whose CPU gradient is exactly zero
# must be zero on the card too), except the leaves of the two ReLU conv
# towers (CONV_TOWERS), which are held to 5e-2: across two f32
# implementations their gradients mean no more. A rounding difference at a
# ReLU kink of the VGGish fc layers moves a leaf by one audio example's
# share (1/32 here; one flipped gate read 2.9e-2 on an H100), and the video
# convs' weight gradients are sums over ~10^6 positions that cancel
# against batchnorm's zero-mean cotangent, so the CPU alone moves them by
# up to 3.7e-3 between 1 and 8 threads. The phase prints both witnesses:
# the flipped fc gates, and the CPU's own spread over thread counts.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TOWER_GRAD_RTOL = 1e-5, 1e-4, 5e-2
CONV_TOWERS = ("/audio_enc/", "/video_enc/convs/", "/video_enc/bns/")
SGD_LR = 1e-2


def _train_step_on(device, model_np, mc, host, caps):
    """(loss, gradients, SGD-updated parameters, the VGGish fc layers'
    ReLU gates) of one f32 train step on ``device``, on the CPU."""
    params, state = model_np
    model = params_from_numpy(params, state, device, trainable=True)
    opt = make_optimizer(train_config(4, optim="sgd", lr=SGD_LR))
    tree = qg_model.param_tree(model)
    opt_state = opt.init(tree)
    gates = {}
    hooks = [getattr(model.audio_enc, k).register_forward_hook(
        lambda mod, inp, out, k=k: gates.__setitem__(k, (out > 0).cpu()))
        for k in ("fc1", "fc2", "fc3")]
    obj, _ = qg_model.loss_fn(model, mc, to_device(host, device),
                              dtype=torch.float32, **caps)
    for h in hooks:
        h.remove()
    obj.backward()
    grads = tree_map(lambda p: p.grad, tree)
    grads_cpu = tree_map(lambda g: g.detach().cpu(), grads)
    updates, _ = opt.update(grads, opt_state, tree)
    apply_updates(tree, updates)
    return (float(obj.detach()), grads_cpu,
            tree_map(lambda p: p.detach().cpu(), tree), gates)


def _grad_rel(got, ref, names):
    """{leaf: (max |d| / max |ref|, max |ref|)}; a zero leaf of ``ref``
    reads 0 if ``got`` is zero there too, else inf."""
    rel = {}
    for name, a, b in zip(names, tree_leaves(got), tree_leaves(ref)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        rel[name] = (err / scale if scale > 0 else
                     (0.0 if err == 0 else float("inf")), scale)
    return rel


def _in_tower(name: str) -> bool:
    return name.startswith(CONV_TOWERS)


def compare_train_steps(got, ref, names):
    """(report lines, failed) for two ``_train_step_on`` results: ``got``
    held to ``ref`` within the TRAIN_* and TOWER_* tolerances."""
    (l_got, g_got, p_got, z_got), (l_ref, g_ref, p_ref, z_ref) = got, ref
    loss_rel = abs(l_got - l_ref) / abs(l_ref)
    rel = _grad_rel(g_got, g_ref, names)
    bad = [n for n, (r, _) in rel.items()
           if r > (TOWER_GRAD_RTOL if _in_tower(n) else TRAIN_GRAD_RTOL)]
    smooth = [n for n in names if not _in_tower(n)]
    tower = [n for n in names if _in_tower(n)]
    worst = max(smooth, key=lambda n: rel[n][0])
    worst_tower = max(tower, key=lambda n: rel[n][0])
    max_grad = max(scale for _, scale in rel.values())
    param_atol = SGD_LR * TRAIN_GRAD_RTOL * max_grad
    worst_param = max(float((a - b).abs().max())
                      for a, b in zip(tree_leaves(p_got), tree_leaves(p_ref)))
    audio = [n for n in names if n.startswith("/decoder/attn/")
             and "audio" in n]
    flips = {k: int((z_got[k] != z_ref[k]).sum()) for k in sorted(z_ref)}
    lines = [
        f"loss {l_got:.6f} vs {l_ref:.6f} rel {loss_rel:.2e} (tol "
        f"{TRAIN_LOSS_RTOL:.0e}); worst gradient leaf {worst} "
        f"{rel[worst][0]:.2e} of its max (tol {TRAIN_GRAD_RTOL:.0e}, every "
        f"leaf outside the conv towers); conv towers' worst {worst_tower} "
        f"{rel[worst_tower][0]:.2e} (tol {TOWER_GRAD_RTOL:.0e}); params "
        f"max|d| {worst_param:.2e} (tol {param_atol:.1e})",
        "audio attention leaves: " + ", ".join(
            f"{n} {rel[n][0]:.2e} of its max {rel[n][1]:.2e}" for n in audio),
        "VGGish fc ReLU gates that differ: " + ", ".join(
            f"{k} {v} of {z_ref[k].numel()}" for k, v in flips.items())]
    if bad:
        lines.append("gradient leaves out of tolerance: " + ", ".join(bad))
    failed = bool(loss_rel > TRAIN_LOSS_RTOL or bad
                  or worst_param > param_atol)
    return lines, failed


def he_vggish(params):
    """``params`` with the VGGish conv weights scaled by sqrt(6), from the
    torch-default uniform init (variance 1 / (3 fan_in)) to He's 2 / fan_in.
    With the default init six ReLU convs shrink the signal ~6^6-fold, the fc
    biases swamp it and every audio example embeds alike, so the audio
    attention's gradients sit at f32 noise (~1e-8) and check nothing."""
    audio = dict(params["audio_enc"], convs=[
        {"w": (c["w"] * np.sqrt(6.0)).astype(np.float32), "b": c["b"]}
        for c in params["audio_enc"]["convs"]])
    return dict(params, audio_enc=audio)


def phase_train_card_vs_cpu(model) -> None:
    mc, params, state, vocab, i2w = model
    params = he_vggish(params)
    corpus = SyntheticCorpus(mc, i2w, 1, 4, SEED + 6, max_audio_s=8)
    host = batch_arrays(corpus.batch(0))
    host["context_len"] = np.minimum(host["context_len"], 48)
    caps = dict(audio_cap=DEC.audio_bucket(mc, host["audio_len"]),
                frames_cap=DEC.frames_bucket(mc, host["frames_len"]))
    out = {d: _train_step_on(d, (params, state), mc, host, caps)
           for d in ("cuda", "cpu")}
    names = list(_leaf_names(qg_model.param_tree(params_from_numpy(
        params, state))))
    lines, failed = compare_train_steps(out["cuda"], out["cpu"], names)
    log(f"train card vs cpu (f32, 4 samples, one SGD step lr {SGD_LR}): "
        + lines[0])
    for line in lines[1:]:
        log(f"  {line}")
    # the towers' witness: the same CPU step with one thread, whose sums
    # run in other orders
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        alone = _train_step_on("cpu", (params, state), mc, host, caps)
    finally:
        torch.set_num_threads(threads)
    rel = _grad_rel(alone[1], out["cpu"][1], names)
    spread = max((n for n in names if _in_tower(n)), key=lambda n: rel[n][0])
    log(f"  cpu 1 thread vs {threads} threads: conv towers' worst {spread} "
        f"{rel[spread][0]:.2e} of its max; elsewhere "
        f"{max(r for n, (r, _) in rel.items() if not _in_tower(n)):.2e}")
    if failed:
        raise AssertionError("training on the card and on the CPU disagree")


def _leaf_names(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_names(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_names(v, f"{path}/{i}")
    else:
        yield path


# --------------------------------------------------------- K3 and int8 phases

# K3, max |kernel - plain| / max |plain| of the conv features: f32 differs
# only in summation order (measured 2.4e-6 at N=64 on an H100); bf16 rounds
# every activation to bf16 after an f32 sum taken in another order, so a
# sum near a rounding boundary flips by one bf16 ulp (2^-8 relative) and
# later layers carry it (measured 4.2e-3).
K3_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def he_serving(model):
    """A bf16 pipeline on the card with the flagship's weights but He-scaled
    VGGish convs (``he_vggish``: with the default init six ReLU convs shrink
    the signal ~6^6-fold and the kernels' outputs would be near zero), and
    the serving batch's audio: (pipe, log-mel (32, E, 96, 64) f32, example
    counts (32,)), E the audio bucket (37)."""
    mc, params, state, vocab, i2w = model
    pipe = QGPipeline(None, mc, he_vggish(params), state, vocab, i2w,
                      device="cuda", dtype=torch.bfloat16)
    req = requests(mc, N_REQUESTS, SEED + 2)
    host = pipe._pack(*req)
    cap = DEC.audio_bucket(mc, host["audio_len"])
    batch = pipe._to_device(host)
    mel = serving_mel(mc, batch["audio_pcm"], cap, torch.float32)
    lens = torch.clamp(frontends.audio_num_examples(
        batch["audio_len"], hop=mc.stft_hop, window=mc.stft_window,
        frames_per_example=mc.mel_frames, max_examples=cap), min=1)
    return pipe, req, mel, lens


def _conv_ops(x1, convs) -> int:
    """Multiply-adds x 2 of conv2..conv6 on ``x1 (N, 48, 32, 64)``."""
    N, H, W, _ = x1.shape
    ops = 0
    for c, pool in zip(convs[1:], V.POOLS):
        ops += 2 * N * H * W * c.w[0, 0].numel() * 9
        if pool:
            H, W = H // 2, W // 2
    return ops


def _k3_stack(convs, x1, conv, dtype):
    """conv2..conv6 over ``x1 (N, 48, 32, 64)`` through ``conv``."""
    x = x1
    for c, pool in zip(convs[1:], V.POOLS):
        x = conv(x, c.w, c.b, pool=pool, dtype=dtype)
    return x


def _k3_check(what: str, got, ref, dtype) -> tuple:
    """(max |d|, max |plain|); raises beyond K3_RTOL of the max."""
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    scale = float(ref.float().abs().max())
    if not (scale > 0 and err <= K3_RTOL[dtype] * scale):
        raise AssertionError(f"K3 {what} {dtype}: max|d| {err} > "
                             f"{K3_RTOL[dtype]} x {scale}")
    return err, scale


def phase_k3(card: str, serving) -> dict:
    pipe, _, mel, lens = serving
    convs = pipe.model.audio_enc.convs
    flat = mel.reshape((-1,) + mel.shape[2:])
    N = flat.shape[0]
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        x1 = V.conv1_pool(convs, flat, dtype)

        def library():   # cuDNN conv2..conv6 (the port's training tower)
            x = x1
            for c, pool in zip(convs[1:], V.POOLS):
                x = torch.relu(L.conv2d(x, c.w, c.b, padding="SAME",
                                        dtype=dtype, out_dtype=dtype))
                if pool:
                    x = L.maxpool2d(x, 2)
            return x

        got = _k3_stack(convs, x1, V.vggish_conv, dtype)
        ref = _k3_stack(convs, x1, V.vggish_conv_plain, dtype)
        err, scale = _k3_check(f"N={N}", got, ref, dtype)
        ms = cuda_ms(lambda: _k3_stack(convs, x1, V.vggish_conv, dtype),
                     iters=3, warmup=1)
        plain_ms = cuda_ms(lambda: _k3_stack(convs, x1, V.vggish_conv_plain,
                                             dtype), iters=1, warmup=1)
        lib_ms = cuda_ms(library, iters=3, warmup=1)
        weights = [t for c in convs[1:] for t in (c.w.to(dtype), c.b)]
        bnd = bound(_conv_ops(x1, convs), nbytes(x1, *weights, got), dtype)
        log(f"K3 vggish_conv conv2..conv6 N={N} (32 requests x audio bucket "
            f"{mel.shape[1]}) {str(dtype)[6:]}: max|d|={err:.3e} of max "
            f"{scale:.3e} (tol {K3_RTOL[dtype]:.0e} of max) kernel {ms:.2f} "
            f"ms plain {plain_ms:.2f} ms cuDNN {lib_ms:.2f} ms bound "
            f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}) [{card}]")
        if dtype == torch.bfloat16:
            summary = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       **bnd, "library_ms": lib_ms}
            x, parts = x1, []
            for c, pool in zip(convs[1:], V.POOLS):
                layer_ms = cuda_ms(lambda: V.vggish_conv(
                    x, c.w, c.b, pool=pool, dtype=dtype), iters=3, warmup=1)
                N_, H_, W_, Cin = x.shape
                tflops = 2 * N_ * H_ * W_ * 9 * Cin * c.w.shape[-1] / (
                    layer_ms * 1e9)
                parts.append(f"Cin {Cin} -> {c.w.shape[-1]} {layer_ms:.3f} "
                             f"ms ({tflops:.0f} TFLOP/s)")
                x = V.vggish_conv(x, c.w, c.b, pool=pool, dtype=dtype)
            log("K3 vggish_conv bf16 per layer: " + ", ".join(parts)
                + f" [{card}]")
            # ragged sizes: a lone example (every tile partial) and one
            # request's audio bucket (tiles that cross examples)
            for n in (1, mel.shape[1]):
                err, scale = _k3_check(
                    f"N={n}", _k3_stack(convs, x1[:n], V.vggish_conv, dtype),
                    _k3_stack(convs, x1[:n], V.vggish_conv_plain, dtype),
                    dtype)
                log(f"K3 vggish_conv conv2..conv6 N={n} bf16: max|d|="
                    f"{err:.3e} of max {scale:.3e} (tol "
                    f"{K3_RTOL[dtype]:.0e} of max)")

    # the K3 path: the audio tower with use_kernel=True
    _reset_launches()
    emb = pipe.model.audio_enc(mel, lens, dtype=torch.bfloat16,
                               use_kernel=True)
    torch.cuda.synchronize()
    launches = _launches()
    want = dict(ZERO_LAUNCHES, vggish_conv=len(V.POOLS))
    flt = pipe.model.audio_enc(mel, lens, dtype=torch.bfloat16)
    rel = max_abs(emb, flt) / float(flt.abs().max())
    log(f"K3 path: AudioEncoder.forward(use_kernel=True) on {tuple(mel.shape)}"
        f" bf16 launched {launches} (want {want}); embeddings vs the cuDNN "
        f"tower max|d|/max {rel:.3e} (tol {K3_RTOL[torch.bfloat16]:.0e})")
    if launches != want or not rel <= K3_RTOL[torch.bfloat16] or not bool(
            torch.isfinite(emb).all()):
        raise AssertionError("the K3 path failed")
    return dict(summary, launches=launches["vggish_conv"])


def _int8_stack_dp4a(convs, x1, scales, dtype):
    """conv2..conv6 as the int8 tower ran them before the s8 kernel: each
    layer's quantize as plain tensor operations on the card, then the
    __dp4a kernel (force_route="dp4a")."""
    x = x1
    for i, (c, pool) in enumerate(zip(convs[1:], V.POOLS)):
        wq, sw = V.quantize_weights(c.w)
        xq, sx = V.quantize_activations(x, scales[i])
        x = V.conv3x3_relu_int8(xq, wq, sx, sw, c.b, pool=pool, dtype=dtype,
                                force_route="dp4a")
    return x


def _int8_stack_plain(convs, x1, scales, dtype):
    """conv2..conv6 through the plain versions (quantize_activations,
    conv3x3_relu_int8_plain)."""
    x = x1
    for i, (c, pool) in enumerate(zip(convs[1:], V.POOLS)):
        wq, sw = V.quantize_weights(c.w)
        xq, sx = V.quantize_activations(x, scales[i])
        x = V.conv3x3_relu_int8_plain(xq, wq, sx, sw, c.b, pool=pool,
                                      dtype=dtype)
    return x


def _witness(what: str, got, ref) -> str:
    """Where ``got`` and ``ref`` differ most, or "" where they are equal."""
    d = (got.float() - ref.float()).abs()
    if float(d.max()) == 0:
        return ""
    at = tuple(int(a) for a in np.unravel_index(int(d.argmax()), d.shape))
    return (f"; {what} witness at {at}: kernel {float(got[at])!r} plain "
            f"{float(ref[at])!r}")


def _int_mm_yardstick(xq, wq, layer_ms: float, card: str) -> None:
    """torch._int_mm (the library's int8 GEMM, int32 out) on a layer's
    im2col'd product, timed alone beside the s8 kernel's ``layer_ms``: how
    far the card's own int8 GEMM gets on the same M x K x N. A yardstick,
    not the conv (no im2col, no epilogue); the port never calls it."""
    N, H, W, Cin = xq.shape
    Cout = wq.shape[-1]
    xp = torch.nn.functional.pad(xq, (0, 0, 1, 1, 1, 1))
    a = torch.cat([xp[:, dy:dy + H, dx:dx + W] for dy in range(3)
                   for dx in range(3)], dim=3).reshape(N * H * W, 9 * Cin)
    b = V.pack_weights_kmajor(wq, torch.int8).reshape(Cout, 9 * Cin).t()
    M, K = a.shape
    try:
        ms = cuda_ms(lambda: torch._int_mm(a, b), iters=5)
    except RuntimeError as e:   # a yardstick only
        log(f"int8 yardstick: torch._int_mm refused: "
            f"{str(e).splitlines()[0]}")
        return
    ops = 2 * M * K * Cout
    rate, conv_rate = ops / ms / 1e9, ops / layer_ms / 1e9
    log(f"int8 yardstick: torch._int_mm on conv4's im2col'd product (M={M}"
        f" K={K} N={Cout}, int32 out) {ms:.3f} ms ({rate:.0f} TOP/s); the "
        f"s8 conv kernel {layer_ms:.3f} ms ({conv_rate:.0f} TOP/s) [{card}]")
    del a


def phase_int8(card: str, serving) -> dict:
    """The int8 tower's conv2..conv6 on the serving batch (bf16 out, as
    served), with dynamic and with calibrated static scales. Per layer, on
    the plain chain's int8 input: the s8 tensor-core kernel and the forced
    __dp4a route against the plain version (max |d| must be 0; a nonzero
    one prints its witness), timed in turns; the fused next-layer quantize
    against quantize_activations (identical int8 and scales) and the input
    quantize kernel's time. Then the whole stack, conv1-pool output to
    conv6 output with its quantizes, new (V.int8_convs) against old (plain
    quantize + __dp4a) in turns, at the serving batch and ragged batches of
    1 and 37 examples; and torch._int_mm as a yardstick."""
    pipe, _, mel, _ = serving
    convs = pipe.model.audio_enc.convs
    flat = mel.reshape((-1,) + mel.shape[2:])
    dtype = torch.bfloat16
    scales = tuple(pipe.model.audio_enc.calibrate_int8_scales(flat))
    x1 = V.conv1_pool(convs, flat, dtype)
    modes = (("dynamic", (None,) * len(V.POOLS)), ("static", scales))
    tot = dict.fromkeys(("ms", "dp4a_ms", "plain_ms", "q_ms", "q_plain_ms"),
                        0.0)
    ops = nb = q_ops = q_nb = 0
    worst, failures = 0.0, []
    for mode, sc in modes:
        x = x1
        for i, (c, pool) in enumerate(zip(convs[1:], V.POOLS)):
            wq, sw = V.quantize_weights(c.w)
            xq, sx = V.quantize_activations(x, sc[i])
            # the input's quantize kernel: conv2's takes the max itself;
            # later ones take the max their conv folded (dynamic) or are
            # the conv's epilogue (static)
            if i == 0 or mode == "dynamic":
                amax = None if i == 0 else x.float().amax(dim=(1, 2, 3))

                def quant():
                    return V.quantize_s8(x, sc[i], amax=amax)
                gq, gs = quant()
                same = torch.equal(gq, xq) and torch.equal(gs, sx)
                q_ms = cuda_ms(quant, iters=5)
                qp_ms = cuda_ms(lambda: V.quantize_activations(x, sc[i]),
                                iters=5)
                qtxt = (f"input quantize_s8 {q_ms:.3f} ms (plain {qp_ms:.3f} "
                        f"ms), identical int8 and scales {same}")
                if not same:
                    failures.append(f"conv{i + 2} {mode} input quantize")
                if mode == "dynamic":
                    tot["q_ms"] += q_ms
                    tot["q_plain_ms"] += qp_ms
                    q_ops += 2 * x.numel()   # a division and a rounding
                    q_nb += nbytes(x, xq, sx)
            else:
                qtxt = f"input quantize in conv{i + 1}'s epilogue"
            args = (xq, wq, sx, sw, c.b)
            got = V.conv3x3_relu_int8(*args, pool=pool, dtype=dtype)
            old = V.conv3x3_relu_int8(*args, pool=pool, dtype=dtype,
                                      force_route="dp4a")
            ref = V.conv3x3_relu_int8_plain(*args, pool=pool, dtype=dtype)
            torch.cuda.synchronize()
            err, err_old = max_abs(got, ref), max_abs(old, ref)
            worst = max(worst, err, err_old)
            line = (f"int8 conv{i + 2} {tuple(xq.shape)} -> {c.w.shape[-1]} "
                    f"pool={pool} {mode}: wgmma max|d|={err:.3e} dp4a "
                    f"max|d|={err_old:.3e} (want 0) of max "
                    f"{float(ref.float().abs().max()):.3e}"
                    + _witness("wgmma", got, ref) + _witness("dp4a", old, ref))
            if i + 1 < len(V.POOLS):
                def fused():
                    return V.conv3x3_relu_int8_quant(*args, pool=pool,
                                                     dtype=dtype,
                                                     next_scale=sc[i + 1])
                fq, fs = fused()
                rq, rs = V.quantize_activations(ref, sc[i + 1])
                same = torch.equal(fq, rq) and torch.equal(fs, rs)
                line += (f"; fused next quantize identical int8 and scales "
                         f"{same}, conv + next quantize as the path runs them"
                         f" {cuda_ms(fused, iters=3):.3f} ms")
                if not same:
                    failures.append(f"conv{i + 2} {mode} fused quantize")
            turns = in_turns({
                "wgmma": lambda: V.conv3x3_relu_int8(*args, pool=pool,
                                                     dtype=dtype),
                "dp4a": lambda: V.conv3x3_relu_int8(*args, pool=pool,
                                                    dtype=dtype,
                                                    force_route="dp4a")},
                iters=3)
            line += f"; {fmt_turns(turns)} in turns; {qtxt}"
            if mode == "dynamic":
                p = cuda_ms(lambda: V.conv3x3_relu_int8_plain(
                    *args, pool=pool, dtype=dtype), iters=1, warmup=1)
                line += f"; plain {p:.2f} ms"
                tot["ms"] += min(turns["wgmma"])
                tot["dp4a_ms"] += min(turns["dp4a"])
                tot["plain_ms"] += p
                N, H, W, Cin = xq.shape
                ops += 2 * N * H * W * 9 * Cin * c.w.shape[-1]
                nb += nbytes(*args, got)
            log(f"{line} [{card}]")
            if mode == "dynamic" and i == 2:
                _int_mm_yardstick(xq, wq, min(turns["wgmma"]), card)
            x = ref
    bnd = bound(ops, nb, torch.int8)
    q_bnd = bound(q_ops, q_nb, torch.float32)

    def weights():   # what each encode redoes per layer, as JAX does
        for c in convs[1:]:
            V.pack_weights_kmajor(V.quantize_weights(c.w)[0], torch.int8)
    w_ms = cuda_ms(weights, iters=5)
    n_w = sum(c.w.numel() for c in convs[1:])
    log(f"int8 weight quantize per encode (quantize_weights + the K-major "
        f"pack, conv2..conv6, {n_w} f32 weights): {w_ms:.3f} ms [{card}]")
    log(f"int8 conv2..conv6 (dynamic, each layer alone): wgmma "
        f"{tot['ms']:.2f} ms dp4a {tot['dp4a_ms']:.2f} ms plain "
        f"{tot['plain_ms']:.2f} ms bound {bnd['bound_ms']:.3f} ms "
        f"({bnd['bound_by']}); no PyTorch call runs an int8 conv on CUDA; "
        f"input quantizes (5 quantize_s8 launches) {tot['q_ms']:.3f} ms, "
        f"plain {tot['q_plain_ms']:.3f} ms, bound {q_bnd['bound_ms']:.3f} "
        f"ms; static scales {scales} [{card}]")

    # the whole stack as encode runs it, old and new
    stack = {}
    for mode, sc in modes:
        act = None if mode == "dynamic" else sc
        for n in (x1.shape[0], 1, 37):
            xs = x1[:n]
            _reset_launches()
            got = V.int8_convs(convs, xs, dtype=dtype, act_scales=act)
            launched = (V.conv3x3_relu_int8.launches, V.quantize_s8.launches)
            ref = _int8_stack_plain(convs, xs, sc, dtype)
            torch.cuda.synchronize()
            err = max_abs(got, ref)
            worst = max(worst, err)
            want = (len(V.POOLS), len(V.POOLS) if act is None else 1)
            line = (f"int8 stack conv1-pool output -> conv6 output N={n} "
                    f"{mode} (conv5/conv6: 96 positions an example, so "
                    f"128-row tiles straddle examples): int8_convs max|d|="
                    f"{err:.3e} (want 0), launches"
                    f" (int8 conv, quantize) {launched} (want {want})"
                    + _witness("stack", got, ref))
            if err != 0 or launched != want:
                failures.append(f"stack N={n} {mode}")
            if n == x1.shape[0]:
                turns = in_turns({
                    "new": lambda: V.int8_convs(convs, xs, dtype=dtype,
                                                act_scales=act),
                    "old": lambda: _int8_stack_dp4a(convs, xs, sc, dtype)},
                    iters=3)
                stack[mode] = turns
                line += (f"; new (quantize_s8 + s8 conv, quantize fused) vs "
                         f"old (plain quantize + dp4a) in turns: "
                         f"{fmt_turns(turns)}")
            log(f"{line} [{card}]")
    if worst != 0.0 or failures:
        raise AssertionError(f"the int8 kernels and their plain versions "
                             f"differ: max|d| {worst}, {failures}")
    return {"conv": {"max_abs_err": worst, "ms": tot["ms"],
                     "plain_ms": tot["plain_ms"], **bnd, "library_ms": None,
                     "dp4a_ms": tot["dp4a_ms"], "weight_quantize_ms": w_ms,
                     "stack_ms": min(stack["dynamic"]["new"]),
                     "stack_dp4a_ms": min(stack["dynamic"]["old"])},
            "quant": {"max_abs_err": 0.0, "ms": tot["q_ms"],
                      "plain_ms": tot["q_plain_ms"], **q_bnd,
                      "library_ms": None}}


def phase_calibrate(card: str, serving) -> None:
    """calibrate_audio_int8 on the card, then one greedy generate() served
    with the static scales through the int8 kernel."""
    pipe, req, _, _ = serving
    mc = pipe.mc
    t0 = time.perf_counter()
    pipe.calibrate_audio_int8(req[2])
    torch.cuda.synchronize()
    cal_ms = (time.perf_counter() - t0) * 1e3
    scales = pipe.mc.audio_int8_scales
    if not (scales and len(scales) == len(V.POOLS) and all(
            np.isfinite(s) and s > 0 for s in scales)):
        raise AssertionError(f"calibration gave scales {scales}")
    pipe.generate(*req)                      # warm-up
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    questions = pipe.generate(*req)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    # static scales: conv2's input quantize is the one quantize launch, the
    # others are written by conv2..conv5's epilogues
    want = dict(ZERO_LAUNCHES, lstm_seq=mc.text_layers + 1,
                trimodal_attention=mc.target_steps - 1,
                vggish_conv_int8=len(V.POOLS), quantize_s8=1)
    log(f"calibrate: calibrate_audio_int8 on {len(req[2])} clips in "
        f"{cal_ms:.1f} ms, static scales {tuple(f'{s:.4g}' for s in scales)}"
        f"; one greedy generate() with them launched {launches} (want "
        f"{want}), {len(req[0]) / wall:.1f} questions/s [{card}]")
    if launches != want or len(questions) != len(req[0]):
        raise AssertionError("the calibrated int8 serving path failed")
    check_routes("calibrate: K1", lstm_seq.routes, want["lstm_seq"])


def main() -> None:
    dev = phase_device()
    phase_build()
    k1 = phase_k1(dev["card"])
    k2 = phase_k2(dev["card"])
    k4 = phase_k4(dev["card"])
    model = flagship()
    launches = phase_main(dev["card"], model)
    phase_card_vs_cpu(model)
    train_launches = phase_train(dev["card"], model)
    phase_train_card_vs_cpu(model)
    serving = he_serving(model)
    k3 = phase_k3(dev["card"], serving)
    int8 = phase_int8(dev["card"], serving)
    phase_calibrate(dev["card"], serving)
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "mmqg_tpu")]
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: {loaded}")
    kernels = [
        {"name": "lstm_seq", "route": "cuda",
         "design": "persistent cooperative sweep (Wh in shared memory, "
                   "mma.sync h.Wh, grid barrier a step) + mma.sync input "
                   "GEMM",
         "source": "mmqg_tpu_torch/csrc/lstm_seq.cu",
         "replaces": "mmqg_tpu/ops/lstm_pallas.py:100",
         "launches": launches["lstm_seq"], **k1},
        {"name": "trimodal_attention", "route": "cuda",
         "design": "blocks of 16 batch rows x 16 positions x 128 memory "
                   "columns, mma.sync bf16 scores, flash-decoding partials "
                   "merged by the last block of each tile (atomic counter)",
         "source": "mmqg_tpu_torch/csrc/trimodal_attention.cu",
         "replaces": "mmqg_tpu/ops/attention_pallas.py:83",
         "launches": launches["trimodal_attention"], **k2},
        {"name": "lstm_train_fwd", "route": "cuda",
         "design": "K1's persistent sweep emitting h, c and gates + "
                   "mma.sync input GEMM",
         "source": "mmqg_tpu_torch/csrc/lstm_train.cu",
         "replaces": "mmqg_tpu/ops/lstm_train_pallas.py:147",
         "launches": train_launches["lstm_train_fwd"], **k4["fwd"]},
        {"name": "lstm_train_bwd", "route": "cuda",
         "design": "persistent sweep + mma.sync GEMMs",
         "source": "mmqg_tpu_torch/csrc/lstm_train.cu",
         "replaces": "mmqg_tpu/ops/lstm_train_pallas.py:209",
         "launches": train_launches["lstm_train_bwd"], **k4["bwd"]},
        {"name": "vggish_conv", "route": "cuda",
         "design": "wgmma implicit GEMM, 3-stage cp.async ring",
         "source": "mmqg_tpu_torch/csrc/vggish_conv.cu",
         "replaces": "mmqg_tpu/ops/vggish_pallas.py:137", **k3},
        {"name": "vggish_conv_int8", "route": "cuda",
         "design": "s8 wgmma (m64n128k32) implicit GEMM, K3's ring and "
                   "tiles; epilogue folds each example's max or writes the "
                   "next layer's int8 input",
         "source": "mmqg_tpu_torch/csrc/vggish_conv.cu",
         "replaces": "mmqg_tpu/models/audio_encoder.py:157",
         "launches": launches["vggish_conv_int8"], **int8["conv"]},
        {"name": "quantize_s8", "route": "cuda",
         "design": "the int8 tower's activation quantize: one pass, 16 "
                   "values a thread (port-only: XLA ops in JAX)",
         "source": "mmqg_tpu_torch/csrc/vggish_conv.cu",
         "replaces": "mmqg_tpu/models/audio_encoder.py:147",
         "launches": launches["quantize_s8"], **int8["quant"]}]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))


if __name__ == "__main__":
    main()
