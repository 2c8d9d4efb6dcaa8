"""Build and drive the PyTorch + CUDA port (mmqg_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device   the card's name and power limit (nvidia-smi), torch/CUDA/nvcc
2. build    nvcc builds the kernels in mmqg_tpu_torch/csrc/ (seconds)
3. K1       lstm_seq kernel vs its plain PyTorch version, on the card, at
            the encoders' shapes and one edge case (B=5, T=1); the route must
            be the persistent sweep; at text layer 0 bf16 the persistent and
            per-step routes timed in turns beside cuDNN, the per-step
            route's launch floor and the routes at B=128
4. K2       trimodal_attention's tiled kernel vs its plain version, on the
            card, at B = 1, 32, 33 and 128 and lengths random, 1, L and
            L - 3, one launch a call; timed at B=32 and 128
5. main     QGPipeline at the flagship's full width (random weights from a
            seed) answers 32 greedy requests; K1 must launch 4x per encode,
            each by the persistent route, K2 21x per decode, and the int8
            conv 5x and quantize_s8 5x per encode
6. card/cpu the same pipeline in f32 on 4 requests, on the card and on the
            CPU: identical greedy tokens, logits within a stated tolerance
7. strategies  the same pipeline (bf16, int8 tower) serves 32 requests by
            beam search (K=4): K2 must launch 21x on 128 rows, K1 4x
            persistent, the int8 conv 5x; beam and greedy generate() timed
            in turns and one beam decode profiled (K2's
            device time at 128 rows); sampling, top-k and top-p: each row
            served alone with its row seed equals the row in the batch (f32
            must; bf16 is printed); a sampled generate() against greedy in
            turns; every strategy card vs CPU in f32 (identical tokens, the
            beam tokens' log-probability within a stated tolerance);
            evaluate() with beam and sampling over two synthetic batches; the
            host's media tools (cv2, libav, ffmpeg), printed, not checked
8. K4       lstm_layer_train forward + backward kernels vs their plain
            versions at the encoders' shapes and one edge case (B=5, T=1),
            f32 and bf16, with times; the forward's and the backward's
            routes must be the persistent sweeps at the encoders' shapes; the
            forward's two routes timed in turns at text layer 0 bf16; then
            shapes off the main path, each with its time and route: H=2048
            at B=20 and 32 (both directions per step) and B=128 at H=512
            (the forward's sweep in row chunks, the backward per step)
9. train    Trainer.run_epoch at the flagship's full width, bf16, batch 32,
            on a synthetic in-memory corpus: K4 must launch 4x forward and
            4x backward per step, all persistent, K1/K2 none; one step timed
            and profiled
            (step ms, samples/s, device idle share); then validate(), which
            must launch K1 4x per batch and K2 22x per batch
10. train card/cpu  one f32 train step of 4 samples on the card and on the
            CPU (He-scaled VGGish convs and tone audio, so the audio
            attention has gradients to compare): loss, every gradient leaf
            and the updated parameters within stated tolerances
11. K3      vggish_conv kernel vs its plain version on the serving batch's
            1184 examples of 96 x 64 log-mel, f32 and bf16, with the cuDNN
            conv2..conv6 stack timed beside it, and in bf16 at two ragged
            sizes (1 and 37 examples); then the K3 path,
            AudioEncoder.forward(use_kernel=True), must launch it 5x
12. int8    vggish_conv_int8 (the s8 tensor-core kernel, timed) vs its
            plain version on the same batch's quantized inputs, each of the
            five layers, dynamic and static scales: max |d| must be 0; the
            fused next-layer quantize and quantize_s8 vs
            quantize_activations: identical int8 and scales; the whole int8
            stack (quantizes included) vs the plain chain, timed, and at 1
            and 37 examples; torch._int_mm as a yardstick
13. calibrate  QGPipeline.calibrate_audio_int8 on the card, then one greedy
            generate() with the static scales (quantize_s8 once: the later
            quantizes are the convs' epilogues)
14. video   lecture mp4s in, questions out, on the flagship (bf16, int8
            tower): 8 mp4s of 30-120 s at 320 x 240, 24 fps, written by
            cv2, with subtitles and staged 44.1 kHz stereo wavs, 10 spans
            of 4-30 s. One generate_from_video, generate_from_videos per
            video (4 prep workers) and coalesced (up to 32 rows a batch), and
            a sequential baseline (every prep, then one generate a video):
            each dispatched batch must launch K1 4x (persistent), K2 21x,
            the int8 conv 5x and quantize_s8 5x; every video
            must take the frame route the host supports (native where libav
            loads, else cv2) and its audio from the staged wav; a corrupt and
            a missing mp4 error alone; in f32 on 4 videos every path gives
            the same questions, greedy and sampled (bf16: printed). Prints
            host prep ms by part, videos/s and questions/s per path, the
            completion times' p50 and p90 and the batches
15. serve   the JSONL daemon: serve() in process on 32 requests (staged and
            raw-video, one malformed line), greedy, max_batch 32, linger 25
            ms: every id answered once, the launches per dispatched batch as
            in 14; then `python -m mmqg_tpu_torch.serve` as a process with
            no --device, on a flagship checkpoint written by the port, fed
            16 requests on stdin: exit 0, one answer per id, `ready` on
            stderr
16. configs the configurations beside the flagship, at its full width
            (R(2+1)D-18 at torchvision's widths, 512-d features), random
            weights, the same 32 requests, bf16: trimodal + attention +
            R(2+1)D (greedy and beam: K1 3x, K2 21x tiled on B or B * K
            rows, the int8 conv 5x per generate(), the batchnorm epilogue
            34x a trunk; encode and decode wall, the trunk's device time,
            the encode's peak memory; at one trunk's shapes at B=32 and
            101 frames each distinct epilogue call bit for bit with its
            plain version, with its kernel, plain and bound ms),
            text_video + non-attention + conv-LSTM (greedy, sampling, beam:
            K1 4x, K2 none) and text + attention (greedy: K1 3x, K2 21x, no
            int8); 320 x 240 frames through encode with R(2+1)D (the resize
            on the card, timed, against the CPU's); a train step of
            R(2+1)D at B=16 with remat_video off and on (the same loss,
            gradients within a band, step wall and peak memory; K4 3x each
            way), a non-attention step at B=32 (K4 4x each way), and
            gradient accumulation (two half batches vs the whole, f32); each
            of the three card vs CPU in f32 on 4 requests: identical
            questions for every strategy run

17. dp      data parallelism at the flagship's full width: QGPipeline
            .shard() over every visible card, or two replicas on cuda:0
            when there is one (they test the split and the merge, not
            scaling), serves 37 requests (64 rows, split in row blocks) in
            f32: launches and routes per replica (K1 4x persistent, K2 21x
            tiled, the int8 conv 5x wgmma, quantize_s8 5x) adding up to
            the unsharded counts times the replicas; the tokens of greedy,
            sampling (per-row and per-batch streams), topk, topp and beam
            (K=4) equal the unsharded pipeline's; bf16 generate() unsharded
            and sharded in turns, of 37 and of 128 requests. Then the
            data-parallel train step at two and at four ranks (spawned
            processes: NCCL, a card a rank, where there are that many
            cards, else gloo on the cards in turn, all on cuda:0 with one),
            B=16 with 8 or 4 rows a rank and fewer frames in the second
            half, f32, SGD, against one process's step on the 16 rows:
            loss, every gradient leaf, the parameters, K4 4x persistent
            each way a rank, equal parameters on every rank; the step ms at
            world size 1, 2 and 4, the gradient all-reduce's ms, and one
            NCCL group at world size 1 (its all-reduce checked and timed).
            Each group's backend and world size is printed
18. offline the offline half: a raw corpus written from SEED (8 lecture
            mp4s as in 14, .srt, staged 44.1 kHz stereo wavs, 96 labelled
            questions of 4-30 s, videos.json, a 300-d GloVe file covering
            every other word) goes through ``mmqg_tpu_torch.prepare``
            (saliency, glove, text, data; 4 workers) in a child process:
            its printed lines, each stage's ms, the frame route the host
            supports and no audio extracted, one .npy and one clip per
            question, the 80/10/10 splits; extract_audio's route on this
            host, and whether scikit-learn imports (printed, not used).
            QGDataset on the prepared files, the flagship's widths with
            the corpus's vocabulary, Trainer.run_epoch at batch 32 bf16
            (K4 4x each way a step, persistent; loss finite) and
            validate() (K1 4x, K2 22x tiled, the int8 conv and quantize_s8
            5x). The flagship's weights exported to the reference's four
            artifacts, saved, loaded with weights_only and imported: every
            leaf bit for bit, and the main path's 32 requests in f32 give
            identical tokens from both models (K1 4x, K2 21x, the int8
            conv 5x a generate()). ``python -m mmqg_tpu_torch.convert
            --dry-run`` on the card: the checkpoint restores through
            Trainer.resume and holds the stand-in VGGish's weights

19. train_features  the training path's single-axis features at the
            flagship's full width, bf16, global batch 32: two ranks (NCCL
            over two cards where two are visible, else gloo on cuda:0)
            take one f32 step each plain (all-reduce), ZeRO-1 and FSDP
            from the same weights (Adam with a clip): the sharded states,
            gathered, held to the plain one's (every leaf within a stated
            share of its max), K4 4x each way a step, persistent; then
            bf16 steps of the three in turns (walls, peak memory above
            the resident state), the optimizer-state and parameter bytes
            each rank holds between steps against the rule's, and the
            all-reduce, reduce-scatter and all-gather alone. One Trainer
            epoch with profile_dir (K4 launches counted, the trace of the
            warm step read back for K4's forward and backward kernels by
            name) and validate() (K1 4x, K2 22x, the int8 conv and
            quantize_s8 5x). The trained state saved to msgpack
            synchronously and asynchronously in turns (the caller's
            blocked time, equal bytes, a load round trip); the orbax
            backend where tensorstore imports, else its ImportError

20. model_axis  the mesh's model axis at the flagship's full width: a
            (1, 2) grid of two ranks (gloo on cuda:0 with one card, NCCL
            over two cards with more; with four cards a (2, 2) grid too)
            takes one f32 tensor-parallel step (cuDNN deterministic; the
            state stored by JAX's param_shardings, the split leaves
            gathered at use, the vocab projection column-parallel): every
            gradient leaf within a stated share of its max of one
            process's step on the same rows (the ReLU conv towers within a
            wider one), K4 4x each way a rank, persistent; a sequence-
            parallel step (gather-free) with the plain step's loss; bf16
            steps tensor-parallel and one process in turns; the bytes of
            parameters and optimizer state each rank holds between steps
            against the rule's; the model group's all-gather of the split
            leaves alone; sp_greedy_decode of the 32 requests in both modes
            with the unsharded greedy tokens (f32); GPipe on toy stages
            against the sequential stack. In this process
            QGPipeline.shard(shape=(1, 2)) over two positions of cuda:0
            (or two cards) answers the 32 requests greedy and by beam with
            the unsharded tokens (f32), launching K1 4x, K2 21x, the int8
            conv and quantize_s8 5x a replica row on their routes. Then
            dryrun_multichip over the visible cards (four gloo ranks on
            cuda:0 with one card)

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
any result. It imports nothing of JAX, flax, optax or orbax and nothing of
the JAX package ``mmqg_tpu``, and checks at the end that no such module
was loaded (tensorstore, which the orbax backend writes with, imports no
JAX).

    python3 chip_smoke.py --dp-clis

runs, after phases 1 and 2, the data-parallel CLIs as processes over every
visible card on a corpus it writes at the flagship's shapes: ``train
--data-parallel`` (its workers' peak RSS), ``evaluate --data-parallel
--streaming`` against the unsharded evaluate's predictions, and ``serve
--data-parallel`` against the unsharded daemon (``phase_dp_clis``).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import List
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType

from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch import evaluate as EV
from mmqg_tpu_torch import metrics as M
from mmqg_tpu_torch import pipeline as P
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.data import native, saliency
from mmqg_tpu_torch.data.vocab import END_ID
from mmqg_tpu_torch.models import decoder as decoder_module
from mmqg_tpu_torch.models import frontends
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.models import video_resnet as VR
from mmqg_tpu_torch.models import video_swin as VS
from mmqg_tpu_torch.models.qg_model import ModelConfig, init_params
from mmqg_tpu_torch.ops import _build
from mmqg_tpu_torch.ops import bn_epilogue as BNE
from mmqg_tpu_torch.ops import vggish as V
from mmqg_tpu_torch.ops import window_attention as WA
from mmqg_tpu_torch.ops.attention import (trimodal_attention,
                                          trimodal_attention_plain)
from mmqg_tpu_torch.ops.lstm import lstm_seq, lstm_seq_plain
from mmqg_tpu_torch.ops.lstm_train import (bwd_route, lstm_layer_train,
                                           lstm_train_bwd_plain,
                                           lstm_train_fwd_plain)
from mmqg_tpu_torch.optim import (apply_updates, make_optimizer, tree_items,
                                  tree_leaves, tree_map)
from mmqg_tpu_torch.pipeline import QGPipeline, row_seed_array
from mmqg_tpu_torch.train import (Trainer, TrainState, batch_arrays,
                                  make_train_step, to_device)
from mmqg_tpu_torch.utils import prng

SEED = 0
REPO = Path(__file__).resolve().parent
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
                           "per_step_ms": min(turns["per_step"])}
    # the per-step route's latency floor: 283 back-to-back launches of a
    # one-element kernel (one launch a step)
    one = torch.zeros(1, device=dev)
    floor = cuda_ms(lambda: [one.add_(1.0) for _ in range(283)], iters=5)
    log(f"K1 latency floor: 283 dependent one-element launches take "
        f"{floor:.3f} ms ({floor / 283 * 1e3:.2f} us each) [{card}]")
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
    return summary


# (B, lengths) of the K2 phase: the decode's batch and a later benchmark's
# (timed), a lone row, a ragged batch tile (33 rows), and lengths 1, L and
# L - 3 (not a multiple of the kernel's 16-position chunk)
K2_CASES = ((32, "random"), (128, "random"), (1, "random"), (33, "random"),
            (32, "one"), (33, "full"), (33, "ragged"))
# the Swin-B cell's shapes: a 1024-wide video memory padded to 101 steps
# whose lengths stop at 51 (one step per 2 of <= 101 frames), beside the
# audio's 101; the serving batch (timed), a ragged batch tile, the beam's
# 128 rows and a lone row
K2_SWIN_HV, K2_SWIN_STEPS = 1024, 51
K2_SWIN_CASES = ((32, "random"), (33, "full"), (33, "ragged"),
                 (128, "random"), (1, "one"))


def _k2_case(rng, B, dtype, dev, lengths="random", Hv=512, Lv=101):
    """One K2 call against the plain version; the video memory ``Hv``
    wide with lengths up to ``Lv`` of its 101 steps."""
    Dq, Lt, La, Ht, Ha = 812, 283, 101, 512, 128

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
            for L in (Lt, Lv, La)]
    args = (w_t, b, q, *mems, *lens)
    before = trimodal_attention.launches
    got = trimodal_attention(*args)
    launched = trimodal_attention.launches - before
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
    return err, launched, args, bnd


def phase_k2(card: str) -> dict:
    """The kernel against the plain version at every K2_CASES entry and,
    with the Swin-B cell's 1024-wide video memory, every K2_SWIN_CASES
    entry, f32 and bf16, one launch a call; at B=32 and 128 with random
    lengths the kernel timed beside the plain version: its device time
    (torch.profiler), and the wrapper's calls back to back (CUDA events;
    the host sets that pace)."""
    rng = np.random.RandomState(SEED + 1)
    dev = torch.device("cuda")
    summary, failures = {}, []
    cases = ([(B, n, 512, 101) for B, n in K2_CASES]
             + [(B, n, K2_SWIN_HV, K2_SWIN_STEPS) for B, n in K2_SWIN_CASES])
    for dtype in (torch.float32, torch.bfloat16):
        for B, lengths, Hv, Lv in cases:
            err, launched, args, bnd = _k2_case(rng, B, dtype, dev, lengths,
                                                Hv, Lv)
            line = (f"K2 trimodal_attention B={B} Dq=812 L=283/101/101 "
                    f"Hv={Hv} video lengths <= {Lv} lengths {lengths} "
                    f"{str(dtype)[6:]}: launches {launched}; "
                    f"max|d|={err:.3e} (tol {K2_TOL[dtype]:.0e})")
            if lengths == "random" and B in (32, 128):
                def call():
                    return trimodal_attention(*args)
                ms = device_ms(call, ("attn_tile_kernel",))
                call_ms = cuda_ms(call, iters=50)
                plain_ms = cuda_ms(lambda: trimodal_attention_plain(*args),
                                   iters=20)
                line += (f"; device time {ms:.4f} ms; calls back to back "
                         f"(host-paced) {call_ms:.4f} ms; plain "
                         f"{plain_ms:.4f} ms; bound {bnd['bound_ms']:.4f} ms "
                         f"({bnd['bound_by']}; no library call computes it)")
                if dtype == torch.bfloat16 and B == 32 and Hv == 512:
                    summary.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   **bnd, library_ms=None, call_ms=call_ms)
                elif dtype == torch.bfloat16 and B == 32:
                    summary["swin_hv1024"] = {"max_abs_err": err, "ms": ms,
                                              "plain_ms": plain_ms, **bnd}
            log(f"{line} [{card}]")
            if not err <= K2_TOL[dtype] or launched != 1:
                failures.append(f"B={B} Hv={Hv} {lengths} {dtype}: max|d| "
                                f"{err} launches {launched}")
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
    return (mc, params, state) + synthetic_vocab()


def synthetic_vocab():
    """(vocab, index_to_word) of N_VOCAB words w3, w4, ..."""
    words = ["<pad>", "<start>", "<end>"] + [f"w{i}" for i in
                                             range(3, N_VOCAB)]
    vocab = {w: i for i, w in enumerate(words)}
    return vocab, {str(i): w for i, w in enumerate(words)}


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


# ------------------------------------------------------------ strategies

BEAM_SIZE = 4
# profiled beam decodes taken until the trace holds every K2 launch
PROFILE_TRIES = 3
# the sampled strategies of the phase: (strategy, k, p)
DRAWS = (("sampling", 1, 0.9), ("topk", 5, 0.9), ("topp", 1, 0.9))
STRATEGY_SEED = 7
# rows served alone for the per-row check (of the 32)
ALONE_ROWS = (0, 5, 9, 14, 18, 23, 27, 31)
# f32 sequence log-probability of the beam tokens, card vs CPU: 21 steps of
# log-softmax over logits that agree within LOGIT_TOL
LOGPROB_TOL = 1e-4


def row_ids(n: int) -> List[int]:
    """Stable request identities for the per-row streams, some of them past
    2**31 and negative, so that their wrap into int32 is exercised."""
    return [2**31 + 3 * i if i % 3 == 0 else -7 * i if i % 3 == 1 else 1000 + i
            for i in range(n)]


def request_caps(pipe, req) -> dict:
    """The AV caps of a request batch, to pin a sub-request to them."""
    host = pipe._pack(*req)
    return dict(audio_cap=DEC.audio_bucket(pipe.mc, host["audio_len"]),
                frames_cap=DEC.frames_bucket(pipe.mc, host["frames_len"]))


def per_row_check(pipe, req, strategy: str, k: int, p: float, rows):
    """(questions of the batch, rows of ``rows`` whose question served alone
    differs): each row is served alone with its row seed and the batch's
    AV caps, so its encoders run the same steps as in the batch."""
    ids = row_ids(len(req[0]))
    kw = dict(strategy=strategy, topk=k, top_p=p, seed=STRATEGY_SEED,
              **request_caps(pipe, req))
    together = pipe.generate_async(*req, row_seeds=ids, **kw)()
    differ = [i for i in rows if pipe.generate_async(
        *(r[i:i + 1] for r in req), row_seeds=ids[i:i + 1], **kw)()
        != together[i:i + 1]]
    return together, differ


def strategy_tokens(pipe, req) -> dict:
    """Every strategy's tokens of one request batch in ``pipe.dtype`` from
    one encode, and the sequence log-probability of the beam tokens."""
    mc = pipe.mc
    host = pipe._pack(*req)
    mem, st = DEC.encode(pipe.model, mc, pipe._to_device(host),
                         dtype=pipe.dtype, **request_caps(pipe, req))
    max_len = mc.target_steps - 1
    seeds = torch.from_numpy(row_seed_array(host["context_ids"].shape[0],
                                            len(req[0]),
                                            row_ids(len(req[0]))))
    out = {"beam": DEC.beam_from_memories(pipe.model, mem, st,
                                          max_len=max_len,
                                          beam_size=BEAM_SIZE,
                                          dtype=pipe.dtype)}
    for strategy, k, p in DRAWS:
        out[strategy] = DEC.decode_from_memories(
            pipe.model, mem, st, prng.prng_key(STRATEGY_SEED, pipe.device),
            strategy=strategy, max_len=max_len, k=k, p=p, dtype=pipe.dtype,
            row_seeds=seeds)
    out["logprob"] = DEC.sequence_logprob_from_memories(
        pipe.model, mem, st, out["beam"], dtype=pipe.dtype)
    return {k: v.cpu() for k, v in out.items()}


def evaluate_corpus(model, mc, corpus, strategy: str):
    """evaluate() over ``corpus`` (a SyntheticCorpus); checks the
    predictions' schema and that the BLEU values are finite."""
    preds, bleu = EV.evaluate(model, mc, corpus, strategy=strategy,
                              batch_size=corpus.batch_size,
                              pred_max_len=mc.target_steps - 1,
                              beam_size=BEAM_SIZE, seed=STRATEGY_SEED)
    n = corpus.n_batches * corpus.batch_size
    ids = [p["question_id"] for p in preds]
    if (len(preds) != n or ids != list(range(n)) or any(
            set(p) != {"question_id", "gt_question", "pred_question"}
            or not isinstance(p["pred_question"], str) for p in preds)):
        raise AssertionError(f"evaluate({strategy}): bad predictions")
    if set(bleu) != set(M.BLEU_WEIGHTS) or not all(
            np.isfinite(v) for v in bleu.values()):
        raise AssertionError(f"evaluate({strategy}): BLEU {bleu}")
    return preds, bleu


def media_probe() -> str:
    """What the host offers for decoding lecture videos: cv2, libav's
    shared libraries and dev package, and the ffmpeg binary."""
    import ctypes.util
    import importlib.util
    import shutil

    cv2 = "no"
    if importlib.util.find_spec("cv2") is not None:
        try:
            import cv2 as _cv2
            cv2 = f"yes {_cv2.__version__}"
        except ImportError as e:
            cv2 = f"found but fails to import ({e})"
    libs = {n: ctypes.util.find_library(n) or "no"
            for n in ("avformat", "avcodec", "swscale")}
    pkg = shutil.which("pkg-config")
    dev = ("no pkg-config" if pkg is None else
           "yes" if subprocess.run([pkg, "--exists", "libavformat"]
                                   ).returncode == 0 else "no")
    return (f"host media: cv2 {cv2}; libav "
            + ", ".join(f"{n} {v}" for n, v in libs.items())
            + f"; pkg-config libavformat {dev}; ffmpeg "
            f"{shutil.which('ffmpeg') or 'no'}")


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_strategies(card: str, model) -> dict:
    """Beam search, sampling, top-k and top-p on the flagship at full width
    (bf16, the int8 tower): beam's launches and routes (K2 on B * K rows),
    its wall in turns with greedy and one profiled beam decode; the per-row
    contract of the sampled strategies; a sampled generate() against greedy
    in turns; every strategy card vs CPU in f32; evaluate() on the card;
    the host's media tools."""
    mc, params, state, vocab, i2w = model
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cuda",
                      dtype=torch.bfloat16)
    req = requests(mc, N_REQUESTS, SEED + 2)
    rows = N_REQUESTS * BEAM_SIZE
    beam = dict(strategy="beam", beam_size=BEAM_SIZE)
    pipe.generate(*req, **beam)              # warm-up
    torch.cuda.synchronize()

    # beam: launches, routes, and the rows K2 runs on
    k2_rows = []
    real = decoder_module.trimodal_attention

    def counting(w_t, b, q, *args, **kw):
        k2_rows.append(q.shape[0])
        return real(w_t, b, q, *args, **kw)

    _reset_launches()
    with mock.patch.object(decoder_module, "trimodal_attention", counting):
        questions = pipe.generate(*req, **beam)
        torch.cuda.synchronize()
    launches = _launches()
    want = dict(ZERO_LAUNCHES, lstm_seq=mc.text_layers + 1,
                trimodal_attention=mc.target_steps - 1,
                vggish_conv_int8=len(V.POOLS), quantize_s8=len(V.POOLS))
    log(f"strategies: one beam generate() of {N_REQUESTS} requests, K="
        f"{BEAM_SIZE}, launched {launches} (want {want}); K2 rows per "
        f"launch {sorted(set(k2_rows))} (want [{rows}])")
    if launches != want or set(k2_rows) != {rows}:
        raise AssertionError(f"beam launches {launches}, K2 rows {k2_rows}")
    check_routes("strategies: beam K1", lstm_seq.routes, want["lstm_seq"])
    if len(questions) != N_REQUESTS or not all(
            isinstance(q, str) for q in questions):
        raise AssertionError("beam generate() did not return one string a "
                             "request")

    # beam and greedy generate() in turns
    runs = {"beam": [], "greedy": []}
    for s in ("beam", "greedy", "greedy", "beam", "beam", "greedy"):
        runs[s].append(_wall_ms(lambda: pipe.generate(
            *req, strategy=s, beam_size=BEAM_SIZE)))
    for s, ms in runs.items():
        log(f"strategies: {s} generate() of {N_REQUESTS} requests: "
            + ", ".join(f"{t:.1f}" for t in ms) + " ms ("
            + ", ".join(f"{N_REQUESTS / t * 1e3:.1f}" for t in ms)
            + " questions/s; order beam, greedy, greedy, beam, beam, "
            f"greedy) [{card}]")

    # one beam decode under torch.profiler: K2 at B * K rows
    host = pipe._pack(*req)
    mem, st = DEC.encode(pipe.model, mc, pipe._to_device(host),
                         dtype=pipe.dtype, **request_caps(pipe, req))
    # The counters above hold the launches; the trace only times them. A
    # trace that lost a kernel record (torch.profiler drops one now and
    # then) is reported and taken again, at most PROFILE_TRIES times.
    for attempt in range(1, PROFILE_TRIES + 1):
        wall, busy, prof = _device_busy_ms(lambda: DEC.beam_from_memories(
            pipe.model, mem, st, max_len=mc.target_steps - 1,
            beam_size=BEAM_SIZE, dtype=pipe.dtype))
        k2 = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and "attn_tile_kernel" in e.name]
        if len(k2) == mc.target_steps - 1:
            break
        log(f"strategies: profiled beam decode, try {attempt} of "
            f"{PROFILE_TRIES}: the trace holds {len(k2)} of the "
            f"{mc.target_steps - 1} K2 launches")
    k2_ms = sum(k2) / len(k2) / 1e3 if k2 else None
    log(f"strategies: one beam decode (K={BEAM_SIZE}, {rows} rows, "
        f"{mc.target_steps - 1} steps) under torch.profiler: wall "
        f"{wall:.2f} ms, device busy "
        + ("not measured" if busy is None else
           f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}")
        + f"; K2 {len(k2)} launches, "
        + ("not measured" if k2_ms is None else f"{k2_ms:.4f} ms each")
        + f" of device time at {rows} rows [{card}]")
    if len(k2) != mc.target_steps - 1:
        raise AssertionError(f"the profiler saw {len(k2)} K2 launches")

    # the sampled strategies: each row alone equals the row in the batch
    for dtype in (torch.bfloat16, torch.float32):
        pipe.dtype = dtype
        for strategy, k, p in DRAWS:
            together, differ = per_row_check(pipe, req, strategy, k, p,
                                             ALONE_ROWS)
            log(f"strategies: {strategy} (k={k}, p={p}) {dtype}: rows "
                f"{list(ALONE_ROWS)} served alone with their row seeds: "
                f"{len(ALONE_ROWS) - len(differ)} of {len(ALONE_ROWS)} "
                f"questions identical to the batch's (differ: {differ}); "
                f"e.g. {together[0][:60]!r}")
            if dtype == torch.float32 and differ:
                raise AssertionError(f"{strategy}: rows {differ} depend on "
                                     "their batch")
    pipe.dtype = torch.bfloat16

    # a sampled generate() against greedy, in turns
    runs = {"greedy": [], "sampling": []}
    for s in ("greedy", "sampling", "sampling", "greedy"):
        runs[s].append(_wall_ms(lambda: pipe.generate(
            *req, strategy=s, seed=STRATEGY_SEED)))
    log("strategies: generate() of 32 requests, "
        + "; ".join(f"{s} " + ", ".join(f"{t:.1f}" for t in ms) + " ms"
                    for s, ms in runs.items())
        + f" (order greedy, sampling, sampling, greedy) [{card}]")

    # every strategy card vs CPU, f32, float VGGish on both
    fmc = mc._replace(audio_int8_serving=False)
    small = tuple(r[:4] for r in req)
    out = {d: strategy_tokens(QGPipeline(None, fmc, params, state, vocab, i2w,
                                         device=d, dtype=torch.float32),
                              small) for d in ("cuda", "cpu")}
    same = {s: torch.equal(out["cuda"][s], out["cpu"][s])
            for s in ("beam",) + tuple(d[0] for d in DRAWS)}
    lp = max_abs(out["cuda"]["logprob"], out["cpu"]["logprob"])
    log(f"strategies: card vs cpu (f32, float VGGish, 4 requests, seed "
        f"{STRATEGY_SEED}, row seeds {row_ids(4)}): tokens identical "
        f"{same}; beam sequence log-prob max|d|={lp:.3e} (tol "
        f"{LOGPROB_TOL:.0e}) of {out['cpu']['logprob'].tolist()}")
    if not all(same.values()) or not lp <= LOGPROB_TOL:
        raise AssertionError(f"strategies card vs CPU: {same}, {lp}")

    # evaluate() on the card over two batches of the synthetic corpus, made
    # before the timer starts; each batch launches what one generate() does
    corpus = SyntheticCorpus(mc, i2w, 2, N_REQUESTS, SEED + 6)
    for i in range(corpus.n_batches):
        corpus.batch(i)
    two = {name: 2 * n for name, n in want.items()}
    for strategy in ("beam", "sampling"):
        _reset_launches()
        t0 = time.perf_counter()
        preds, bleu = evaluate_corpus(pipe.model, mc, corpus, strategy)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ev = _launches()
        log(f"strategies: evaluate({strategy}) of {len(preds)} questions on "
            f"the card: bleu {bleu['bleu']:.4f} bleu_1 {bleu['bleu_1']:.4f}, "
            f"{ms:.1f} ms, launched {ev} (want {two}); "
            f"e.g. {preds[0]['pred_question'][:60]!r}")
        if ev != two:
            raise AssertionError(f"evaluate({strategy}) launches {ev}")
        check_routes(f"strategies: evaluate({strategy}) K1", lstm_seq.routes,
                     two["lstm_seq"])

    log(media_probe())
    return {"beam_launches": launches["trimodal_attention"],
            "beam_rows": rows, "beam_device_ms": k2_ms}


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
# shapes off the main path whose sweeps cannot hold every block at once,
# with the routes the wrappers must pick there: H=2048 (256 column blocks a
# row block outnumber the resident ones, and the f32 slices of Wh exceed
# shared memory), so both directions step; B=128 at H=512, where the
# forward runs its sweep in row chunks and the backward steps
K4_WIDE = ((("wide", 20, 37, 300, 2048), ("per_step", "per_step")),
           (("wide", 32, 37, 300, 2048), ("per_step", "per_step")),
           (("text layer 0", 128, 283, 300, 512), ("persistent", "per_step")))


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
    summary["fwd"]["wide_shapes"], summary["bwd"]["wide_shapes"] = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for (name, B, T, In, H), want in K4_WIDE:
            before = (dict(lstm_layer_train.fwd_routes),
                      dict(lstm_layer_train.bwd_routes))
            fwd_err, grad_abs, grad_rel, ms, bnds, lib, _ = _k4_case(
                rng, B, T, In, H, dtype, dev)
            routes = (routes_taken(lstm_layer_train.fwd_routes, before[0]),
                      routes_taken(lstm_layer_train.bwd_routes, before[1]))
            worst = max(grad_rel.values())
            log(f"K4 lstm_layer_train {name} B={B} T={T} In={In} H={H} "
                f"{str(dtype)[6:]}: fwd max|d|={fwd_err:.3e} (tol "
                f"{K4_FWD_TOL[dtype]:.0e}); worst grad max|d|/max|plain| "
                f"{worst:.2e} (tol {K4_GRAD_TOL[dtype]:.0e}); routes forward "
                f"{routes[0]} backward {routes[1]} (designed {want[0]}, "
                f"{want[1]}); kernel fwd {ms['fwd']:.2f} ms bwd "
                f"{ms['bwd']:.2f} ms, plain fwd {ms['plain_fwd']:.2f} ms bwd "
                f"{ms['plain_bwd']:.2f} ms, cuDNN LSTM fwd "
                f"{fmt_ms(lib['fwd'])} bwd {fmt_ms(lib['bwd'])}, bound fwd "
                f"{bnds['fwd']['bound_ms']:.4f} ms bwd "
                f"{bnds['bwd']['bound_ms']:.4f} ms [{card}]")
            if not (fwd_err <= K4_FWD_TOL[dtype]
                    and worst <= K4_GRAD_TOL[dtype]):
                failures.append(f"{name} B={B} {dtype}")
            if routes != want:
                failures.append(f"{name} B={B} {dtype}: routes {routes}")
            key = f"B={B} H={H} {str(dtype)[6:]}"
            for d in ("fwd", "bwd"):
                summary[d]["wide_shapes"][key] = {
                    "route": routes[d == "bwd"], "max_abs_err": (
                        fwd_err if d == "fwd" else grad_abs),
                    "ms": ms[d], "plain_ms": ms[f"plain_{d}"],
                    "bound_ms": bnds[d]["bound_ms"],
                    "library_ms": lib[d]}
    log(f"K4 routes over the phase: forward {lstm_layer_train.fwd_routes}, "
        f"backward {lstm_layer_train.bwd_routes}")
    if failures:
        raise AssertionError(f"K4 kernel and plain disagree: {failures}")
    return summary


# -------------------------------------------------------------- train phase

@dataclass
class SyntheticBatch:
    """The fields of ``mmqg_tpu_torch.data.dataset.Batch`` that training
    and evaluation read."""
    context_ids: np.ndarray
    context_len: np.ndarray
    frames: np.ndarray
    frames_len: np.ndarray
    audio_pcm: np.ndarray
    audio_len: np.ndarray
    target_ids: np.ndarray
    target_len: np.ndarray
    question_id: np.ndarray
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
                              tgt_len, np.arange(i * B, (i + 1) * B),
                              np.ones(B, bool), questions)


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
                   lstm_layer_train.bwd_routes):
        counts.update(dict.fromkeys(counts, 0))
    V.vggish_conv.launches = V.conv3x3_relu_int8.launches = 0
    V.quantize_s8.launches = 0
    BNE.bn_epilogue.launches = 0


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
    the plain chain's int8 input: the s8 tensor-core kernel against the
    plain version (max |d| must be 0; a nonzero one prints its witness),
    timed; the fused next-layer quantize against quantize_activations
    (identical int8 and scales) and the input quantize kernel's time. Then
    the whole stack, conv1-pool output to conv6 output with its quantizes
    (V.int8_convs), against the plain chain at the serving batch (timed)
    and ragged batches of 1 and 37 examples; and torch._int_mm as a
    yardstick."""
    pipe, _, mel, _ = serving
    convs = pipe.model.audio_enc.convs
    flat = mel.reshape((-1,) + mel.shape[2:])
    dtype = torch.bfloat16
    scales = tuple(pipe.model.audio_enc.calibrate_int8_scales(flat))
    x1 = V.conv1_pool(convs, flat, dtype)
    modes = (("dynamic", (None,) * len(V.POOLS)), ("static", scales))
    tot = dict.fromkeys(("ms", "plain_ms", "q_ms", "q_plain_ms"), 0.0)
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
            ref = V.conv3x3_relu_int8_plain(*args, pool=pool, dtype=dtype)
            torch.cuda.synchronize()
            err = max_abs(got, ref)
            worst = max(worst, err)
            line = (f"int8 conv{i + 2} {tuple(xq.shape)} -> {c.w.shape[-1]} "
                    f"pool={pool} {mode}: wgmma max|d|={err:.3e} (want 0) of "
                    f"max {float(ref.float().abs().max()):.3e}"
                    + _witness("wgmma", got, ref))
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
            ms = cuda_ms(lambda: V.conv3x3_relu_int8(*args, pool=pool,
                                                     dtype=dtype), iters=3)
            line += f"; wgmma {ms:.3f} ms; {qtxt}"
            if mode == "dynamic":
                p = cuda_ms(lambda: V.conv3x3_relu_int8_plain(
                    *args, pool=pool, dtype=dtype), iters=1, warmup=1)
                line += f"; plain {p:.2f} ms"
                tot["ms"] += ms
                tot["plain_ms"] += p
                N, H, W, Cin = xq.shape
                ops += 2 * N * H * W * 9 * Cin * c.w.shape[-1]
                nb += nbytes(*args, got)
            log(f"{line} [{card}]")
            if mode == "dynamic" and i == 2:
                _int_mm_yardstick(xq, wq, ms, card)
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
        f"{tot['ms']:.2f} ms plain "
        f"{tot['plain_ms']:.2f} ms bound {bnd['bound_ms']:.3f} ms "
        f"({bnd['bound_by']}); no PyTorch call runs an int8 conv on CUDA; "
        f"input quantizes (5 quantize_s8 launches) {tot['q_ms']:.3f} ms, "
        f"plain {tot['q_plain_ms']:.3f} ms, bound {q_bnd['bound_ms']:.3f} "
        f"ms; static scales {scales} [{card}]")

    # the whole stack as encode runs it
    stack_ms = None
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
                ms = cuda_ms(lambda: V.int8_convs(convs, xs, dtype=dtype,
                                                  act_scales=act), iters=3)
                if mode == "dynamic":
                    stack_ms = ms
                line += (f"; quantize_s8 + s8 conv, quantize fused: "
                         f"{ms:.3f} ms")
            log(f"{line} [{card}]")
    if worst != 0.0 or failures:
        raise AssertionError(f"the int8 kernels and their plain versions "
                             f"differ: max|d| {worst}, {failures}")
    return {"conv": {"max_abs_err": worst, "ms": tot["ms"],
                     "plain_ms": tot["plain_ms"], **bnd, "library_ms": None,
                     "weight_quantize_ms": w_ms, "stack_ms": stack_ms},
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


# ------------------------------------------------------- raw video, serve
# 8 lecture mp4s at the JAX package's joint fixture size
# (scripts/bench_joint_video.py:99-101), 30-120 s each, with the reference
# corpus's span layout (bench_joint_video.py:142-150: 1.22 questions a
# video, spans p50 8 s and p90 19 s): 10 questions of 4-30 s. (16 mp4s and
# 20 questions, and 64 + 32 daemon requests, until the configurations'
# phase took the time they saved.)
N_VIDEOS = 8
N_QUESTIONS = 10
VIDEO_SIZE = (320, 240)
VIDEO_FPS = 24
VIDEO_SECONDS = (30, 120)
SPAN_SECONDS = (4, 30)
SPAN_P50_P90 = (8.0, 19.0)
CAPTION_EVERY_S = 3
WAV_RATE = 44100      # staged wavs: stereo, resampled and mixed down on load
PREP_WORKERS = 4
MAX_COALESCE = 32
N_F32_VIDEOS = 4
N_SERVE = 32          # in-process daemon requests, one of them malformed
N_SERVE_PROCESS = 16  # requests to `python -m mmqg_tpu_torch.serve`
SERVE_LINGER_MS = 25.0


def alpha_vocab(n_vocab: int):
    """(vocab, index_to_word) over alphabetic words ("wdba", ...), which
    text normalisation keeps: the serving vocabulary of the raw-video
    phases (the flagship's "w123" words would be dropped from contexts)."""
    def word(i):
        return "w" + "".join(chr(97 + (i // 26 ** k) % 26) for k in (2, 1, 0))
    words = ["<pad>", "<start>", "<end>"] + [word(i)
                                             for i in range(3, n_vocab)]
    return ({w: i for i, w in enumerate(words)},
            {str(i): w for i, w in enumerate(words)})


def write_lecture_mp4(path, seconds: float, seed: int, size=VIDEO_SIZE,
                      fps: int = VIDEO_FPS) -> None:
    """A lecture-like mp4 (cv2.VideoWriter, mp4v): a moving colour
    gradient with slide text (cv2.putText) that changes every second. The
    phase fails if the host's cv2 cannot write mp4v."""
    import cv2

    w, h = size
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         size)
    if not vw.isOpened():
        raise AssertionError(f"cv2 {cv2.__version__} cannot open an mp4v "
                             "VideoWriter on this host")
    ys, xs = np.mgrid[0:h, 0:w + 256]
    wide = np.stack([(xs + ys // 2) % 256, (2 * xs + ys) % 256,
                     (xs // 2 + 2 * ys + 64 * seed) % 256],
                    axis=-1).astype(np.uint8)
    for i in range(int(seconds * fps)):
        frame = wide[:, (i * 3) % 256:(i * 3) % 256 + w].copy()
        sec = i // fps
        cv2.putText(frame, f"lecture {seed} slide {sec // 10} t={sec}s",
                    (8, 30 + (sec * 17) % (h - 40)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 2)
        vw.write(frame)
    vw.release()


def write_wav(path, pcm: np.ndarray, rate: int) -> None:
    """int16 PCM, (n,) or (n, channels), as a RIFF/WAVE file (the standard
    library's ``wave``)."""
    import wave

    pcm = pcm.reshape(len(pcm), -1).astype("<i2")
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(pcm.shape[1])
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes(pcm.tobytes())


def span_layout(rng, durations, n_questions: int,
                span_s=SPAN_SECONDS, p50_p90=SPAN_P50_P90):
    """Spans per video: every video one, ``n_questions - len(durations)``
    videos a second; lengths log-normal with the given p50 and p90,
    clipped to ``span_s`` and to the video; every third span as "M:SS"
    strings, the others as seconds."""
    n = len(durations)
    counts = np.ones(n, int)
    counts[rng.choice(n, n_questions - n, replace=False)] += 1
    sigma = np.log(p50_p90[1] / p50_p90[0]) / 1.2816
    layout, k = [], 0
    for d, c in zip(durations, counts):
        spans = []
        for _ in range(c):
            length = float(np.clip(np.exp(rng.normal(np.log(p50_p90[0]),
                                                     sigma)), *span_s))
            length = min(round(length), d - 1)
            start = int(rng.integers(0, d - length))
            span = (start, start + length)
            if k % 3 == 0:
                span = tuple(f"{v // 60}:{v % 60:02d}" for v in span)
            spans.append(span)
            k += 1
        layout.append(spans)
    return layout


def write_srt(path, seconds: float, rng, index_to_word,
              every: int = CAPTION_EVERY_S) -> None:
    """A caption every ``every`` s: 5-12 vocabulary words, capitalised."""
    n_words = len(index_to_word)
    blocks = []
    for i, t in enumerate(range(0, int(seconds), every)):
        words = [index_to_word[str(w)] for w in
                 rng.integers(3, n_words, int(rng.integers(5, 13)))]

        def ts(v):
            return f"{v // 3600:02d}:{v // 60 % 60:02d}:{v % 60:02d},000"
        blocks.append(f"{i + 1}\n{ts(t)} --> {ts(t + every)}\n"
                      + " ".join(words).capitalize() + "\n")
    path.write_text("\n".join(blocks))


def make_lectures(root, index_to_word, *, n_videos: int = N_VIDEOS,
                  n_questions: int = N_QUESTIONS, seconds=VIDEO_SECONDS,
                  size=VIDEO_SIZE, fps: int = VIDEO_FPS,
                  wav_rate: int = WAV_RATE, seed: int = SEED):
    """The raw-video phases' jobs, written into ``root`` from ``seed``:
    per video an mp4, its .srt and its staged wav (stereo tone plus noise,
    ``tones``), and the span layout. Videos are written on a thread pool
    (cv2's encoder releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor
    root = Path(root)
    rng = np.random.default_rng(seed)
    durations = [int(d) for d in rng.integers(seconds[0], seconds[1] + 1,
                                              n_videos)]
    layout = span_layout(rng, durations, n_questions)
    jobs = []
    for v, d in enumerate(durations):
        stem = root / f"lecture{v:02d}"
        write_srt(stem.with_suffix(".srt"), d, rng, index_to_word)
        left, right = (tones(rng, d * wav_rate, wav_rate) for _ in range(2))
        write_wav(stem.with_suffix(".wav"),
                  np.stack([left, right // 2 + left // 2], axis=1), wav_rate)
        jobs.append({"video_path": stem.with_suffix(".mp4"),
                     "spans": layout[v],
                     "subtitles": stem.with_suffix(".srt"),
                     "audio_path": stem.with_suffix(".wav")})
    with ThreadPoolExecutor(max_workers=8) as ex:
        for f in [ex.submit(write_lecture_mp4, j["video_path"], d, v, size,
                            fps)
                  for v, (j, d) in enumerate(zip(jobs, durations))]:
            f.result()
    return jobs, durations


def counting_dispatches(pipe):
    """Make ``pipe.generate_async`` record the size and the start
    (``time.perf_counter()``) of every batch it dispatches (``generate``
    and the video entry points go through it); returns the two lists it
    appends to."""
    sizes: List[int] = []
    starts: List[float] = []
    real = pipe.generate_async

    def generate_async(contexts, *args, **kw):
        sizes.append(len(contexts))
        starts.append(time.perf_counter())
        return real(contexts, *args, **kw)

    pipe.generate_async = generate_async
    return sizes, starts


def _reset_media_routes() -> None:
    for counts in (saliency.frame_routes, P.audio_routes):
        counts.update(dict.fromkeys(counts, 0))


def expected_frame_route() -> str:
    """The frame route the host supports: the native seek-decoder where
    libav loads, else cv2's linear decode."""
    return "native" if native.media_available() else "cv2"


def check_media_routes(what: str, preps: int, audio: str) -> None:
    """Every one of ``preps`` videos (or requests) took the frame route the
    host supports, and the audio route ``audio``."""
    frames = {r: preps if r == expected_frame_route() else 0
              for r in saliency.frame_routes}
    want_audio = {r: preps if r == audio else 0 for r in P.audio_routes}
    log(f"{what}: frame routes {saliency.frame_routes} (want {frames}), "
        f"audio routes {P.audio_routes} (want {want_audio})")
    if saliency.frame_routes != frames or P.audio_routes != want_audio:
        raise AssertionError(f"{what}: media routes")


def check_dispatch_launches(what: str, mc, dispatches: int) -> dict:
    """Each dispatched batch launched K1 4x (persistent), K2 21x, the int8
    conv 5x and quantize_s8 5x."""
    launches = _launches()
    want = dict(ZERO_LAUNCHES,
                lstm_seq=(mc.text_layers + 1) * dispatches,
                trimodal_attention=(mc.target_steps - 1) * dispatches,
                vggish_conv_int8=len(V.POOLS) * dispatches,
                quantize_s8=len(V.POOLS) * dispatches)
    log(f"{what}: {dispatches} dispatched batches launched {launches} "
        f"(want {want})")
    if launches != want or dispatches == 0:
        raise AssertionError(f"{what}: kernel launches {launches} != {want}")
    check_routes(f"{what}: K1", lstm_seq.routes, want["lstm_seq"])
    return launches


def n_equal(a, b) -> int:
    """How many questions of two per-video result lists are equal."""
    return sum(x == y for qa, qb in zip(a, b) for x, y in zip(qa, qb))


def pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def host_prep_ms(pipe, jobs) -> dict:
    """Per video, the three parts of ``_prep_video`` timed apart on this
    thread: the salient frames (the video's decode), the staged wav (read,
    mix down, resample, clip) and the subtitles' contexts."""
    from mmqg_tpu_torch.data import wav as wavio
    from mmqg_tpu_torch.data.subtitles import (extract_context,
                                               parse_subtitle_file,
                                               span_seconds)
    from mmqg_tpu_torch.data.text_prep import preprocess_text

    def sec(v):
        return float(span_seconds(v)) if isinstance(v, str) else float(v)

    parts = {"frames": [], "wav": [], "subtitles": []}
    mc = pipe.mc
    for job in jobs:
        spans = [(sec(a), sec(b)) for a, b in job["spans"]]
        t0 = time.perf_counter()
        saliency.extract_salient_frames_for_video(
            job["video_path"], [(int(a * 1000), int(b * 1000))
                                for a, b in spans],
            frame_dim=(mc.frame_size, mc.frame_size))
        t1 = time.perf_counter()
        pcm = wavio.load_mono_16k(job["audio_path"],
                                  target_rate=mc.sample_rate)
        [wavio.clip_span(pcm, mc.sample_rate, a, b) for a, b in spans]
        t2 = time.perf_counter()
        caps = parse_subtitle_file(job["subtitles"])
        [preprocess_text(extract_context(caps, a, b) or "") for a, b in spans]
        t3 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(dt * 1e3)
    return parts


def phase_video(card: str, model, jobs, durations) -> dict:
    """Lecture mp4s + subtitles + staged wavs in, questions out, on the
    flagship at full width (bf16, the int8 tower): one
    generate_from_video, generate_from_videos per video and coalesced, and
    a sequential baseline (every prep, then one generate a video), each
    with its launches and routes per dispatched batch and its media
    routes; two bad jobs; the f32 pipeline's questions identical across
    the paths. Returns what the serve phase reuses."""
    mc, params, state, _, _ = model
    vocab, i2w = alpha_vocab(mc.n_vocab)
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cuda",
                      dtype=torch.bfloat16)
    sizes, starts = counting_dispatches(pipe)
    n_q = sum(len(j["spans"]) for j in jobs)
    log(f"video: {len(jobs)} lecture mp4s ({VIDEO_SIZE[0]}x{VIDEO_SIZE[1]},"
        f" {VIDEO_FPS} fps, mp4v; {min(durations)}-{max(durations)} s, "
        f"{sum(durations)} s in all), {n_q} questions, spans "
        + ", ".join(str(s) for j in jobs[:4] for s in j["spans"])
        + f", ...; {media_probe()}")
    pipe.generate_from_videos(jobs[:4], workers=PREP_WORKERS)   # warm-up

    def drive(what, fn, preps):
        _reset_launches()
        _reset_media_routes()
        sizes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_dispatch_launches(what, mc, len(sizes))
        check_media_routes(what, preps, "wav")
        return out, wall, list(sizes)

    job = jobs[0]
    one, wall, _ = drive("video: generate_from_video", lambda: (
        pipe.generate_from_video(job["video_path"], job["spans"],
                                 subtitles=job["subtitles"],
                                 audio_path=job["audio_path"])), 1)
    if len(one) != len(job["spans"]) or not all(isinstance(q, str)
                                                for q in one):
        raise AssertionError("generate_from_video gave no question a span")
    log(f"video: generate_from_video of {job['video_path'].name} "
        f"({durations[0]} s, {len(one)} spans) {wall * 1e3:.1f} ms, e.g. "
        f"{one[0][:60]!r} [{card}]")

    split = {}

    def sequential():
        t0 = time.perf_counter()
        preps = [pipe._prep_video(j["video_path"], j["spans"],
                                  subtitles=j["subtitles"],
                                  audio_path=j["audio_path"]) for j in jobs]
        t1 = time.perf_counter()
        out = [pipe.generate(*p, row_seeds=[QGPipeline._row_seed(i, k)
                                            for k in range(len(p[0]))])
               for i, p in enumerate(preps)]
        split.update(prep=(t1 - t0) * 1e3,
                     generate=(time.perf_counter() - t1) * 1e3)
        return out, preps

    times = {}
    results = {}
    for what, fn in (
            ("sequential", sequential),
            ("per-video", lambda: pipe.generate_from_videos(
                jobs, workers=PREP_WORKERS, completion_times=times)),
            ("coalesced", lambda: pipe.generate_from_videos(
                jobs, workers=PREP_WORKERS, coalesce=True,
                max_coalesce=MAX_COALESCE, completion_times=times))):
        times.clear()
        t_submit = time.perf_counter()
        out, wall, batches = drive(f"video: {what}", fn, len(jobs))
        if what == "sequential":
            out, preps = out
        results[what] = out
        if [len(q or ()) for q in out] != [len(j["spans"]) for j in jobs]:
            raise AssertionError(f"video: {what} gave {out}")
        lat = ([(times[i] - t_submit) * 1e3 for i in range(len(jobs))]
               if times else None)
        log(f"video: {what}, {len(jobs)} videos, {n_q} questions: "
            f"{wall * 1e3:.1f} ms, {len(jobs) / wall:.2f} videos/s, "
            f"{n_q / wall:.2f} questions/s; {len(batches)} dispatched "
            f"batches of {batches}"
            + ("" if lat is None else
               f"; completion p50 {pct(lat, 50):.1f} ms, p90 "
               f"{pct(lat, 90):.1f} ms after submit")
            + ("" if what != "sequential" else
               f"; every prep {split['prep']:.1f} ms, then every generate()"
               f" {split['generate']:.1f} ms") + f" [{card}]")
    agree = [n_equal(results["per-video"], results[other])
             for other in ("sequential", "coalesced")]
    log(f"video: bf16 questions equal to per-video's: sequential "
        f"{agree[0]} of {n_q}, coalesced {agree[1]} of {n_q} (printed, not "
        "checked: bf16 rounds differently at other batch shapes)")

    parts = host_prep_ms(pipe, jobs)
    log("video: host prep per video on one thread, median (p90) ms: "
        + ", ".join(f"{k} {np.median(v):.1f} ({pct(v, 90):.1f})"
                    for k, v in parts.items())
        + f"; the frames' decode reads the whole file (cv2's linear decode"
        f" where libav is missing): {sum(parts['frames']) / sum(durations):.2f}"
        f" ms per video-second [{card}]")

    # two bad jobs among good ones: each errors alone
    with tempfile.TemporaryDirectory(prefix="mmqg_bad_") as bad_dir:
        corrupt = Path(bad_dir) / "corrupt.mp4"
        corrupt.write_bytes(jobs[1]["video_path"].read_bytes()[:300])
        mixed = [jobs[0], dict(jobs[1], video_path=corrupt), jobs[2],
                 dict(jobs[3], video_path=Path(bad_dir) / "missing.mp4")]
        errors = {}
        out = pipe.generate_from_videos(mixed, workers=PREP_WORKERS,
                                        coalesce=True, errors=errors)
    log(f"video: corrupt and missing mp4 among good jobs: errors {errors}, "
        f"results {[None if q is None else len(q) for q in out]}")
    if (set(errors) != {1, 3} or out[1] is not None or out[3] is not None
            or [len(q) for q in (out[0], out[2])]
            != [len(jobs[0]["spans"]), len(jobs[2]["spans"])]):
        raise AssertionError("video: bad jobs were not isolated")

    # f32: the same questions whichever path served them
    pick = sorted(range(len(jobs)), key=lambda i: (-len(jobs[i]["spans"]),
                                                   durations[i]))
    few = [jobs[i] for i in sorted(pick[:N_F32_VIDEOS])]
    pipe32 = QGPipeline(None, mc, params, state, vocab, i2w, device="cuda",
                        dtype=torch.float32)
    for served, name in ((pipe32, "f32"), (pipe, "bf16")):
        kw = dict(workers=PREP_WORKERS)
        paths = {
            "generate_from_video": [served.generate_from_video(
                j["video_path"], j["spans"], subtitles=j["subtitles"],
                audio_path=j["audio_path"]) for j in few],
            "per-video": served.generate_from_videos(few, **kw),
            "coalesced": served.generate_from_videos(
                few, coalesce=True, max_coalesce=MAX_COALESCE, **kw),
            "per-video sampling": served.generate_from_videos(
                few, strategy="sampling", seed=STRATEGY_SEED, **kw),
            "coalesced sampling": served.generate_from_videos(
                few, strategy="sampling", seed=STRATEGY_SEED, coalesce=True,
                max_coalesce=MAX_COALESCE, **kw)}
        refs = {k: paths["per-video sampling" if "sampling" in k
                         else "per-video"] for k in paths}
        log(f"video: {name}, {len(few)} videos, "
            f"{sum(len(j['spans']) for j in few)} questions, equal to the "
            f"per-video path's: "
            f"{ {k: n_equal(v, refs[k]) for k, v in paths.items()} }")
        if name == "f32" and any(v != refs[k] for k, v in paths.items()):
            raise AssertionError(f"video: f32 paths disagree: {paths}")
    return {"pipe": pipe, "sizes": sizes, "starts": starts, "preps": preps,
            "jobs": jobs}


def serve_requests(jobs, preps, root, n: int, sample_rate: int):
    """``n`` daemon request lines over the video phase's spans: staged
    ones (the span's salient frames as .npy and its 16 kHz clip as a wav,
    the reference's artifact layout) and raw-video ones (video + span +
    subtitles) in turns, one malformed line in the middle. Returns (lines,
    ids of the good requests)."""
    spans = [(i, k) for i, j in enumerate(jobs) for k in range(len(j["spans"]))]
    lines, ids = [], []
    for r in range(n - 1):
        i, k = spans[r % len(spans)]
        if r % 2 == 0:
            frames_npy = Path(root) / f"frames_{i}_{k}.npy"
            audio_wav = Path(root) / f"clip_{i}_{k}.wav"
            if not frames_npy.exists():
                np.save(frames_npy, preps[i][1][k])
                write_wav(audio_wav, preps[i][2][k], sample_rate)
            req = {"id": r, "context": preps[i][0][k],
                   "frames_npy": str(frames_npy), "audio_wav": str(audio_wav)}
        else:
            req = {"id": r, "video": str(jobs[i]["video_path"]),
                   "span": list(jobs[i]["spans"][k]),
                   "subtitles": str(jobs[i]["subtitles"])}
        lines.append(json.dumps(req))
        ids.append(r)
    lines.insert(n // 2, '{"id": "malformed", "context": ')
    return "\n".join(lines) + "\n", ids


def check_answers(what: str, responses, ids, malformed: int) -> None:
    """Every id answered exactly once with a question, and ``malformed``
    responses with an error and no id."""
    answered = sorted(r["id"] for r in responses if "question" in r)
    errors = [r for r in responses if "error" in r]
    if (answered != sorted(ids) or len(errors) != malformed
            or any(r["id"] is not None for r in errors)
            or len(responses) != len(ids) + malformed):
        raise AssertionError(f"{what}: answered {answered}, errors {errors}")


def write_checkpoint(root, model, **config_kw):
    """A config.json, vocabulary files and a ``best`` checkpoint of
    ``model`` (the port's ``save_checkpoint``) under ``root``; returns the
    config's path. ``config_kw``: the Config fields that describe the
    model (none for the flagship: the defaults)."""
    from mmqg_tpu_torch import checkpoint as ckpt
    from mmqg_tpu_torch.config import Config

    mc, params, state, _, _ = model
    vocab, i2w = alpha_vocab(mc.n_vocab)
    root = Path(root)
    config = Config(output_path=root / "results", data_path=root / "data",
                    **config_kw)
    config.data_path.mkdir(parents=True, exist_ok=True)
    with open(config.vocab_file, "w") as f:
        json.dump(vocab, f)
    with open(config.index_to_word_file, "w") as f:
        json.dump(i2w, f)
    if qg_model.ModelConfig.from_config(config, n_vocab=len(vocab)) != mc:
        raise AssertionError("the config does not describe the model")
    ckpt.save_checkpoint(config.checkpoint_dir, "best",
                         {"params": params, "model_state": state,
                          "step": np.zeros((), np.int32)})
    return config.save(root / "config.json")


def phase_serve(card: str, model, video, root) -> None:
    """The JSONL daemon on the flagship: serve() in process on N_SERVE
    requests (staged and raw-video, one malformed), its launches per
    dispatched batch; then ``python -m mmqg_tpu_torch.serve`` as a process,
    with no --device, on N_SERVE_PROCESS requests."""
    from mmqg_tpu_torch import serve as S

    pipe, sizes, starts = video["pipe"], video["sizes"], video["starts"]
    mc = pipe.mc
    text, ids = serve_requests(video["jobs"], video["preps"], root, N_SERVE,
                               mc.sample_rate)
    out = io.StringIO()
    prepped: List[float] = []
    real_load = S._load_media

    def load(req, p):   # when each request's media is ready
        media = real_load(req, p)
        prepped.append(time.perf_counter())
        return media

    _reset_launches()
    _reset_media_routes()
    sizes.clear()
    starts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(S, "_load_media", load):
        n = S.serve(pipe, strategy="greedy", max_batch=MAX_COALESCE,
                    linger_ms=SERVE_LINGER_MS, inp=io.StringIO(text),
                    out=out, prep_workers=PREP_WORKERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_dispatch_launches("serve", mc, len(sizes))
    responses = [json.loads(line) for line in out.getvalue().splitlines()]
    check_answers("serve", responses, ids, 1)
    lat = [r["latency_ms"] for r in responses if "question" in r]
    log(f"serve: in process, {n} requests ({len(ids)} good: staged and "
        f"raw-video in turns; 1 malformed, answered with an error), "
        f"max_batch {MAX_COALESCE}, linger {SERVE_LINGER_MS} ms: "
        f"{wall * 1e3:.1f} ms, {len(ids) / wall:.2f} requests/s, latency "
        f"p10 {pct(lat, 10):.1f} ms, p50 {pct(lat, 50):.1f} ms, p90 "
        f"{pct(lat, 90):.1f} ms (all read at once); dispatched "
        f"batches of {sizes}; frame routes {saliency.frame_routes}, audio "
        f"routes {P.audio_routes} [{card}]")
    ready = sorted((t - t0) * 1e3 for t in prepped)
    log(f"serve: timeline, ms from the start: preps ready first "
        f"{ready[0]:.0f}, half {ready[len(ready) // 2]:.0f}, last "
        f"{ready[-1]:.0f}; batches dispatched at "
        + ", ".join(f"{(t - t0) * 1e3:.0f}" for t in starts)
        + f"; first answer {min(lat):.0f} [{card}]")

    config_path = write_checkpoint(root, model)
    text, ids = serve_requests(video["jobs"], video["preps"], root,
                               N_SERVE_PROCESS + 1, mc.sample_rate)
    text = "".join(line + "\n" for line in text.splitlines()
                   if "malformed" not in line)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mmqg_tpu_torch.serve", "-c",
         str(config_path), "--best", "-s", "greedy"], input=text,
        capture_output=True, text=True, timeout=600, cwd=REPO)
    wall = time.perf_counter() - t0
    responses = [json.loads(line) for line in proc.stdout.splitlines()]
    ready = [line for line in proc.stderr.splitlines()
             if line.startswith("ready")]
    log(f"serve: `python -m mmqg_tpu_torch.serve -c <flagship config> "
        f"--best -s greedy` (no --device) on {len(ids)} requests: exit "
        f"{proc.returncode}, {len(responses)} responses, {ready[:1]}, "
        f"{wall:.1f} s wall (start, checkpoint load and kernel library "
        f"included) [{card}]")
    if proc.returncode != 0 or not ready:
        raise AssertionError(f"serve process failed:\n{proc.stderr[-4000:]}")
    check_answers("serve process", responses, ids, 0)


# ------------------------------------------------------------ configs

# the configurations of phase 16 beside the flagship: (mode, decoder,
# video_encoder) at the flagship's widths, R(2+1)D-18 at torchvision's
# published widths with 512-d trunk features (video_hidden_dim 512: no head)
CONFIG_CASES = (("trimodal", "attn", "resnet"),
                ("text_video", "non_attn", "conv_lstm"),
                ("text", "attn", "conv_lstm"))
# the Video Swin-B configuration (the benchmark's trimodal_attn_swin3d_b):
# swin3d_b at torchvision's widths with its 1024-wide memory over frames of
# 224 x 224, serving only, so it stays out of the phase's training and
# card vs CPU checks
SWIN_CASE = ("trimodal", "attn", "swin3d")
CONFIG_STRATEGIES = {CONFIG_CASES[0]: ("greedy", "beam"),
                     CONFIG_CASES[1]: ("greedy", "sampling", "beam"),
                     CONFIG_CASES[2]: ("greedy",),
                     SWIN_CASE: ("greedy", "beam")}
SWIN_FRAME = 224
RESNET_TRAIN_B = 16
NON_ATTN_TRAIN_B = 32
# the batchnorm epilogue's launches in one inference trunk (two in the stem,
# four a block) and the clips it is checked at: the serving cell's bucket
EPILOGUES_A_TRUNK = 34
EPILOGUE_CLIPS = (32, 101, 112, 112, 3)
# the frames cap of the card vs CPU check of R(2+1)D (the CPU runs the
# trunk at this many frames a clip, both devices pinned to it)
CPU_RESNET_FRAMES = 16
RESIZE_REQUESTS = 8
RESIZE_FRAME = (240, 320)   # H x W: 320 x 240 frames, resized to 149 x 112
# remat on vs off, bf16 on the card: the worst leaf's |on - off| / max|off|
# may not exceed twice the same step's run-to-run spread (cuDNN's backward
# algorithms and the embedding backward accumulate with atomics), and at
# least this; a dropped term or a second batchnorm update is O(1)
REMAT_BAND = 5e-2
# gradient accumulation, f32: two accumulated half batches against the
# whole batch, every leaf within ACCUM_RTOL of the largest gradient and the
# whole gradient within ACCUM_NORM_TOL in norm. A leaf's own max is no
# scale here: a small leaf (the embedding rows, the text attention) is a
# sum of cancelling terms whose f32 order the split changes (1e-3 of its
# max on the CPU at hidden 64, where |d| / |g| over all leaves is 2.2e-7)
ACCUM_RTOL, ACCUM_NORM_TOL = 1e-4, 1e-5


def config_name(case) -> str:
    mode, dec, venc = case
    return f"{mode}-{dec}" + ("" if mode == "text" else f"-{venc}")


@functools.lru_cache(maxsize=None)
def config_model(case):
    """(mc, params, state, vocab, i2w) of a configuration at the
    flagship's widths, random weights from SEED (made once: R(2+1)D-18's
    31M weights take seconds of the host's random draws)."""
    mode, dec, venc = case
    swin = (dict(video_hidden_dim=qg_model.SWIN_WIDTH, frame_size=SWIN_FRAME,
                 vid_mean=VS.MEAN, vid_std=VS.STD)
            if venc == "swin3d" else {})
    mc = ModelConfig(n_vocab=N_VOCAB, mode=mode, decoder=dec,
                     video_encoder=venc, **swin)
    params, state = init_params(mc, SEED)
    return (mc, params, state) + synthetic_vocab()


def config_want(mc) -> dict:
    """The launches of one greedy or beam generate() of ``mc``: K1 once a
    text layer and once for the conv-LSTM's video layer, K2 once a decode
    step with the attention decoder, the int8 tower in trimodal."""
    video_lstm = mc.mode != "text" and mc.video_encoder == "conv_lstm"
    int8 = len(V.POOLS) if mc.mode == "trimodal" else 0
    return dict(ZERO_LAUNCHES, lstm_seq=mc.text_layers + int(video_lstm),
                trimodal_attention=(mc.target_steps - 1
                                    if mc.decoder == "attn" else 0),
                vggish_conv_int8=int8, quantize_s8=int8)


def check_config_launches(what: str, mc, launches: dict) -> None:
    want = config_want(mc)
    log(f"{what}: launched {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} != {want}")
    if want["lstm_seq"]:
        check_routes(f"{what}: K1", lstm_seq.routes, want["lstm_seq"])


def _peak_mb(fn):
    """(result, peak device memory in MB allocated while ``fn()`` ran)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**20


def _config_serving(card: str, case, req) -> dict:
    """One configuration's serving on the card: each strategy's launches
    per generate() (K2's rows for beam), encode and decode wall; for
    R(2+1)D the trunk's device time and the encode's peak memory."""
    model = config_model(case)
    mc, params, state, vocab, i2w = model
    name = config_name(case)
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cuda",
                      dtype=torch.bfloat16)
    pipe.generate(*req)                      # warm-up: cuDNN plans, caches
    torch.cuda.synchronize()
    launches, epilogues = {}, {}
    real = decoder_module.trimodal_attention
    for strategy in CONFIG_STRATEGIES[case]:
        k2_rows = []

        def counting(w_t, b, q, *args, **kw):
            k2_rows.append(q.shape[0])
            return real(w_t, b, q, *args, **kw)

        if strategy == "beam":
            pipe.generate(*req, strategy="beam", beam_size=BEAM_SIZE)
        _reset_launches()
        trunks = VR.convs["trunks"]
        swin_before = dict(VS.windows)
        wa_before = WA.window_attention.launches
        with mock.patch.object(decoder_module, "trimodal_attention",
                               counting):
            questions = pipe.generate(*req, strategy=strategy,
                                      beam_size=BEAM_SIZE, seed=STRATEGY_SEED)
            torch.cuda.synchronize()
        launches[strategy] = _launches()
        check_config_launches(f"configs: {name} {strategy} generate() of "
                              f"{N_REQUESTS}", mc, launches[strategy])
        epilogues[strategy] = check_epilogue_launches(
            f"configs: {name} {strategy} generate()", mc,
            VR.convs["trunks"] - trunks)
        check_swin_trunks(f"configs: {name} {strategy} generate()", mc,
                          swin_before)
        check_window_attention_launches(
            f"configs: {name} {strategy} generate()", mc, wa_before)
        rows = N_REQUESTS * (BEAM_SIZE if strategy == "beam" else 1)
        if k2_rows and set(k2_rows) != {rows}:
            raise AssertionError(f"{name} {strategy}: K2 rows {k2_rows}")
        if len(questions) != N_REQUESTS or not all(
                isinstance(q, str) for q in questions):
            raise AssertionError(f"{name}: not one question a request")
    qps, wall, enc, dec, caps = _time_serving(pipe, req)
    out = {"launches": launches, "epilogue_launches": epilogues,
           "encode_ms": enc, "decode_ms": dec}
    log(f"configs: {name} greedy batch {N_REQUESTS} bf16: {qps:.1f} "
        f"questions/s ({wall:.1f} ms generate()); encode {enc:.2f} ms, "
        f"decode {dec:.2f} ms (medians of 3; caps {caps}) [{card}]")
    if mc.video_encoder == "resnet" and mc.mode != "text":
        host = pipe._pack(*req)
        batch = pipe._to_device(host)
        fcap = caps["frames_cap"]
        prepared = frontends.prepare_frames(
            batch["frames"][:, :fcap], size=mc.frame_size,
            mean=mc.vid_mean, std=mc.vid_std)
        with torch.no_grad():
            wall_ms, busy, prof = _device_busy_ms(
                lambda: pipe.model.video_enc.temporal(prepared,
                                                      dtype=torch.bfloat16))
        if busy is not None:
            top = prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=10)
            for line in top.splitlines():
                log(f"  {line}")
        _conv_layouts(card, pipe.model.video_enc, prepared.shape[:2])
        out["bn_epilogue"] = _bn_epilogue_check(card, pipe.model.video_enc)
        with torch.no_grad():
            _, peak = _peak_mb(lambda: DEC.encode(
                pipe.model, mc, batch, dtype=torch.bfloat16, **caps))
        out.update(resnet_ms=busy, resnet_wall_ms=wall_ms, encode_peak_mb=peak)
        log(f"configs: {name} R(2+1)D-18 trunk on {tuple(prepared.shape)} "
            f"bf16: device "
            + ("not measured" if busy is None else f"{busy:.2f} ms")
            + f" (wall {wall_ms:.2f} ms, one profiled call); encode peak "
            f"memory {peak:.0f} MB (torch.cuda.max_memory_allocated) [{card}]")
    elif mc.video_encoder == "swin3d":
        host = pipe._pack(*req)
        batch = pipe._to_device(host)
        with torch.no_grad():
            _, peak = _peak_mb(lambda: DEC.encode(
                pipe.model, mc, batch, dtype=torch.bfloat16, **caps))
        out["encode_peak_mb"] = peak
        log(f"configs: {name} Swin-B encode of {N_REQUESTS} clips at "
            f"{mc.frame_size} px, frames bucket {caps['frames_cap']}: peak "
            f"memory {peak:.0f} MB (torch.cuda.max_memory_allocated) "
            f"[{card}]")
    out["model"], out["pipe"] = model, pipe
    return out


def check_swin_trunks(what: str, mc, before: dict) -> None:
    """One Swin-B trunk a generate() of the swin3d configuration, its 24
    window attentions each over at least one window holding a live token;
    no trunk elsewhere."""
    got = {k: VS.windows[k] - before[k] for k in before}
    swin = mc.video_encoder == "swin3d" and mc.mode != "text"
    want = {"trunks": 1, "attn_calls": 24} if swin else {"trunks": 0,
                                                         "attn_calls": 0}
    log(f"{what}: video_swin.windows moved by {got} (want {want})")
    if ({k: got[k] for k in want} != want
            or (swin and not 0 < got["live_windows"] <= got["windows"])):
        raise AssertionError(f"{what}: video_swin.windows {got}, want "
                             f"{want}")


def check_window_attention_launches(what: str, mc, before: int) -> None:
    """The window attention kernel's launches since ``before``: 24 a
    generate() of the swin3d configuration (one trunk), none elsewhere."""
    swin = mc.video_encoder == "swin3d" and mc.mode != "text"
    got = WA.window_attention.launches - before
    want = WIN_BLOCKS if swin else 0
    log(f"{what}: window_attention launched {got} (want {want})")
    if got != want:
        raise AssertionError(f"{what}: window_attention launched {got}, "
                             f"want {want}")


# the window attention at the Swin cell's bucket: 32 clips of 101 frames
# (51 temporal tokens) at 224 px; each stage's (C, heads, H = W, blocks)
WIN_BLOCKS = 24
WIN_CLIPS, WIN_FRAMES = 32, 101
WIN_STAGES = ((128, 4, 56, 2), (256, 8, 28, 2), (512, 16, 14, 18),
              (1024, 32, 7, 2))


def _win_lives(gen) -> torch.Tensor:
    """Ragged live temporal tokens of WIN_CLIPS clips of 20-101 frames,
    one at the bucket's 101."""
    frames = torch.randint(20, WIN_FRAMES + 1, (WIN_CLIPS,), generator=gen)
    frames[0] = WIN_FRAMES
    return VS.temporal_out_len(frames).cuda()


def _win_inputs(stage, shifted, dtype, lives, gen):
    """(qkv, table, rows, grid, win, shift, live windows) of one block."""
    C, heads, side, _ = stage
    T = int(VS.temporal_out_len(WIN_FRAMES))
    size = (T, side, side)
    win, shift = VS.window_and_shift(size, shifted)
    grid = tuple(-(-n // w) for n, w in zip(size, win))
    rows = VS.Rows(lives, T)
    n_win = WIN_CLIPS * grid[0] * grid[1] * grid[2]
    qkv = torch.randn((n_win, win[0] * win[1] * win[2], 3, heads, WA.HEAD),
                      generator=gen, device="cuda").to(dtype)
    table = torch.randn((WA.TABLE, heads), generator=gen, device="cuda")
    live = rows.live_rows[shift[0]] * grid[1] * grid[2]
    return qkv, table, rows, grid, win, shift, live


def _live_queries(rows, grid, win, shift) -> torch.Tensor:
    """(windows, N): True at each window token whose rolled temporal
    position lies before its clip's live length."""
    nt, nh, nw = grid
    t = (torch.arange(nt)[:, None] * win[0] + torch.arange(win[0])
         + shift[0]) % (nt * win[0])
    live = t[None].to(rows.live.device) < rows.live[:, None, None]
    return live[:, :, None].expand(-1, -1, nh * nw, -1).repeat_interleave(
        win[1] * win[2], -1).reshape(-1, math.prod(win))


def _ms_or_not(ms) -> str:
    return "not measured" if ms is None else f"{ms:.2f} ms"


def _device_total_ms(fn, names, iters: int = 3):
    """Device ms a call of ``fn()`` spends in kernels whose names contain
    one of ``names`` (torch.profiler, summed over the call's launches), or
    None where the profiler kept no such record (after many profiled
    phases in one process it drops records)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start
                for e in prof.events() if e.device_type == DeviceType.CUDA
                and any(n in e.name for n in names))
    return total / iters / 1e3 if total else None


def phase_window_attention(card: str) -> dict:
    """The window attention kernel against its plain PyTorch version on
    the card, at each Swin-B stage's (C, heads) over the cell's bucket
    (B=32, 101 frames, ragged lives), unshifted and shifted, bf16 and
    float32: the windows of padding alone exactly zero, the live tokens
    within two bf16 steps (bf16) or 1e-5 (float32) of max |plain|; in
    bf16 the kernel's time (CUDA events: one launch of milliseconds)
    against its bound (the live windows' products at the bf16 peak, or
    their q, k, v and out and the table at the memory rate), the plain
    version's and, as the yardstick only, library_ms: the device time of
    PyTorch's fused attention (cuDNN's) inside the plain version. Then
    one bf16 Swin-B trunk over the bucket, with the kernel and with the
    plain version: its time, launches and how far apart their outputs
    lie."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 11)
    cgen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    lives = _win_lives(gen)
    rows_out, total = [], {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0,
                           "library_ms": 0.0}
    for stage in WIN_STAGES:
        for shifted in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                qkv, table, rows, grid, win, shift, live = _win_inputs(
                    stage, shifted, dtype, lives, cgen)
                args = (qkv, table, rows, grid, win, shift)
                before = WA.window_attention.launches
                with torch.no_grad():
                    got = WA.window_attention(*args)
                    want = WA.window_attention_plain(*args)
                torch.cuda.synchronize()
                if WA.window_attention.launches != before + 1:
                    raise AssertionError("window_attention: not one launch")
                dead = want.flatten(1).abs().amax(1) == 0
                zeros = got.flatten(1).abs().amax(1) == 0
                # at the live tokens: cuDNN's bf16 attention leaves a
                # padded token whose live keys all lie in another region
                # inexact, and no live token reads it
                live_q = _live_queries(rows, grid, win, shift)
                err = max_abs(got[live_q], want[live_q]) / float(
                    want[live_q].abs().max())
                tol = 2 ** -6 if dtype == torch.bfloat16 else 1e-5
                name = (f"C {stage[0]} heads {stage[1]} {stage[2]}x"
                        f"{stage[2]} {'shifted' if shifted else 'unshifted'}"
                        f" {str(dtype).split('.')[-1]}")
                if not torch.equal(dead, zeros) or not err <= tol:
                    raise AssertionError(f"window_attention {name}: "
                                         f"max|d| {err:.3g} of max|plain| "
                                         f"(tol {tol:g}), zero windows "
                                         f"{int(zeros.sum())} vs "
                                         f"{int(dead.sum())}")
                row = {"stage": list(stage), "shifted": shifted,
                       "dtype": str(dtype).split(".")[-1],
                       "windows": qkv.shape[0], "live_windows": live,
                       "dead_windows": int(dead.sum()), "max_rel_err": err}
                del got, want
                if dtype == torch.bfloat16:
                    N, C = qkv.shape[1], stage[0]
                    ops = 2.0 * live * 2 * N * N * C
                    moved = 2 * 4 * live * N * C + 4 * WA.TABLE * stage[1]
                    with torch.no_grad():
                        ms = cuda_ms(lambda: WA.window_attention(*args),
                                     iters=10)
                        plain_ms = cuda_ms(
                            lambda: WA.window_attention_plain(*args),
                            iters=3, warmup=1)
                        lib_ms = _device_total_ms(
                            lambda: WA.window_attention_plain(*args),
                            ["sdpa", "flash", "fmha", "Attention"], iters=2)
                    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               **bound(ops, moved, dtype))
                    for k in total:   # half the stage's blocks shifted
                        total[k] = (None if row[k] is None or total[k] is None
                                    else total[k] + row[k] * stage[3] / 2)
                    log(f"  window_attention {name}: max|d| {err:.2e} of "
                        f"max|plain|, {row['dead_windows']} of "
                        f"{row['windows']} windows padding alone; kernel "
                        f"{ms:.3f} ms, bound {row['bound_ms']:.3f} ms "
                        f"({row['bound_by']}), plain {plain_ms:.2f} ms, "
                        f"library {_ms_or_not(lib_ms)} [{card}]")
                else:
                    with torch.no_grad():
                        row["ms"] = cuda_ms(
                            lambda: WA.window_attention(*args), iters=1,
                            warmup=1)
                    log(f"  window_attention {name}: max|d| {err:.2e} of "
                        f"max|plain|; kernel {row['ms']:.2f} ms [{card}]")
                rows_out.append(row)
                del qkv, table, args
                torch.cuda.empty_cache()
    log(f"window_attention: a trunk's {WIN_BLOCKS} blocks at B={WIN_CLIPS}, "
        f"{WIN_FRAMES} frames (depths 2, 2, 18, 2): kernel "
        f"{total['ms']:.2f} ms, bound {total['bound_ms']:.2f} ms, plain "
        f"{total['plain_ms']:.2f} ms, library "
        f"{_ms_or_not(total['library_ms'])} [{card}]")
    trunk = _win_trunk(card, lives)
    return {"calls": rows_out, "trunk_blocks": total, "trunk": trunk}


def _win_trunk(card: str, lives) -> dict:
    """One bf16 swin3d_b trunk at random weights over the bucket's clips,
    with the kernel and with the plain version in the kernel's place:
    CUDA events over each (the trunk is device-bound), launches, the
    kernel trunk's top device ops (profiler) and how far apart the two
    trunks' live memory steps lie."""
    from torch.profiler import ProfilerActivity, profile

    params, _ = VS.init_numpy(np.random.RandomState(SEED))
    model = VS.build(params, lambda a: torch.tensor(a, device="cuda"))
    clips = torch.randn((WIN_CLIPS, WIN_FRAMES, 224, 224, 3),
                        generator=torch.Generator(device="cuda").manual_seed(
                            SEED + 12), device="cuda")
    out = {}
    with torch.no_grad():
        for route in ("kernel", "plain"):
            with (mock.patch.object(VS, "window_attention",
                                    WA.window_attention_plain)
                  if route == "plain" else contextlib.nullcontext()):
                out[route] = model.temporal(clips, lives)     # warm-up
                before = WA.window_attention.launches
                ms = cuda_ms(lambda: model.temporal(clips, lives), iters=2,
                             warmup=0)
                launches = WA.window_attention.launches - before
                if route == "kernel":
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        model.temporal(clips, lives)
                        torch.cuda.synchronize()
                    for line in prof.key_averages().table(
                            sort_by="self_device_time_total",
                            row_limit=8).splitlines():
                        log(f"  {line}")
            want = 2 * WIN_BLOCKS if route == "kernel" else 0
            if launches != want:
                raise AssertionError(f"trunk ({route}): window_attention "
                                     f"launched {launches} in 2 trunks, "
                                     f"want {want}")
            out[f"{route}_ms"] = ms
            log(f"window_attention: swin3d_b trunk bf16 on "
                f"{tuple(clips.shape)} with the {route}: {ms:.2f} ms (CUDA "
                f"events), window_attention launches {launches // 2} a trunk"
                f" [{card}]")
    keep = torch.arange(out["kernel"].shape[1], device="cuda")[None] < \
        lives[:, None]
    gap = float((out["kernel"] - out["plain"])[keep].abs().max()
                / out["plain"][keep].abs().max())
    log(f"window_attention: the two trunks' live memory steps differ by "
        f"{gap:.2e} of their max [{card}]")
    del model, clips
    torch.cuda.empty_cache()
    return {"kernel_ms": out["kernel_ms"], "plain_ms": out["plain_ms"],
            "live_gap": gap}


def _resnet_serves(mc) -> bool:
    return mc.video_encoder == "resnet" and mc.mode != "text"


def check_epilogue_launches(what: str, mc, trunks: int) -> int:
    """The batchnorm epilogue's launches since ``_reset_launches``: 34 a
    trunk of an R(2+1)D configuration (``trunks`` >= 1), none elsewhere."""
    got = BNE.bn_epilogue.launches
    want = EPILOGUES_A_TRUNK * trunks if _resnet_serves(mc) else 0
    log(f"{what}: {trunks} R(2+1)D trunks, bn_epilogue launched {got} "
        f"(want {want})")
    if got != want or (_resnet_serves(mc) and trunks < 1):
        raise AssertionError(f"{what}: bn_epilogue launches {got} != {want}"
                             f" ({trunks} trunks)")
    return got


def _bits(t):
    """A bf16 or f32 tensor's bits, so -0.0 and 0.0 differ."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _epilogue_kind(kw) -> str:
    if kw.get("residual") is None:
        return "none"
    return "identity" if kw.get("res_a") is None else "down"


def _epilogue_inputs(shape, kind: str, gen):
    """Random bf16 conv outputs of ``shape`` with f32 scales and shifts,
    and the shortcut of ``kind`` (an f32 tensor, or a second conv output
    with its own scale and shift)."""
    C = shape[-1]

    def act(dtype):
        return torch.randn(shape, generator=gen, device="cuda").mul_(3
                                                                     ).to(dtype)

    def scale_shift():
        return (torch.rand(C, generator=gen, device="cuda") + 0.5,
                torch.randn(C, generator=gen, device="cuda"))

    x = act(torch.bfloat16)
    a, b = scale_shift()
    kw = {}
    if kind == "identity":
        kw["residual"] = act(torch.float32)
    elif kind == "down":
        ra, rb = scale_shift()
        kw.update(residual=act(torch.bfloat16), res_a=ra, res_b=rb)
    return x, a, b, kw


def _bn_epilogue_check(card: str, venc) -> dict:
    """The batchnorm epilogue kernel at the shapes R(2+1)D-18's bf16
    inference trunk gives it at the serving cell's bucket (B=32, 101
    frames of 112 px): one trunk's 34 calls recorded; for each distinct
    call (shape, shortcut, outputs) the kernel against its plain PyTorch
    version on the same card tensors, bit for bit, each output; the
    kernel's device time (profiler), the plain version's (CUDA events) and
    the bound of its bytes at the memory rate; summed over the trunk, and
    alone at stage 1's 144-wide midplanes."""
    calls = []
    real = BNE.bn_epilogue

    def recording(x, a, b, **kw):
        calls.append((tuple(x.shape), _epilogue_kind(kw),
                      kw.get("relu", False), kw.get("cast") is not None,
                      kw.get("keep", True)))
        return real(x, a, b, **kw)

    # the wrapper counts its launches on the name it is patched under
    recording.launches = 0
    clips = torch.rand(EPILOGUE_CLIPS, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    with torch.no_grad(), mock.patch.object(BNE, "bn_epilogue", recording):
        venc.temporal(clips, dtype=torch.bfloat16)
        torch.cuda.synchronize()
    del clips
    if len(calls) != EPILOGUES_A_TRUNK:
        raise AssertionError(f"bn_epilogue: {len(calls)} calls a trunk")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows, total = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    stage1 = None
    for sig in sorted(set(calls)):
        shape, kind, relu, cast, keep = sig
        n = calls.count(sig)
        x, a, b, kw = _epilogue_inputs(shape, kind, gen)
        kw.update(relu=relu, cast=torch.bfloat16 if cast else None,
                  keep=keep)
        with torch.no_grad():
            got = real(x, a, b, **kw)
            want = BNE.bn_epilogue_plain(x, a, b, **kw)
            for g, w in zip(got, want):
                if (g is None) != (w is None) or (w is not None and not (
                        g.dtype == w.dtype and torch.equal(_bits(g),
                                                           _bits(w)))):
                    raise AssertionError(f"bn_epilogue {sig}: the kernel "
                                         f"is not its plain version")
            outs = [t for t in got if t is not None]
            moved = nbytes(x, a, b, *[t for t in kw.values()
                                      if isinstance(t, torch.Tensor)], *outs)
            del got, want, outs
            ms = device_ms(lambda: real(x, a, b, **kw),
                           ["bn_epilogue_kernel"], iters=20)
            plain_ms = cuda_ms(lambda: BNE.bn_epilogue_plain(x, a, b, **kw),
                               iters=5, warmup=1)
        row = {"shape": list(shape), "shortcut": kind, "relu": relu,
               "out": ("bf16+f32" if cast and keep else
                       "bf16" if cast else "f32"),
               "calls": n, "ms": ms, "plain_ms": plain_ms,
               **bound(0, moved, torch.bfloat16)}
        rows.append(row)
        for k in total:
            total[k] += n * row[k]
        if shape[-1] == 144 and kind == "none" and stage1 is None:
            stage1 = row
        del x, a, b, kw
        torch.cuda.empty_cache()
        log(f"  bn_epilogue {tuple(shape)} {kind} {row['out']} x{n}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{row['bound_ms']:.3f} ms ({moved / 1e9:.3f} GB)")
    log(f"configs: bn_epilogue over one bf16 trunk on {EPILOGUE_CLIPS}: "
        f"{len(rows)} distinct calls, each bit for bit with its plain "
        f"version; kernel {total['ms']:.2f} ms, plain "
        f"{total['plain_ms']:.2f} ms, bound {total['bound_ms']:.2f} ms in "
        f"its {EPILOGUES_A_TRUNK} calls; at stage 1's "
        f"{tuple(stage1['shape'])}: kernel {stage1['ms']:.3f} ms, plain "
        f"{stage1['plain_ms']:.3f} ms, bound {stage1['bound_ms']:.3f} ms "
        f"[{card}]")
    return {"max_abs_err": 0.0, "ms": stage1["ms"],
            "plain_ms": stage1["plain_ms"], "bound_ms": stage1["bound_ms"],
            "bound_by": stage1["bound_by"], "at": stage1["shape"],
            "trunk": {"calls": EPILOGUES_A_TRUNK, **total}, "calls": rows}


def _conv_layouts(card: str, venc, bt) -> None:
    """Stage 1's first spatial conv (64 -> 144, 1 x 3 x 3) at the trunk's
    batch, bf16, in the port's channels-last layout and in contiguous
    NCDHW (CUDA events; a yardstick for the trunk's layout)."""
    conv = venc.stages[0][0].conv1.spatial
    w = conv.w.to(torch.bfloat16).permute(4, 3, 0, 1, 2)
    x = torch.randn((bt[0], bt[1], 56, 56, 64), device="cuda",
                    dtype=torch.bfloat16)
    cl = x.permute(0, 4, 1, 2, 3)
    wl = w.contiguous(memory_format=torch.channels_last_3d)
    nc = cl.contiguous()
    wc = w.contiguous()
    run = {"channels_last_3d": lambda: torch.nn.functional.conv3d(
               cl, wl, padding=(0, 1, 1)),
           "ncdhw": lambda: torch.nn.functional.conv3d(nc, wc,
                                                        padding=(0, 1, 1))}
    with torch.no_grad():
        times = in_turns(run, iters=3)
    flops = 2 * x.numel() * 144 * 9
    log(f"configs: stage 1 spatial conv {tuple(x.shape)} -> 144, bf16, "
        f"cuDNN by layout: " + fmt_turns(times) + f"; {flops / 1e12:.2f} "
        f"TFLOP, {flops / 989e12 * 1e3:.2f} ms at the bf16 peak [{card}]")


def _resize_path(card: str, serving: dict) -> dict:
    """320 x 240 uint8 frames through qg_model.encode with R(2+1)D: the
    resize (frontends.prepare_frames) on the card, its time and the
    encode's, the card's resize against the CPU's."""
    pipe = serving["pipe"]
    mc = pipe.mc
    rng = np.random.RandomState(SEED + 9)
    H, W = RESIZE_FRAME
    req = requests(mc, RESIZE_REQUESTS, SEED + 2)
    lens = [min(len(f), mc.av_max_length) for f in req[1]]
    T = max(lens)
    frames = torch.from_numpy(rng.randint(0, 256, (RESIZE_REQUESTS, T, H, W,
                                                   3), np.uint8)).cuda()
    host = pipe._pack(req[0], None, req[2])
    batch = pipe._to_device(host)
    batch["frames"] = frames
    batch["frames_len"] = torch.tensor(lens, dtype=torch.int32,
                                       device="cuda")
    caps = dict(audio_cap=DEC.audio_bucket(mc, host["audio_len"]),
                frames_cap=DEC.frames_bucket(mc, np.asarray(lens)))
    prepared = frontends.prepare_frames(frames, size=mc.frame_size,
                                        mean=mc.vid_mean, std=mc.vid_std)
    if tuple(prepared.shape[2:4]) != (112, 149):
        raise AssertionError(f"resized to {tuple(prepared.shape)}")
    resize_ms = cuda_ms(lambda: frontends.prepare_frames(
        frames, size=mc.frame_size, mean=mc.vid_mean, std=mc.vid_std),
        iters=5, warmup=1)
    cpu = frontends.prepare_frames(frames[:1, :2].cpu(), size=mc.frame_size,
                                   mean=mc.vid_mean, std=mc.vid_std)
    err = max_abs(prepared[:1, :2].cpu(), cpu)
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: DEC.encode(pipe.model, mc, batch,
                                            dtype=torch.bfloat16, **caps),
                         iters=3, warmup=1)
        mem, _ = DEC.encode(pipe.model, mc, batch, dtype=torch.bfloat16,
                            **caps)
    want_len = np.maximum(-(-np.minimum(lens, caps["frames_cap"]) // 8), 1)
    ok = (bool(torch.isfinite(mem.enc_video).all())
          and np.array_equal(mem.video_len.cpu().numpy(), want_len)
          and tuple(mem.enc_video.shape) == (RESIZE_REQUESTS,
                                             mc.av_max_length, 512))
    log(f"configs: resize path, {RESIZE_REQUESTS} requests of {W} x {H} "
        f"uint8 frames ({T} steps) -> {tuple(prepared.shape)} f32: "
        f"prepare_frames {resize_ms:.2f} ms, encode (R(2+1)D, bf16, the "
        f"resize included) {enc_ms:.2f} ms (CUDA events); card vs cpu "
        f"resize max|d| {err:.2e} (tol 1e-5); memories ok={ok} [{card}]")
    if not ok or not err <= 1e-5:
        raise AssertionError("resize path failed")
    return {"resize_ms": resize_ms, "encode_ms": enc_ms}


def _grads(model, mc, batch, caps, dtype):
    """(loss, every gradient leaf) of one loss_fn backward."""
    params = qg_model.param_tree(model)
    for p in tree_leaves(params):
        p.grad = None
    loss, _ = qg_model.loss_fn(model, mc, batch, dtype=dtype, **caps)
    loss.backward()
    grads = [p.grad.detach().clone() if p.grad is not None
             else torch.zeros_like(p) for p in tree_leaves(params)]
    for p in tree_leaves(params):
        p.grad = None
    return float(loss.detach()), grads


def _worst_rel(a, b) -> float:
    """The worst leaf's max |a - b| over max |b|; a leaf whose b is zero
    (the attention over a length-1 zero memory has no gradient) counts
    against the largest leaf's max instead."""
    top = max(float(y.float().abs().max()) for y in b)
    return max(float((x.float() - y.float()).abs().max())
               / max(float(y.float().abs().max()), 1e-6 * top)
               for x, y in zip(a, b))


def _config_training(card: str, model) -> dict:
    """R(2+1)D training at B=16 with remat_video off and on (loss,
    gradients, step wall, peak memory, K4's launches), one
    non-attention step at B=32, and gradient accumulation in f32."""
    mc, params, _, _, i2w = model
    B = RESNET_TRAIN_B
    ds = SyntheticCorpus(mc, i2w, 1, B, SEED + 4)
    trainer = Trainer(train_config(B), mc, params["embedding"]["table"], ds,
                      ds, device="cuda", log_fn=log)
    host = batch_arrays(ds.batch(0))
    caps = trainer.caps_for(host)
    batch = to_device(host, "cuda")
    ts = trainer.train_state
    out = {}
    steps = {r: make_train_step(mc._replace(remat_video=r),
                                trainer.optimizer, dtype=torch.bfloat16)
             for r in (False, True)}
    for remat in (False, True, False, True):
        steps[remat](ts, batch, trainer.generator, **caps)   # warm-up
    for remat in (False, True):
        _reset_launches()
        t0 = time.perf_counter()
        (_, metrics), peak = _peak_mb(lambda: steps[remat](
            ts, batch, trainer.generator, **caps))
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = _launches()
        want = dict(ZERO_LAUNCHES, lstm_train_fwd=mc.text_layers,
                    lstm_train_bwd=mc.text_layers)
        log(f"configs: {config_name(CONFIG_CASES[0])} train step B={B} "
            f"bf16 remat_video={remat}: {step_ms:.1f} ms, peak memory "
            f"{peak:.0f} MB, loss {float(metrics['loss']):.4f}, launched "
            f"{launches} (want {want}) [{card}]")
        if launches != want or not np.isfinite(float(metrics["loss"])):
            raise AssertionError(f"remat={remat}: launches {launches}")
        check_routes("configs: K4 forward", lstm_layer_train.fwd_routes,
                     want["lstm_train_fwd"])
        check_routes("configs: K4 backward", lstm_layer_train.bwd_routes,
                     want["lstm_train_bwd"])
        out[f"step_ms_remat_{remat}"] = step_ms
        out[f"peak_mb_remat_{remat}"] = peak
        out["launches"] = launches
    # loss and gradients, no update: off, off again (the spread), on
    runs = {}
    for key, remat in (("off", False), ("off2", False), ("on", True)):
        runs[key] = _grads(ts.model, mc._replace(remat_video=remat), batch,
                           caps, torch.bfloat16)
    spread = _worst_rel(runs["off2"][1], runs["off"][1])
    delta = _worst_rel(runs["on"][1], runs["off"][1])
    band = max(2 * spread, REMAT_BAND)
    log(f"configs: remat_video on vs off (bf16, B={B}): loss {runs['on'][0]!r}"
        f" vs {runs['off'][0]!r}; worst gradient leaf |on - off| / max "
        f"{delta:.2e}, off vs off {spread:.2e} (band {band:.1e})")
    if (abs(runs["on"][0] - runs["off"][0]) > 1e-6 * abs(runs["off"][0])
            or not delta <= band):
        raise AssertionError("remat_video changes the loss or gradients")

    # one non-attention step at B=32 (text_video, conv-LSTM)
    na = config_model(CONFIG_CASES[1])
    nmc = na[0]
    nds = SyntheticCorpus(nmc, i2w, 1, NON_ATTN_TRAIN_B, SEED + 6)
    ntr = Trainer(train_config(NON_ATTN_TRAIN_B), nmc,
                  na[1]["embedding"]["table"], nds, nds, device="cuda",
                  log_fn=log)
    nhost = batch_arrays(nds.batch(0))
    nbatch = to_device(nhost, "cuda")
    ncaps = ntr.caps_for(nhost)
    ntr.train_step(ntr.train_state, nbatch, ntr.generator, **ncaps)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    _, metrics = ntr.train_step(ntr.train_state, nbatch, ntr.generator,
                                **ncaps)
    torch.cuda.synchronize()
    nms = (time.perf_counter() - t0) * 1e3
    nl = _launches()
    want = dict(ZERO_LAUNCHES, lstm_train_fwd=nmc.text_layers + 1,
                lstm_train_bwd=nmc.text_layers + 1)
    log(f"configs: {config_name(CONFIG_CASES[1])} train step B="
        f"{NON_ATTN_TRAIN_B} bf16: {nms:.1f} ms, loss "
        f"{float(metrics['loss']):.4f}, launched {nl} (want {want}) [{card}]")
    if nl != want or not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"non-attention step launches {nl}")
    check_routes("configs: K4 forward", lstm_layer_train.fwd_routes,
                 want["lstm_train_fwd"])
    check_routes("configs: K4 backward", lstm_layer_train.bwd_routes,
                 want["lstm_train_bwd"])
    out["non_attn_launches"] = nl
    out["non_attn_step_ms"] = nms
    del trainer, ntr, ts
    torch.cuda.empty_cache()

    # gradient accumulation (f32, mode text: no batchnorm, whose statistics
    # would be per microbatch): two accumulated half batches vs the whole
    tmc, tparams, tstate, _, _ = config_model(CONFIG_CASES[2])
    tds = SyntheticCorpus(tmc, i2w, 1, B, SEED + 7)
    tbatch = to_device(batch_arrays(tds.batch(0)), "cuda")
    cfg = train_config(B, optim="sgd", lr=1.0)
    grads = {}
    for accum in (1, 2):
        model = params_from_numpy(tparams, tstate, "cuda", trainable=True)
        before = [p.detach().clone() for p in
                  tree_leaves(qg_model.param_tree(model))]
        opt = make_optimizer(cfg)
        state = TrainState(model, opt.init(qg_model.param_tree(model)))
        make_train_step(tmc, opt, dtype=torch.float32, accum_steps=accum)(
            state, tbatch, None)
        grads[accum] = [b - p.detach() for b, p in zip(
            before, tree_leaves(qg_model.param_tree(model)))]
    names = list(_leaf_names(qg_model.param_tree(model)))
    top = max(float(g.abs().max()) for g in grads[1])
    per_leaf = [(float((a - b).abs().max()), float(b.abs().max()), n)
                for a, b, n in zip(grads[2], grads[1], names)]
    worst = max(d for d, _, _ in per_leaf) / top
    rel = max(per_leaf, key=lambda t: t[0] / max(t[1], 1e-30))
    norm = (sum(float(((a - b) ** 2).sum()) for a, b in zip(grads[2],
                                                           grads[1]))
            / sum(float((b ** 2).sum()) for b in grads[1])) ** 0.5
    log(f"configs: gradient accumulation ({config_name(CONFIG_CASES[2])}, "
        f"f32, B={B}, SGD lr 1): accum_steps=2 vs 1, worst |d| {worst:.2e} "
        f"of the largest gradient (tol {ACCUM_RTOL:.0e}), |d| / |g| over "
        f"all leaves {norm:.2e} (tol {ACCUM_NORM_TOL:.0e}); the worst leaf "
        f"by its own max: {rel[2]} {rel[0] / max(rel[1], 1e-30):.2e} of "
        f"{rel[1]:.2e} [{card}]")
    if not (worst <= ACCUM_RTOL and norm <= ACCUM_NORM_TOL):
        raise AssertionError("accumulated gradients differ")
    out["accum_worst"] = worst
    return out


def _config_card_vs_cpu(case) -> None:
    """One configuration in f32 on 4 requests on the card and on the CPU:
    identical questions for every strategy of the phase (R(2+1)D with both
    devices pinned to CPU_RESNET_FRAMES frames)."""
    mc, params, state, vocab, i2w = config_model(case)
    req = tuple(r[:4] for r in requests(mc, N_REQUESTS, SEED + 2))
    pin = ({"frames_cap": CPU_RESNET_FRAMES}
           if mc.video_encoder == "resnet" and mc.mode != "text" else {})
    out = {}
    for device in ("cuda", "cpu"):
        pipe = QGPipeline(None, mc, params, state, vocab, i2w, device=device,
                          dtype=torch.float32)
        caps = dict(request_caps(pipe, req), **pin)
        host = pipe._pack(*req, **caps)
        mem, st = DEC.encode(pipe.model, mc, pipe._to_device(host),
                             dtype=torch.float32, **caps)
        seeds = torch.from_numpy(row_seed_array(
            host["context_ids"].shape[0], 4, row_ids(4)))
        max_len = mc.target_steps - 1
        out[device] = {}
        for s in CONFIG_STRATEGIES[case]:
            if s == "beam":
                toks = DEC.beam_from_memories(
                    pipe.model, mem, st, max_len=max_len,
                    beam_size=BEAM_SIZE, dtype=torch.float32)
            else:
                toks = DEC.decode_from_memories(
                    pipe.model, mem, st,
                    prng.prng_key(STRATEGY_SEED, pipe.device),
                    strategy=s, max_len=max_len, dtype=torch.float32,
                    row_seeds=seeds)
            out[device][s] = toks.cpu()
        if device == "cuda" and pin:
            # R(2+1)D's memory depends on the frames cap (a defect of the
            # reference, ROADMAP queue 3): a row alone is held to its row
            # in the batch at the batch's caps
            batch = pipe.generate_async(*req, **caps)()
            alone = [pipe.generate_async(*(r[i:i + 1] for r in req),
                                         **caps)()[0] for i in range(4)]
            log(f"configs: {config_name(case)} f32 on the card, each of 4 "
                f"rows alone at the batch's caps {caps}: "
                f"{sum(a == b for a, b in zip(alone, batch))} of 4 questions"
                f" equal to the batch's")
            if alone != batch:
                raise AssertionError("a row alone differs from the batch")
        del pipe
    same = {s: torch.equal(out["cuda"][s], out["cpu"][s])
            for s in out["cuda"]}
    log(f"configs: card vs cpu ({config_name(case)}, f32, 4 requests, one "
        "encode a device"
        + (f", R(2+1)D on {CPU_RESNET_FRAMES} frames a clip on both" if pin
           else "") + f"): tokens identical {same}")
    if not all(same.values()):
        raise AssertionError(f"card and CPU disagree: {same}")


def phase_configs(card: str) -> dict:
    """The configurations beside the flagship at full width: serving of
    trimodal + attention + R(2+1)D (greedy, beam), text_video +
    non-attention + conv-LSTM (greedy, sampling, beam), text +
    attention (greedy) and trimodal + attention + Swin-B at 224 px
    (greedy, beam) with their launches; the resize path; R(2+1)D
    training with remat_video off and on, a non-attention step and
    gradient accumulation; each configuration card vs CPU in f32."""
    req = requests(ModelConfig(n_vocab=N_VOCAB), N_REQUESTS, SEED + 2)
    serving = {}
    for case in CONFIG_CASES:
        serving[case] = _config_serving(card, case, req)
    serving[SWIN_CASE] = _config_serving(card, SWIN_CASE, requests(
        config_model(SWIN_CASE)[0], N_REQUESTS, SEED + 2))
    resnet = serving[CONFIG_CASES[0]]
    resize = _resize_path(card, resnet)
    for s in serving.values():      # free the pipelines' device memory
        del s["pipe"]
    torch.cuda.empty_cache()
    train = _config_training(card, resnet["model"])
    for case in CONFIG_CASES:
        _config_card_vs_cpu(case)
    return {"serving": {config_name(c): s for c, s in serving.items()},
            "resize": resize, "train": train}


# --------------------------------------------------------------- the dp phase

DP_REQUESTS = 37      # odd: the request bucket (64 rows) and the padding split
DP_LARGE = 128        # a second batch, timed only: 128 rows
DP_TRAIN_B = 16       # the DP train step's global batch
DP_WORLDS = (2, 4)    # ranks of the DP train step: 8 and 4 rows a rank
DP_SHORT_FRAMES = 24  # the second half's rows keep at most this many frames
DP_TIMEOUT = 420      # seconds a rank may take before the phase fails


def dp_devices(device: str) -> list:
    """Every visible card, or two replicas on the first when there is one
    (two on the CPU, where the phase is rehearsed)."""
    n = torch.cuda.device_count() if device == "cuda" else 1
    return ([torch.device(device, i) for i in range(n)] if n > 1
            else [torch.device(device, 0)] * 2)


def check_dp_launches(single: dict, sharded: dict, replicas: int) -> None:
    """One unsharded greedy generate() launches K1 4x, K2 21x, the int8
    conv and its quantize 5x each; the sharded one, over ``replicas``
    replicas, that many times as many."""
    want = {"lstm_seq": 4, "trimodal_attention": 21, "vggish_conv_int8": 5,
            "quantize_s8": 5}
    for k, n in want.items():
        if single[k] != n or sharded[k] != replicas * n:
            raise AssertionError(f"dp: {k} launched {single[k]} unsharded, "
                                 f"{sharded[k]} over {replicas} replicas "
                                 f"(want {n} and {replicas * n})")
    check_routes("dp: sharded K1", dict(lstm_seq.routes), replicas * 4)


def check_dp_k4(out: dict, ref: dict) -> None:
    """A rank's train step launched K4 4x each way, by the persistent
    route, as the one-process step did."""
    want = {"persistent": 4, "per_step": 0}
    if (out["fwd_routes"] != want or out["bwd_routes"] != want
            or ref["fwd_routes"] != want):
        raise AssertionError(f"dp: K4 routes fwd {out['fwd_routes']} bwd "
                             f"{out['bwd_routes']}, one process "
                             f"{ref['fwd_routes']} (want {want})")


def _wall_questions(pipe, req) -> float:
    """Wall ms of one generate() (it returns with the questions)."""
    t0 = time.perf_counter()
    pipe.generate(*req)
    return (time.perf_counter() - t0) * 1e3


def _dp_serving(card: str, model, device: str) -> dict:
    """Sharded vs unsharded serving of DP_REQUESTS requests at full width:
    launches and routes, tokens of every strategy in f32, generate() ms in
    turns in bf16."""
    from mmqg_tpu_torch.parallel import make_mesh, pad_batch

    mc, params, state, vocab, i2w = model
    req = requests(mc, DP_REQUESTS, SEED + 9)
    mesh = make_mesh(devices=dp_devices(device))
    R = mesh.dp
    one_card = len(set(mesh.data_devices)) == 1
    log(f"dp: serving over {mesh}" + (": two replicas on one card test the "
                                      "split and the merge, not scaling"
                                      if one_card else ""))
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device=device,
                      dtype=torch.float32)
    sharded = copy.copy(pipe).shard(mesh)
    pipe.generate(*req)                       # warm-up: cuDNN plans, caches
    sharded.generate(*req)
    _reset_launches()
    ref = pipe.generate(*req)
    single = _launches()
    _reset_launches()
    got = sharded.generate(*req)
    launches = _launches()
    log(f"dp: greedy generate() of {DP_REQUESTS} requests ("
        f"{pipe._batch_bucket(DP_REQUESTS)} rows, {R} replicas): launches "
        f"unsharded {single}, sharded {launches}")
    check_dp_launches(single, launches, R)
    same = {"greedy": got == ref}
    for strategy, kw in (("sampling", {"seed": 3}),
                         ("topk", {"topk": 3, "seed": 3}),
                         ("topp", {"top_p": 0.9, "seed": 3}),
                         ("beam", {"beam_size": 4})):
        same[strategy] = (sharded.generate(*req, strategy=strategy, **kw)
                          == pipe.generate(*req, strategy=strategy, **kw))
    # the per-batch stream (evaluate's): each replica draws the noise of
    # the whole padded batch and keeps its rows
    host = pipe._pack(*req)
    caps = dict(audio_cap=DEC.audio_bucket(mc, host["audio_len"]),
                frames_cap=DEC.frames_bucket(mc, host["frames_len"]))
    kw = dict(strategy="sampling", max_len=mc.target_steps - 1,
              dtype=torch.float32, **caps)
    whole = DEC.decode_batch(pipe.model, mc, to_device(pad_batch(host, R),
                                                       device),
                             prng.prng_key(5, device), **kw).cpu().numpy()
    split = sharded.replicas.map(
        lambda m, b, lo, total: DEC.decode_batch(
            m, mc, b, prng.prng_key(5, m.embedding.device),
            global_rows=(lo, total), **kw), host)()
    same["sampling per-batch stream"] = bool(np.array_equal(split, whole))
    log(f"dp: f32 sharded == unsharded tokens {same} (int8 audio tower)")
    if not all(same.values()):
        raise AssertionError(f"dp: sharded serving differs: {same}")

    pipe_b = QGPipeline(None, mc, params, state, vocab, i2w, device=device,
                        dtype=torch.bfloat16)
    pipes = {"unsharded": pipe_b, "sharded": copy.copy(pipe_b).shard(mesh)}
    generate_ms = {}
    for n in (DP_REQUESTS, DP_LARGE):
        req_n = req if n == DP_REQUESTS else requests(mc, n, SEED + 10)
        for p_ in pipes.values():
            p_.generate(*req_n)
        ms = {k: [] for k in pipes}
        for name in list(pipes) + list(pipes)[::-1]:
            ms[name].append(_wall_questions(pipes[name], req_n))
        log(f"dp: greedy generate() of {n} requests, bf16, in turns: "
            + ", ".join(f"{k} " + " / ".join(f"{t:.1f}" for t in v)
                        + " ms (" + " / ".join(f"{n / t * 1e3:.1f}"
                                               for t in v)
                        + " questions/s)" for k, v in ms.items())
            + f" [{card}]")
        generate_ms[n] = {k: float(np.median(v)) for k, v in ms.items()}
    return {"launches": launches, "replicas": R, "generate_ms": generate_ms}


def _dp_batch(mc, i2w) -> tuple:
    """(host batch of DP_TRAIN_B rows, caps): the second half's rows keep
    at most DP_SHORT_FRAMES frames, so the ranks' batchnorm statistics
    differ."""
    host = batch_arrays(SyntheticCorpus(mc, i2w, 1, DP_TRAIN_B, SEED + 11,
                                        max_audio_s=8).batch(0))
    half = DP_TRAIN_B // 2
    host["frames_len"][half:] = np.minimum(host["frames_len"][half:],
                                           DP_SHORT_FRAMES)
    caps = dict(audio_cap=DEC.audio_bucket(mc, host["audio_len"]),
                frames_cap=DEC.frames_bucket(mc, host["frames_len"]))
    return host, caps


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _dp_step(model_np, mc, host, caps, group, device: str) -> dict:
    """One f32 SGD train step of ``host`` on the card, data-parallel over
    ``group`` (this process's row block) or alone (None): the objective,
    the gradients the optimizer got, the parameters after it, K4's
    launches and routes, the step's wall ms (median of 3 more steps), the
    gradient all-reduce's ms and how far the ranks' parameters differ."""
    from mmqg_tpu_torch.optim import Transform
    from mmqg_tpu_torch.parallel import multihost, pad_batch, row_block

    params, state = model_np
    model = params_from_numpy(params, state, device, trainable=True)
    qg_model.set_process_group(model, group)
    base = make_optimizer(train_config(DP_TRAIN_B, optim="sgd", lr=SGD_LR))
    grads = []

    def update(g, s, p):
        grads.append(tree_map(lambda x: x.detach().cpu(), g))
        return base.update(g, s, p)
    opt = Transform(base.init, update)
    tree = qg_model.param_tree(model)
    ts = TrainState(model, opt.init(tree))
    step = make_train_step(mc, opt, dtype=torch.float32, process_group=group)
    rank, world = multihost.world(group) if group is not None else (0, 1)
    rows = pad_batch(host, world)
    lo, hi = row_block(rank, world, len(rows["valid"]))
    batch = to_device({k: v[lo:hi] for k, v in rows.items()}, device)
    _reset_launches()
    ts, m = step(ts, batch, None, **caps)
    _sync(device)
    out = {"loss": float(m["objective"]), "grads": grads[0],
           "params": tree_map(lambda p: p.detach().cpu(), tree),
           "launches": _launches(),
           "fwd_routes": dict(lstm_layer_train.fwd_routes),
           "bwd_routes": dict(lstm_layer_train.bwd_routes),
           "differ": multihost.replicas_differ(tree_leaves(tree), group)}
    walls = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        step(ts, batch, None, **caps)
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = float(np.median(walls))
    leaves = [p.detach().clone() for p in tree_leaves(tree)]
    reduce_ms = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        multihost.all_reduce_flat(leaves, group)
        _sync(device)
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = float(np.median(reduce_ms))
    out["grad_mb"] = sum(x.numel() for x in leaves) * 4 / 2 ** 20
    return out


def dp_rank(rank: int, world: int, port: int, backend: str, device: str,
            inputs: str, result: str) -> None:
    """One rank of the dp phase's train step (a spawned process)."""
    import torch.distributed as dist

    from mmqg_tpu_torch import checkpoint as ckpt_io
    from mmqg_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = TF32
    torch.backends.cudnn.allow_tf32 = TF32
    dev = torch.device(device)
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    multihost.initialize_multihost(f"localhost:{port}", world, rank,
                                   device=dev, backend=backend,
                                   timeout_s=DP_TIMEOUT)
    # one write, so that the ranks' lines do not interleave
    print(f"dp: rank {rank} group backend {dist.get_backend()} world "
          f"{dist.get_world_size()} on {dev}\n", end="", flush=True)
    blob = ckpt_io.msgpack_restore(Path(inputs).read_bytes())
    mc = ModelConfig(**json.loads(blob["mc"]))
    host = {k: np.array(v) for k, v in blob["host"].items()}  # writable
    out = _dp_step((blob["params"], blob["model_state"]), mc, host,
                   {k: int(v) for k, v in blob["caps"].items()},
                   dist.group.WORLD, device)
    torch.save(out, result)
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn_ranks(what: str, target, world: int, backend: str, device: str,
                 inputs: Path, tmp: Path, timeout: float) -> list:
    """Run ``target(rank, world, port, backend, device, inputs, result)``
    in ``world`` spawned processes; their torch.save'd results, in rank
    order. A rank that fails or outlives ``timeout`` fails the phase; no
    process outlives this call."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = [tmp / f"rank{r}.pt" for r in range(world)]
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, backend,
                                              device, str(inputs),
                                              str(results[r])))
             for r in range(world)]
    for proc in procs:
        proc.start()
    try:
        deadline = time.time() + timeout
        for proc in procs:
            proc.join(max(1.0, deadline - time.time()))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    codes = [proc.exitcode for proc in procs]
    if codes != [0] * world:
        raise AssertionError(f"{what}: ranks exited with {codes}")
    return [torch.load(r, weights_only=False) for r in results]


def _nccl_world_one(grad_mb: float) -> float:
    """An NCCL group of one rank on cuda:0: one all-reduce checked, then
    a gradient-sized all-reduce timed (ms)."""
    import torch.distributed as dist

    from mmqg_tpu_torch.parallel import multihost

    multihost.initialize_multihost(f"localhost:{_free_port()}", 1, 0,
                                   device="cuda:0")
    try:
        log(f"dp: group backend {dist.get_backend()} world "
            f"{dist.get_world_size()} on cuda:0")
        x = torch.arange(8, dtype=torch.float32, device="cuda")
        dist.all_reduce(x)
        if not torch.equal(x.cpu(), torch.arange(8, dtype=torch.float32)):
            raise AssertionError("dp: NCCL all-reduce at world size 1")
        flat = torch.ones(int(grad_mb * 2 ** 20 / 4), device="cuda")
        ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(flat)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms[1:]))
    finally:
        dist.destroy_process_group()


def _dp_training(card: str, model, device: str) -> dict:
    """The data-parallel train step at each of DP_WORLDS ranks (NCCL, one
    card a rank, where there are that many cards; else gloo with the ranks
    on the cards in turn, all on cuda:0 with one card) against one
    process's step on the same DP_TRAIN_B rows, f32, at full width."""
    from mmqg_tpu_torch import checkpoint as ckpt_io

    mc, params, state, vocab, i2w = model
    params = he_vggish(params)
    host, caps = _dp_batch(mc, i2w)
    half = DP_TRAIN_B // 2
    log(f"dp: train batch {DP_TRAIN_B}, valid frames rows 0-{half - 1} "
        f"{int(host['frames_len'][:half].sum())}, rows {half}-"
        f"{DP_TRAIN_B - 1} {int(host['frames_len'][half:].sum())}; caps "
        f"{caps}")
    ref = _dp_step((params, state), mc, host, caps, None, device)
    log(f"dp: world size 1 (one process, {DP_TRAIN_B} rows): step "
        f"{ref['step_ms']:.1f} ms, K4 launches fwd "
        f"{ref['launches']['lstm_train_fwd']} bwd "
        f"{ref['launches']['lstm_train_bwd']} [{card}]")
    names = list(_leaf_names(qg_model.param_tree(params_from_numpy(
        params, state))))
    out = {"launches": {}, "backend": {}, "step_ms": {"world 1":
                                                      ref["step_ms"]},
           "allreduce_ms": {}}
    with tempfile.TemporaryDirectory(prefix="mmqg_dp_") as tmp:
        inputs = Path(tmp) / "inputs.msgpack"
        inputs.write_bytes(ckpt_io.msgpack_serialize({
            "params": params, "model_state": state, "host": host,
            "caps": {k: np.int64(v) for k, v in caps.items()},
            "mc": json.dumps(mc._asdict())}))
        for world in DP_WORLDS:
            backend = ("nccl" if device == "cuda"
                       and torch.cuda.device_count() >= world else "gloo")
            if device == "cuda":
                torch.cuda.empty_cache()    # the ranks share the card
            results = Path(tmp) / f"world{world}"
            results.mkdir()
            ranks = _spawn_ranks(f"dp: train at {world} ranks", dp_rank,
                                 world, backend, device, inputs, results,
                                 DP_TIMEOUT)
            for r, got in enumerate(ranks):
                lines, failed = compare_train_steps(
                    (got["loss"], got["grads"], got["params"], {}),
                    (ref["loss"], ref["grads"], ref["params"], {}), names)
                log(f"dp: rank {r} ({backend}, world {world}, "
                    f"{DP_TRAIN_B // world} rows) vs one process: "
                    + lines[0])
                log(f"  {lines[1]}")
                log(f"  rank {r}: K4 launches fwd "
                    f"{got['launches']['lstm_train_fwd']} bwd "
                    f"{got['launches']['lstm_train_bwd']}, routes fwd "
                    f"{got['fwd_routes']} bwd {got['bwd_routes']}; step "
                    f"{got['step_ms']:.1f} ms; gradient all-reduce "
                    f"{got['allreduce_ms']:.1f} ms ({got['grad_mb']:.1f} MB);"
                    f" ranks' parameters differ by {got['differ']:.1e} "
                    f"[{card}]")
                if failed or got["differ"] != 0.0:
                    raise AssertionError(f"dp: train rank {r} of {world} is "
                                         "off: see above")
                check_dp_k4(got, ref)
            total = {k: sum(o["launches"][k] for o in ranks)
                     for k in ("lstm_train_fwd", "lstm_train_bwd")}
            if total != {k: world * ref["launches"][k] for k in total}:
                raise AssertionError(f"dp: K4 launches over {world} ranks "
                                     f"{total}")
            out["launches"][world] = total
            out["backend"][world] = backend
            out["step_ms"][f"world {world}"] = float(np.median(
                [o["step_ms"] for o in ranks]))
            out["allreduce_ms"][world] = float(np.median(
                [o["allreduce_ms"] for o in ranks]))
    out["nccl_world1_ms"] = None
    if device == "cuda":
        out["nccl_world1_ms"] = _nccl_world_one(ref["grad_mb"])
        log(f"dp: NCCL all-reduce of {ref['grad_mb']:.1f} MB at world size "
            f"1: {out['nccl_world1_ms']:.2f} ms [{card}]")
    return out


def phase_dp(card: str, device: str = "cuda") -> dict:
    """17. dp: data parallelism at the flagship's full width (``device``
    "cpu" rehearses it, with the kernels' plain versions)."""
    t0 = time.perf_counter()
    model = flagship()
    serving = _dp_serving(card, model, device)
    training = _dp_training(card, model, device)
    log(f"dp: phase wall {time.perf_counter() - t0:.1f} s")
    return {"serving": serving, "training": training}


# ------------------------------------------------------------ dp CLIs

# `python3 chip_smoke.py --dp-clis`: the data-parallel CLIs as processes,
# over every visible card, on a corpus written at the flagship's shapes
CLI_SPLITS = {"train": 64, "val": 32, "test": 96}  # examples a split
CLI_BATCH, CLI_EVAL_BATCH = 32, 16   # eval batches need no padding on 4
CLI_EPOCHS = 2
CLI_SERVE = 24        # daemon requests, staged media of the test split
CLI_TIMEOUT = 900     # seconds a CLI process may take
# runs a CLI's main() and reports the peak resident set of the process
# and of its largest child (the train CLI's spawned workers)
MAXRSS = ("import resource, sys\n"
          "from mmqg_tpu_torch import {module} as m\n"
          "m.main(sys.argv[1:])\n"
          "print('maxrss_kb', resource.getrusage(resource.RUSAGE_SELF)"
          ".ru_maxrss, resource.getrusage(resource.RUSAGE_CHILDREN)"
          ".ru_maxrss, file=sys.stderr)\n")


def write_corpus(root) -> tuple:
    """A corpus in the reference's layout at the flagship's shapes, made
    from SEED: the vocabulary (``alpha_vocab``), a 300-d embedding matrix,
    the train/val/test question files (CLI_SPLITS examples; contexts of
    40-283 words, questions of 4-20), and each example's salient frames
    (.npy, 20-101 uint8 frames at 112 x 112) and 16 kHz clip (.wav, 8-32
    s). Returns (config path, Config)."""
    from mmqg_tpu_torch.config import Config

    rng = np.random.default_rng(SEED + 20)
    vocab, i2w = alpha_vocab(N_VOCAB)
    words = np.array([i2w[str(i)] for i in range(3, N_VOCAB)])
    root = Path(root)
    config = Config(output_path=root / "results", data_path=root / "data",
                    dataset_path=root / "dataset", batch_size=CLI_BATCH,
                    eval_batch_size=CLI_EVAL_BATCH)
    for d in (config.data_path, config.salient_frames_path,
              config.salient_audio_path):
        d.mkdir(parents=True, exist_ok=True)
    with open(config.vocab_file, "w") as f:
        json.dump(vocab, f)
    with open(config.index_to_word_file, "w") as f:
        json.dump(i2w, f)
    np.save(config.weights_matrix_file,
            rng.normal(size=(N_VOCAB, config.glove_emb_dim)
                       ).astype(np.float32))
    fs, sr, av = config.frame_size, config.audio_sample_rate, \
        config.av_max_length
    qid = 0
    for split, n in CLI_SPLITS.items():
        records = []
        for _ in range(n):
            vid = f"lec{qid % 7}"
            records.append({
                "question_id": qid, "video_id": vid, "answer": "",
                "question": " ".join(rng.choice(words, rng.integers(4, 21))),
                "context": " ".join(rng.choice(words,
                                               rng.integers(40, 284)))})
            t = int(rng.integers(max(1, av // 5), av + 1))
            np.save(config.salient_frames_path / f"v_{vid}_q_{qid}_.npy",
                    rng.integers(0, 256, (t, fs, fs, 3), np.uint8))
            write_wav(config.salient_audio_path / f"v_{vid}_q_{qid}_.wav",
                      tones(rng, int(rng.integers(8 * sr, 32 * sr + 1)), sr),
                      sr)
            qid += 1
        with open(config.data_path / f"{split}_questions.json", "w") as f:
            json.dump(records, f)
    return config.save(root / "config.json"), config


def run_cli(module: str, args: list, what: str, stdin: str = "") -> dict:
    """``python -c MAXRSS`` running ``mmqg_tpu_torch.<module>.main(args)``
    from the repo root: its wall, stdout and stderr, and the peak RSS
    (GiB) of the process and of its largest child. Fails unless it exits
    0."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", MAXRSS.format(module=module)] + args,
        input=stdin, capture_output=True, text=True, timeout=CLI_TIMEOUT,
        cwd=REPO)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"dp-clis: {what} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    kb = [line.split()[1:] for line in proc.stderr.splitlines()
          if line.startswith("maxrss_kb")][-1]
    own, child = (int(k) / 2 ** 20 for k in kb)
    return {"wall_s": wall, "stdout": proc.stdout, "stderr": proc.stderr,
            "rss_gib": own, "child_rss_gib": child}


def _serve_answers(cfg: list, lines: str, extra: list, what: str) -> dict:
    out = run_cli("serve", cfg + ["--best", "-s", "greedy", "--max-batch",
                                  "32", "--linger-ms", "200"] + extra,
                  what, stdin=lines)
    responses = [json.loads(line) for line in out["stdout"].splitlines()]
    check_answers(what, responses, list(range(CLI_SERVE)), 0)
    out["questions"] = {r["id"]: r["question"] for r in responses}
    return out


def phase_dp_clis(card: str) -> dict:
    """The data-parallel CLIs over every visible card, as a user runs them:
    ``train --data-parallel`` (a spawned worker a card, streaming their
    rows) for CLI_EPOCHS epochs, its stats and checkpoints, the largest
    worker's peak RSS; ``evaluate --data-parallel --streaming`` (beam;
    batches of CLI_EVAL_BATCH rows that need no padding, more of them than
    the loader's three buffers) against the unsharded ``evaluate``'s
    predictions, which must be identical; ``serve --data-parallel`` on
    CLI_SERVE staged requests against the unsharded daemon."""
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mmqg_dp_clis_") as root:
        config_path, config = write_corpus(root)
        log(f"dp-clis: corpus of {CLI_SPLITS} examples at the flagship's "
            f"shapes written in {time.perf_counter() - t0:.1f} s; {n} cards")
        cfg = ["-c", str(config_path)]
        train = run_cli("train", cfg + ["--data-parallel", "--epochs",
                                        str(CLI_EPOCHS)], "train")
        with open(config.stats_json_path) as f:
            stats = json.load(f)
        epochs = len(stats["train"]["loss"])
        losses = stats["train"]["loss"] + stats["val"]["loss"]
        if (epochs != CLI_EPOCHS or not np.all(np.isfinite(losses))
                or not (config.checkpoint_dir / "best.msgpack").exists()):
            raise AssertionError(f"dp-clis: train wrote {stats}")
        workers = [line for line in train["stdout"].splitlines()
                   if line.startswith("data-parallel")]
        # what each worker would hold of a materialised train + val split
        held = (CLI_SPLITS["train"] + CLI_SPLITS["val"]) * (
            config.av_max_length * (config.frame_size ** 2 * 3
                                    + 2 * config.audio_sample_rate))
        log(f"dp-clis: `train -c <config> --data-parallel --epochs "
            f"{CLI_EPOCHS}`: {workers}; train loss {stats['train']['loss']}"
            f", val loss {stats['val']['loss']}; {train['wall_s']:.1f} s "
            f"wall (start, spawn and kernel library included); peak RSS "
            f"{train['rss_gib']:.2f} GiB the parent, "
            f"{train['child_rss_gib']:.2f} GiB the largest worker (a "
            f"materialised train + val split "
            f"would be {held / 2 ** 30:.2f} GiB more a worker) [{card}]")

        preds = config.output_path / "best_predictions_beam.json"
        evals = {}
        for name, extra in (("unsharded", []),
                            ("--data-parallel --streaming",
                             ["--data-parallel", "--streaming"])):
            evals[name] = run_cli("evaluate", cfg + ["-s", "beam", "--best"]
                                  + extra, f"evaluate {name}")
            with open(preds) as f:
                evals[name]["predictions"] = json.load(f)
        ref, got = (evals[k]["predictions"] for k in evals)
        same = sum(a == b for a, b in zip(ref, got))
        log(f"dp-clis: `evaluate -s beam --best`, {len(ref)} test examples "
            f"in batches of {CLI_EVAL_BATCH}: unsharded "
            f"{evals['unsharded']['wall_s']:.1f} s, --data-parallel "
            f"--streaming {evals['--data-parallel --streaming']['wall_s']:.1f}"
            f" s wall; {same} of {len(ref)} predictions identical [{card}]")
        if len(got) != len(ref) or same != len(ref):
            raise AssertionError("dp-clis: sharded evaluate differs")

        rows = json.load(open(config.test_file))[:CLI_SERVE]
        lines = "".join(json.dumps({
            "id": i, "context": r["context"],
            "frames_npy": str(config.salient_frames_path
                              / f"v_{r['video_id']}_q_{r['question_id']}_.npy"),
            "audio_wav": str(config.salient_audio_path
                             / f"v_{r['video_id']}_q_{r['question_id']}_.wav")})
            + "\n" for i, r in enumerate(rows))
        single = _serve_answers(cfg, lines, [], "serve")
        sharded = _serve_answers(cfg, lines, ["--data-parallel"],
                                 "serve --data-parallel")
        equal = sum(single["questions"][i] == sharded["questions"][i]
                    for i in range(CLI_SERVE))
        ready = [line for line in sharded["stderr"].splitlines()
                 if line.startswith("ready")]
        log(f"dp-clis: `serve --best -s greedy` on {CLI_SERVE} staged "
            f"requests: unsharded {single['wall_s']:.1f} s, --data-parallel "
            f"{sharded['wall_s']:.1f} s wall, {ready[:1]}; {equal} of "
            f"{CLI_SERVE} questions identical (waves form in prep "
            f"completion order, so a row may meet other batch shapes) "
            f"[{card}]")
    wall = time.perf_counter() - t0
    log(f"dp-clis: phase wall {wall:.1f} s")
    return {"cards": n, "train_wall_s": train["wall_s"],
            "train_worker_rss_gib": train["child_rss_gib"],
            "materialised_split_gib": held / 2 ** 30,
            "evaluate_wall_s": {k: v["wall_s"] for k, v in evals.items()},
            "evaluate_identical": same,
            "serve_wall_s": {"unsharded": single["wall_s"],
                             "--data-parallel": sharded["wall_s"]},
            "serve_identical": equal, "wall_s": wall}


# ---------------------------------------------------------- phase offline

OFFLINE_QUESTIONS_PER_VIDEO = 12  # 96 questions: 76 / 10 / 10 after the split
OFFLINE_WORKERS = 4
# the prepare CLI's module run as __main__ (what ``python -m`` does) in a
# child process, with its four stage functions timed; then the stages'
# wall ms and the media route counters as one JSON line
PREPARE_CHILD = r"""
import json, runpy, sys, time
from mmqg_tpu_torch.data import glove, saliency, text_prep, vocab
ms = {}
def timed(mod, name, stage):
    fn = getattr(mod, name)
    def run(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            ms[stage] = (time.perf_counter() - t0) * 1e3
    setattr(mod, name, run)
for mod, name, stage in ((saliency, "run_prep_pipeline", "saliency"),
                         (glove, "ingest_glove", "glove"),
                         (text_prep, "preprocess_corpus", "text"),
                         (vocab, "prepare_data", "data")):
    timed(mod, name, stage)
sys.argv = ["mmqg_tpu_torch.prepare"] + sys.argv[1:]
runpy.run_module("mmqg_tpu_torch.prepare", run_name="__main__")
print("prepare-child " + json.dumps({
    "stage_ms": ms, "frame_routes": saliency.frame_routes,
    "audio_routes": saliency.audio_routes}))
"""


def write_raw_corpus(config, *, n_videos: int = N_VIDEOS,
                     per_video: int = OFFLINE_QUESTIONS_PER_VIDEO,
                     seconds=VIDEO_SECONDS, size=VIDEO_SIZE,
                     fps: int = VIDEO_FPS, wav_rate: int = WAV_RATE,
                     seed: int = SEED) -> dict:
    """A raw lecture corpus in the reference's layout under ``config``'s
    paths, from ``seed``: per video an mp4 (``write_lecture_mp4``), its
    .srt and a staged 44.1 kHz stereo wav under ``config.audio_path``;
    ``labelled_questions.json`` (``per_video`` spans of 4-30 s a video as
    "M:SS", no question ids: the saliency stage assigns them),
    ``videos.json``, and a GloVe text file of ``config.glove_emb_dim``
    values for every other word of the vocabulary the captions and
    questions draw from. Returns the counts written."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(seed + 11)
    _, i2w = alpha_vocab(N_VOCAB)
    words = [i2w[str(i)] for i in range(3, N_VOCAB)]
    for path in (config.video_path, config.subs_path, config.audio_path,
                 config.glove_path):
        Path(path).mkdir(parents=True, exist_ok=True)
    durations = [int(d) for d in rng.integers(seconds[0], seconds[1] + 1,
                                              n_videos)]
    sigma = np.log(SPAN_P50_P90[1] / SPAN_P50_P90[0]) / 1.2816
    questions, videos = [], []
    for v, d in enumerate(durations):
        vid = f"lec{v:02d}"
        write_srt(Path(config.subs_path) / f"{vid}.srt", d, rng, i2w)
        left, right = (tones(rng, d * wav_rate, wav_rate) for _ in range(2))
        write_wav(Path(config.audio_path) / f"{vid}.wav",
                  np.stack([left, right // 2 + left // 2], axis=1), wav_rate)
        videos.append({"id": vid, "video_url": f"lectures/{vid}.mp4"})
        for _ in range(per_video):
            length = float(np.clip(np.exp(rng.normal(np.log(SPAN_P50_P90[0]),
                                                     sigma)), *SPAN_SECONDS))
            length = min(round(length), d - 1)
            start = int(rng.integers(0, d - length))
            q = " ".join(rng.choice(words, int(rng.integers(4, 13))))
            questions.append({
                "video_id": vid, "question": q.capitalize() + "?",
                "answer_start": f"{start // 60}:{start % 60:02d}",
                "answer_end": f"{(start + length) // 60}:"
                              f"{(start + length) % 60:02d}",
                "option_1": " ".join(rng.choice(words,
                                                int(rng.integers(1, 5))))})
    Path(config.questions_file).write_text(json.dumps(questions))
    Path(config.videos_file).write_text(json.dumps(videos))
    with open(config.glove_file, "w") as f:
        for w in words[::2]:
            vec = rng.standard_normal(config.glove_emb_dim) * 0.4
            f.write(w + " " + " ".join(f"{x:.5f}" for x in vec) + "\n")
    with ThreadPoolExecutor(max_workers=8) as ex:
        for fut in [ex.submit(write_lecture_mp4,
                              Path(config.video_path) / f"{vid['id']}.mp4",
                              d, v, size, fps)
                    for v, (vid, d) in enumerate(zip(videos, durations))]:
            fut.result()
    return {"videos": n_videos, "questions": len(questions),
            "seconds": sum(durations), "glove_words": len(words[::2])}


def run_prepare(config_path, workers: int = OFFLINE_WORKERS) -> dict:
    """``mmqg_tpu_torch.prepare -c config_path --stages
    saliency,glove,text,data --workers N`` in a child process
    (``PREPARE_CHILD``): its printed lines, each stage's wall ms and the
    child's frame and audio route counts."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", PREPARE_CHILD, "-c", str(config_path),
         "--stages", "saliency,glove,text,data", "--workers", str(workers)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"prepare exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    child = json.loads(lines[-1].split(" ", 1)[1])
    return dict(child, lines=lines[:-1], wall_s=wall)


def split_sizes(n: int):
    """The 80/10/10 split's sizes of ``n`` records (train_test_split's
    ceil of the test share, twice)."""
    n_rem = int(np.ceil(0.2 * n))
    n_test = int(np.ceil(0.5 * n_rem))
    return n - n_rem, n_rem - n_test, n_test


def check_prepared(config, n_questions: int, frame_size: int) -> tuple:
    """Every question has its frames (uint8, at least one frame at the
    frame size) and its clip; the splits' sizes; returns them."""
    frames = sorted(Path(config.salient_frames_path).glob("*.npy"))
    clips = sorted(Path(config.salient_audio_path).glob("*.wav"))
    if len(frames) != n_questions or len(clips) != n_questions:
        raise AssertionError(f"{len(frames)} frame files and {len(clips)} "
                             f"clips for {n_questions} questions")
    for p in frames:
        a = np.load(p)
        if (a.dtype != np.uint8 or a.ndim != 4 or a.shape[0] < 1
                or a.shape[1:] != (frame_size, frame_size, 3)):
            raise AssertionError(f"{p.name}: {a.dtype} {a.shape}")
    sizes = tuple(len(json.loads(Path(f).read_text()))
                  for f in (config.train_file, config.val_file,
                            config.test_file))
    if sizes != split_sizes(n_questions):
        raise AssertionError(f"split sizes {sizes} != "
                             f"{split_sizes(n_questions)}")
    return sizes


def expected_audio_route() -> str:
    """The route ``saliency.extract_audio`` takes on this host."""
    import shutil

    if native.media_available():
        return "native"
    return "ffmpeg" if shutil.which("ffmpeg") else "none"


def probe_extract_audio(config, video_id: str) -> dict:
    """``extract_audio`` once into a scratch dataset directory, on a tone
    mp4 where the native library can write one, else on ``video_id``'s
    (silent) lecture mp4: the route it took (one call counted) and its
    error, if any; the route must be the one this host supports."""
    scratch = config.replace(dataset_path=Path(config.dataset_path) / "probe")
    Path(scratch.video_path).mkdir(parents=True, exist_ok=True)
    src = Path(scratch.video_path) / f"{video_id}.mp4"
    if not native.write_test_tone_mp4(src, seconds=2.0):
        src.symlink_to((Path(config.video_path) / src.name).resolve())
    saliency.audio_routes.update(dict.fromkeys(saliency.audio_routes, 0))
    error = None
    try:
        saliency.extract_audio(scratch, video_id)
    except RuntimeError as err:
        error = str(err)
    want = expected_audio_route()
    routes = dict(saliency.audio_routes)
    if routes != {r: int(r == want) for r in routes} or (
            (error is None) != (want != "none")):
        raise AssertionError(f"extract_audio routes {routes}, error "
                             f"{error!r}; want route {want}")
    return {"routes": routes, "error": error}


def train_on_prepared(card: str, config) -> dict:
    """QGDataset over the prepared splits, the flagship's widths
    (ModelConfig defaults, the corpus's own vocabulary, its weight
    matrix), Trainer.run_epoch at batch 32 bf16 (one warm-up epoch, one
    measured: K4 4x forward and 4x backward a step, persistent), then
    validate() (K1 4x persistent, K2 target_steps x tiled, the int8 conv
    and quantize_s8 5x each)."""
    from mmqg_tpu_torch.data.dataset import QGDataset

    t0 = time.perf_counter()
    train_ds = QGDataset(config, config.train_file)
    val_ds = QGDataset(config, config.val_file)
    emb = np.load(config.weights_matrix_file).astype(np.float32)
    mc = ModelConfig.from_config(config, n_vocab=len(train_ds.vocab))
    trainer = Trainer(config, mc, emb, train_ds, val_ds, device="cuda",
                      log_fn=lambda *a, **k: None)
    load_s = time.perf_counter() - t0
    B = config.batch_size
    steps = -(-len(train_ds.records) // B)
    log(f"offline: QGDataset {len(train_ds.records)} train / "
        f"{len(val_ds.records)} val records, frames "
        f"{int(train_ds.frames_len.min())}-{int(train_ds.frames_len.max())}"
        f", audio {train_ds.audio_len.min() / mc.sample_rate:.1f}-"
        f"{train_ds.audio_len.max() / mc.sample_rate:.1f} s; Trainer "
        f"hidden={mc.hidden_dim} emb={mc.word_emb_dim} Lc="
        f"{mc.context_max_length} av={mc.av_max_length} frames "
        f"{mc.frame_size} vocab={mc.n_vocab} bf16 batch {B}: built in "
        f"{load_s:.1f} s [{card}]")
    trainer.run_epoch(0)                     # warm-up: cuDNN plans, caches
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    loss = trainer.run_epoch(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = _launches()
    want = dict(ZERO_LAUNCHES, lstm_train_fwd=(mc.text_layers + 1) * steps,
                lstm_train_bwd=(mc.text_layers + 1) * steps)
    log(f"offline: run_epoch of {steps} steps launched {launches} (want "
        f"{want}); mean loss {loss:.4f}; {epoch_s * 1e3:.1f} ms "
        f"({len(train_ds.records) / epoch_s:.1f} samples/s, batches packed "
        f"and copied in the epoch) [{card}]")
    if launches != want or steps < 2 or not np.isfinite(loss):
        raise AssertionError(f"offline train: launches {launches} != {want},"
                             f" {steps} steps or loss {loss}")
    check_routes("offline: train K4 forward", lstm_layer_train.fwd_routes,
                 want["lstm_train_fwd"])
    check_routes("offline: train K4 backward", lstm_layer_train.bwd_routes,
                 want["lstm_train_bwd"])
    _reset_launches()
    t0 = time.perf_counter()
    val = trainer.validate()
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t0) * 1e3
    val_launches = _launches()
    val_want = dict(ZERO_LAUNCHES, lstm_seq=mc.text_layers + 1,
                    trimodal_attention=mc.target_steps,
                    vggish_conv_int8=len(V.POOLS), quantize_s8=len(V.POOLS))
    log(f"offline: validate() of {len(val_ds.records)} records launched "
        f"{val_launches} (want {val_want}), loss {val['loss']:.4f} bleu "
        f"{val['bleu']:.4f}, {val_ms:.1f} ms [{card}]")
    if val_launches != val_want or not np.isfinite(val["loss"]):
        raise AssertionError(f"offline validate: launches {val_launches} != "
                             f"{val_want} or loss {val['loss']}")
    check_routes("offline: validate() K1", lstm_seq.routes,
                 val_want["lstm_seq"])
    return {"steps": steps, "epoch_ms": epoch_s * 1e3,
            "samples_s": len(train_ds.records) / epoch_s, "loss": loss,
            "launches": launches, "validate_launches": val_launches,
            "validate_ms": val_ms}


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        a.astype(np.float32).view(np.uint32),
        b.astype(np.float32).view(np.uint32))


def reference_round_trip(card: str, model, root, device: str = "cuda",
                         n_requests: int = N_REQUESTS) -> dict:
    """The flagship's tree through the reference's four artifacts and
    back: ``to_reference.export_checkpoint``, ``torch.save`` at the
    config's av_model_path / text_enc_model_path / dec_model_path /
    learned_weight_path, ``torch.load(weights_only=True)`` and
    ``from_reference.import_checkpoint``; every leaf bit for bit. Then the
    main path's requests served by both models in f32: identical tokens,
    and (on the card) K1 4x, K2 21x and the int8 conv 5x a generate() on
    their routes."""
    from mmqg_tpu_torch.compat import from_reference, to_reference
    from mmqg_tpu_torch.config import Config

    mc, params, state, vocab, i2w = model
    cfg = Config(output_path=Path(root) / "reference")
    cfg.ensure_dirs()
    t0 = time.perf_counter()
    av, text, dec, emb = to_reference.export_checkpoint(params, state)
    for sd, path in ((av, cfg.av_model_path), (text, cfg.text_enc_model_path),
                     (dec, cfg.dec_model_path)):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    torch.save(torch.from_numpy(emb), cfg.learned_weight_path)
    loaded = [{k: v.numpy() for k, v in torch.load(
        p, map_location="cpu", weights_only=True).items()}
        for p in (cfg.av_model_path, cfg.text_enc_model_path,
                  cfg.dec_model_path)]
    emb_back = torch.load(cfg.learned_weight_path, map_location="cpu",
                          weights_only=True).numpy()
    p2, s2 = from_reference.import_checkpoint(*loaded, emb_back, mc)
    trip_s = time.perf_counter() - t0
    names = (list(_leaf_names(params, "params"))
             + list(_leaf_names(state, "state")))
    if names != (list(_leaf_names(p2, "params"))
                 + list(_leaf_names(s2, "state"))):
        raise AssertionError("the imported tree's structure differs")
    got, ref = tree_leaves((p2, s2)), tree_leaves((params, state))
    differ = [n for n, a, b in zip(names, got, ref) if not _same_bits(a, b)]
    mb = sum(os.path.getsize(p) for p in (
        cfg.av_model_path, cfg.text_enc_model_path, cfg.dec_model_path,
        cfg.learned_weight_path)) / 2 ** 20
    log(f"offline: reference artifacts (av_model.pth, text_enc_model.pth, "
        f"dec_model.pth, learned_weight.pt; {mb:.1f} MiB) written, loaded "
        f"with weights_only and imported in {trip_s:.1f} s: {len(names)} "
        f"leaves, {len(names) - len(differ)} bit for bit")
    if differ:
        raise AssertionError(f"round trip changed leaves {differ[:5]}")

    req = requests(mc, n_requests, SEED + 2)
    out = {}
    for name, (p, s) in (("original", (params, state)),
                         ("imported", (p2, s2))):
        pipe = QGPipeline(None, mc, p, s, vocab, i2w, device=device,
                          dtype=torch.float32)
        _reset_launches()
        questions = pipe.generate(*req)
        launches = _launches()
        if device == "cuda":
            want = dict(ZERO_LAUNCHES, lstm_seq=mc.text_layers + 1,
                        trimodal_attention=mc.target_steps - 1,
                        vggish_conv_int8=len(V.POOLS),
                        quantize_s8=len(V.POOLS))
            log(f"offline: f32 generate() of the {name} model launched "
                f"{launches} (want {want})")
            if launches != want:
                raise AssertionError(f"offline {name}: launches {launches}")
            check_routes(f"offline: {name} K1", lstm_seq.routes,
                         want["lstm_seq"])
        _, toks, logits = _encode_decode(pipe, req)
        out[name] = (questions, toks.cpu(), logits.cpu(), launches)
        del pipe
    same = (out["original"][0] == out["imported"][0]
            and torch.equal(out["original"][1], out["imported"][1]))
    d = max_abs(out["original"][2], out["imported"][2])
    log(f"offline: {n_requests} requests, f32, original vs imported model: "
        f"tokens identical {same}, logits max|d| {d:.1e} [{card}]")
    if not same or d != 0.0:
        raise AssertionError("the imported model serves other tokens")
    return {"leaves": len(names), "round_trip_s": trip_s, "mib": mb,
            "launches": out["imported"][3]}


def convert_dry_run(card: str, root, device: str = "cuda") -> dict:
    """``python -m mmqg_tpu_torch.convert --dry-run`` (on the card unless
    ``device`` says otherwise) as a child process: it converts stand-in
    VGGish and R(2+1)D-18 files and restores the checkpoint through
    Trainer.resume. Here its checkpoint's audio_enc is held to the
    stand-in's weights, transposed."""
    from mmqg_tpu_torch import checkpoint as ckpt
    from mmqg_tpu_torch.config import Config

    work = Path(root) / "convert"
    cmd = [sys.executable, "-m", "mmqg_tpu_torch.convert", "--dry-run",
           "--work-dir", str(work)]
    if device != "cuda":
        cmd += ["--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or "dry run OK" not in proc.stdout:
        raise AssertionError(f"convert --dry-run exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr[-3000:]}")
    config = Config.load(work / "results" / "config.json")
    audio = ckpt.load_checkpoint(config.checkpoint_dir,
                                 "pretrained")["params"]["audio_enc"]
    sd = {k: v.numpy() for k, v in torch.load(
        work / "vggish-standin.pth", map_location="cpu",
        weights_only=True).items()}
    convs = [k[:-len(".weight")] for k in sd if k.startswith("features.")
             and k.endswith(".weight")]
    want = ([(sd[f"{k}.weight"].transpose(2, 3, 1, 0), sd[f"{k}.bias"])
             for k in convs]
            + [(sd[f"embeddings.{i}.weight"].T, sd[f"embeddings.{i}.bias"])
               for i in (0, 2, 4)])
    got = ([(c["w"], c["b"]) for c in audio["convs"]]
           + [(audio[f]["w"], audio[f]["b"]) for f in ("fc1", "fc2", "fc3")])
    equal = len(got) == len(want) == 9 and all(
        _same_bits(a, b) for pair in zip(got, want) for a, b in zip(*pair))
    for line in proc.stdout.splitlines():
        log(f"offline: convert: {line}")
    log(f"offline: convert --dry-run {wall:.1f} s wall; the checkpoint's "
        f"audio_enc equals the stand-in's weights transposed: {equal} "
        f"[{card}]")
    if not equal:
        raise AssertionError("convert: audio_enc differs from the stand-in")
    return {"wall_s": wall}


def phase_offline(card: str, model, device: str = "cuda") -> dict:
    """Raw lecture corpus -> ``mmqg_tpu_torch.prepare`` -> training on the
    prepared artifacts at the flagship's widths; the reference-checkpoint
    bridges on the flagship's weights; ``convert --dry-run``."""
    import importlib.util

    from mmqg_tpu_torch.config import Config

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mmqg_offline_") as tmp:
        root = Path(tmp)
        config = Config(output_path=root / "results",
                        dataset_path=root / "dataset",
                        data_path=root / "data",
                        glove_path=root / "glove.6B")
        t0 = time.perf_counter()
        corpus = write_raw_corpus(config)
        log(f"offline: raw corpus written in {time.perf_counter() - t0:.1f} "
            f"s: {corpus['videos']} mp4s ({corpus['seconds']} s, "
            f"{VIDEO_SIZE[0]}x{VIDEO_SIZE[1]} at {VIDEO_FPS} fps), .srt, "
            f"staged {WAV_RATE} Hz stereo wavs, {corpus['questions']} "
            f"questions, GloVe {config.glove_emb_dim}-d for "
            f"{corpus['glove_words']} words")
        prep = run_prepare(config.save(), OFFLINE_WORKERS)
        for line in prep["lines"]:
            log(f"offline: prepare: {line}")
        n = corpus["questions"]
        want_stats = (f"saliency: {{'audio': 0, 'frames': {n}, "
                      f"'clips': {n}, 'texts': {n}}}")
        if prep["lines"][0] != want_stats or prep["lines"][-1] != "Done !":
            raise AssertionError(f"prepare printed {prep['lines']}")
        want_frames = {r: corpus["videos"] if r == expected_frame_route()
                       else 0 for r in saliency.frame_routes}
        log(f"offline: prepare frame routes {prep['frame_routes']} (want "
            f"{want_frames}), audio routes {prep['audio_routes']} (every "
            "wav staged: none extracted)")
        if (prep["frame_routes"] != want_frames
                or any(prep["audio_routes"].values())):
            raise AssertionError("offline: prepare media routes")
        probe = probe_extract_audio(config, "lec00")
        log(f"offline: extract_audio on this host: routes {probe['routes']}"
            f", error {probe['error']!r}")
        sizes = check_prepared(config, n, config.frame_size)
        ms = prep["stage_ms"]
        log(f"offline: one .npy and one clip per question ({n}); splits "
            f"{sizes}; sklearn importable on this host: "
            f"{importlib.util.find_spec('sklearn') is not None} (not used)")
        log(f"offline: prepare stage ms " + ", ".join(
            f"{k} {v:.1f}" for k, v in ms.items())
            + f"; saliency {corpus['videos'] / ms['saliency'] * 1e3:.2f} "
            f"videos/s ({OFFLINE_WORKERS} workers; host time, no device); "
            f"the child's wall {prep['wall_s']:.1f} s [{card}]")
        train = train_on_prepared(card, config)
        bridges = reference_round_trip(card, model, root, device)
        convert = convert_dry_run(card, root, device)
    wall = time.perf_counter() - t_phase
    log(f"offline: phase wall {wall:.1f} s")
    return {"stage_ms": ms, "splits": sizes, "train": train,
            "bridges": bridges, "convert": convert, "wall_s": wall}


# --------------------------------------------------------- train features

# Phase 19: ZeRO-1 and FSDP over two ranks, a profiled Trainer epoch and
# the checkpoint writer, at the flagship's full width
FEATURES_B = 32           # the global batch: 16 rows a rank
FEATURES_WORLD = 2
FEATURES_CLIP = 1.0       # Adam with a global-norm clip, as users run it
FEATURES_MODES = ("plain", "zero1", "fsdp")
# the sharded f32 step's state (parameters, moments, counts, batchnorm
# statistics) against the plain step's, each leaf's largest difference as
# a share of its largest value: the update is elementwise on the slices
# and the gradients are the same sums, so they differ by the clip's norm
# at most (summed in another order). The f32 steps run cuDNN's
# deterministic algorithms: its default weight-gradient algorithms sum in
# an order that varies from run to run (a plain step repeated differed by
# 7.15e-6 of the video conv0 moments' max on an H100), and a second plain
# step, printed, witnesses that the repeat now gives the same state.
FEATURES_RTOL = 1e-6
FEATURES_F32 = (("plain", "plain"), ("repeat", "plain"), ("zero1", "zero1"),
                ("fsdp", "fsdp"))
FEATURES_TIMEOUT = 600    # seconds a rank may take before the phase fails
FEATURES_TRAIN_BATCHES = 4


def _state_on_device(ts) -> dict:
    """The whole train state as tensors on the model's device: the
    parameters (gathered under FSDP), the optimizer state (gathered under
    ZeRO-1) and the batchnorm statistics, copies."""
    def copy(tree):
        return tree_map(lambda x: x.detach().clone(), tree)
    shards = ts.shards
    opt = (shards.full_opt_state(ts.opt_state) if shards is not None
           else copy(ts.opt_state))
    with shards.gathered() if shards is not None else contextlib.nullcontext():
        params = copy(qg_model.param_tree(ts.model))
    return {"params": params, "opt_state": opt,
            "model_state": copy(qg_model.model_state(ts.model))}


def _worst_share(got: dict, ref: dict) -> tuple:
    """(share, leaf): the largest difference of a leaf of ``got`` from
    ``ref`` as a share of the leaf's largest |value| in ``ref``."""
    worst = (0.0, "")
    for name, (a, b) in zip(_leaf_names(ref), zip(tree_leaves(got),
                                                  tree_leaves(ref))):
        scale = max(float(b.detach().abs().max()), 1e-30) if b.numel() \
            else 1.0
        diff = float((a.double() - b.double()).abs().max()) if b.numel() \
            else 0.0
        worst = max(worst, (diff / scale, name))
    return worst


def _timed(fn, device: str, n: int = 3) -> float:
    """Median wall ms of ``fn()`` over ``n`` runs, each synchronised."""
    walls = []
    for _ in range(n):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def _features_steps(model_np, mc, host, caps, group, device: str) -> dict:
    """One rank of phase 19's steps: one f32 step of each mode from the
    same weights, the sharded ones' whole states held to the plain one's;
    then bf16 steps of the three in turns (walls, peak memory), the bytes
    each holds between steps against the rule's, and the collectives'
    times."""
    from mmqg_tpu_torch.parallel import multihost, pad_batch, row_block, zero
    from mmqg_tpu_torch.parallel.mesh import fsdp_shardings, zero1_shardings

    params, state = model_np
    rank, world = multihost.world(group)
    rows = pad_batch(host, world)
    lo, hi = row_block(rank, world, len(rows["valid"]))
    batch = to_device({k: v[lo:hi] for k, v in rows.items()}, device)
    opt = make_optimizer(train_config(FEATURES_B,
                                      grad_clip_norm=FEATURES_CLIP))

    def fresh(mode: str, dtype):
        model = params_from_numpy(params, state, device, trainable=True)
        qg_model.set_process_group(model, group)
        ts = TrainState(model, opt.init(qg_model.param_tree(model)))
        if mode != "plain":
            zero.shard(ts, group, fsdp=mode == "fsdp")
        return ts, make_train_step(mc, opt, dtype=dtype, process_group=group,
                                   zero1=mode == "zero1",
                                   fsdp=mode == "fsdp")

    out = {"rank": rank, "world": world, "rows": hi - lo, "f32": {}}
    ref = None
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    for label, mode in FEATURES_F32:
        ts, step = fresh(mode, torch.float32)
        _reset_launches()
        ts, m = step(ts, batch, None, **caps)
        _sync(device)
        got = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "launches": _launches(),
               "fwd_routes": dict(lstm_layer_train.fwd_routes),
               "bwd_routes": dict(lstm_layer_train.bwd_routes)}
        whole = _state_on_device(ts)
        if ref is None:
            ref = whole
            full = {"opt_state": zero.rule_bytes(
                        ts.opt_state, zero1_shardings(ts.opt_state, 1), 1),
                    "params": zero.rule_bytes(
                        qg_model.param_tree(ts.model),
                        fsdp_shardings(qg_model.param_tree(ts.model), 1), 1)}
            share = {"opt_state": zero.rule_bytes(
                        ts.opt_state, zero1_shardings(ts.opt_state, world),
                        world),
                     "params": zero.rule_bytes(
                        qg_model.param_tree(ts.model), fsdp_shardings(
                            qg_model.param_tree(ts.model), world), world)}
        else:
            got["worst"] = _worst_share(whole, ref)
            if ts.shards is not None:
                got["split_leaves"] = len(ts.shards.split)
                got["leaves"] = len(ts.shards.param_dims)
            del whole
        out["f32"][label] = got
        del ts, step
    del ref
    cudnn.deterministic, cudnn.benchmark = saved
    if device == "cuda":
        torch.cuda.empty_cache()
    out["rule_bytes"] = {"plain": full,
                         "zero1": {"opt_state": share["opt_state"],
                                   "params": full["params"]},
                         "fsdp": share}

    states = {mode: fresh(mode, torch.bfloat16) for mode in FEATURES_MODES}
    for ts, step in states.values():          # warm-up: plans, caches
        step(ts, batch, None, **caps)
    _sync(device)
    out["held"] = {mode: zero.held_bytes(ts)
                   for mode, (ts, _) in states.items()}
    walls = {mode: [] for mode in FEATURES_MODES}
    peaks = {mode: [] for mode in FEATURES_MODES}
    for mode in FEATURES_MODES + FEATURES_MODES[::-1]:
        ts, step = states[mode]
        _sync(device)
        if device == "cuda":
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, m = step(ts, batch, None, **caps)
        _sync(device)
        walls[mode].append((time.perf_counter() - t0) * 1e3)
        if device == "cuda":
            peaks[mode].append((torch.cuda.max_memory_allocated() - base)
                               / 2 ** 20)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"train_features: {mode} bf16 loss "
                                 f"{float(m['loss'])}")
    out["step_ms"] = walls
    out["step_peak_mb"] = peaks
    if device == "cuda":
        out["max_memory_allocated_mb"] = \
            torch.cuda.max_memory_allocated() / 2 ** 20
    # the collectives of one step, alone: the plain step's all-reduce of
    # every gradient, ZeRO-1's reduce-scatter of the split leaves' and
    # all-gather of their updated slices
    shards = states["zero1"][0].shards
    split = sum(p.numel() for _, p in shards.split)
    every = sum(p.numel() for p in tree_leaves(shards.params))
    flat = torch.ones(split, device=device)
    grads = [torch.ones(every, device=device)]
    out["collective_ms"] = {
        "all_reduce": _timed(lambda: multihost.all_reduce_flat(grads, group),
                             device),
        "reduce_scatter": _timed(
            lambda: multihost.reduce_scatter_flat(flat, group), device),
        "all_gather": _timed(lambda: multihost.all_gather_flat(
            flat[:split // world], group), device)}
    out["collective_mb"] = {"all_reduce": every * 4 / 2 ** 20,
                            "reduce_scatter": split * 4 / 2 ** 20,
                            "all_gather": split * 4 / 2 ** 20}
    out["whole_leaves"] = [("/".join(map(str, path)), tuple(p.shape))
                           for path, p in tree_items(shards.params)
                           if shards.param_dims[path] is None]
    return out


def features_rank(rank: int, world: int, port: int, backend: str,
                  device: str, inputs: str, result: str) -> None:
    """One rank of phase 19's sharded steps (a spawned process)."""
    import torch.distributed as dist

    from mmqg_tpu_torch import checkpoint as ckpt_io
    from mmqg_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = TF32
    torch.backends.cudnn.allow_tf32 = TF32
    dev = torch.device(device)
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:       # rehearsed on the CPU: the ranks share its cores
        torch.set_num_threads(1)
    multihost.initialize_multihost(f"localhost:{port}", world, rank,
                                   device=dev, backend=backend,
                                   timeout_s=FEATURES_TIMEOUT)
    print(f"train_features: rank {rank} group backend {dist.get_backend()} "
          f"world {dist.get_world_size()} on {dev}\n", end="", flush=True)
    blob = ckpt_io.msgpack_restore(Path(inputs).read_bytes())
    mc = ModelConfig(**json.loads(blob["mc"]))
    host = {k: np.array(v) for k, v in blob["host"].items()}
    out = _features_steps((blob["params"], blob["model_state"]), mc, host,
                          {k: int(v) for k, v in blob["caps"].items()},
                          dist.group.WORLD, device)
    torch.save(out, result)
    dist.destroy_process_group()


def _features_ranks(card: str, model, device: str) -> dict:
    """Phase 19's sharded steps over two ranks (NCCL over two cards where
    two are visible, else two gloo ranks on cuda:0), checked."""
    from mmqg_tpu_torch import checkpoint as ckpt_io

    mc, params, state, vocab, i2w = model
    host = batch_arrays(SyntheticCorpus(mc, i2w, 1, FEATURES_B, SEED + 12,
                                        max_audio_s=8).batch(0))
    caps = dict(audio_cap=DEC.audio_bucket(mc, host["audio_len"]),
                frames_cap=DEC.frames_bucket(mc, host["frames_len"]))
    backend = ("nccl" if device == "cuda" and torch.cuda.device_count() > 1
               else "gloo")
    world = FEATURES_WORLD
    with tempfile.TemporaryDirectory(prefix="mmqg_features_") as tmp:
        inputs = Path(tmp) / "inputs.msgpack"
        inputs.write_bytes(ckpt_io.msgpack_serialize({
            "params": params, "model_state": state, "host": host,
            "caps": {k: np.int64(v) for k, v in caps.items()},
            "mc": json.dumps(mc._asdict())}))
        if device == "cuda":
            torch.cuda.empty_cache()        # the ranks may share the card
        ranks = _spawn_ranks("train_features", features_rank, world,
                             backend, device, inputs, Path(tmp),
                             FEATURES_TIMEOUT)
    log(f"train_features: batch {FEATURES_B} ({FEATURES_B // world} rows a "
        f"rank), Adam lr 1e-4, clip {FEATURES_CLIP}, caps {caps}; "
        f"{backend} over {world} ranks"
        + (" on one card (the split and the collectives, not scaling)"
           if backend == "gloo" and device == "cuda" else ""))
    want_k4 = {"persistent": mc.text_layers + 1, "per_step": 0}
    launches = {mode: {"lstm_train_fwd": 0, "lstm_train_bwd": 0}
                for mode in FEATURES_MODES}
    for out in ranks:
        r = out["rank"]
        plain_loss = out["f32"]["plain"]["loss"]
        for label, mode in FEATURES_F32:
            got = out["f32"][label]
            if label in launches:
                for k in launches[label]:
                    launches[label][k] += got["launches"][k]
            line = (f"train_features: rank {r} f32 {label}: loss "
                    f"{got['loss']:.6f}, grad norm {got['grad_norm']:.4f}, "
                    f"K4 routes fwd {got['fwd_routes']} bwd "
                    f"{got['bwd_routes']}")
            if label != "plain":
                share, leaf = got["worst"]
                line += (f"; vs plain: loss {got['loss'] - plain_loss:+.2e}"
                         f", worst leaf {leaf} {share:.2e} of its max (tol "
                         f"{FEATURES_RTOL:.0e})")
            if "split_leaves" in got:
                line += (f"; {got['split_leaves']} of {got['leaves']} "
                         "parameter leaves split")
            log(line + f" [{card}]")
            if device == "cuda" and (got["fwd_routes"] != want_k4
                                     or got["bwd_routes"] != want_k4):
                raise AssertionError(f"train_features: rank {r} {label} K4 "
                                     "routes")
            if label != "plain" and (
                    got["worst"][0] > FEATURES_RTOL
                    or abs(got["loss"] - plain_loss)
                    > FEATURES_RTOL * abs(plain_loss)):
                raise AssertionError(f"train_features: rank {r} {label} "
                                     "differs from the plain step")
        held, rule = out["held"], out["rule_bytes"]
        log(f"train_features: rank {r} holds between steps (MiB): " + "; ".join(
            f"{mode} optimizer state {held[mode]['opt_state'] / 2 ** 20:.1f}"
            f" (rule {rule[mode]['opt_state'] / 2 ** 20:.1f}), parameters "
            f"{held[mode]['params'] / 2 ** 20:.1f} (rule "
            f"{rule[mode]['params'] / 2 ** 20:.1f})"
            for mode in FEATURES_MODES))
        if held != rule:
            raise AssertionError(f"train_features: rank {r} holds {held}, "
                                 f"the rule gives {rule}")
        log(f"train_features: rank {r} bf16 step ms in turns: " + ", ".join(
            f"{mode} " + " / ".join(f"{t:.1f}" for t in out["step_ms"][mode])
            for mode in FEATURES_MODES)
            + "; peak above the resident state (MiB): " + ", ".join(
                f"{mode} " + " / ".join(f"{p:.0f}" for p in
                                        out["step_peak_mb"][mode])
                for mode in FEATURES_MODES)
            + (f"; max_memory_allocated {out['max_memory_allocated_mb']:.0f}"
               " MiB" if "max_memory_allocated_mb" in out else "")
            + f" [{card}]")
        log(f"train_features: rank {r} collectives ms: " + ", ".join(
            f"{k} {v:.2f} ({out['collective_mb'][k]:.1f} MiB)"
            for k, v in out["collective_ms"].items()) + f" [{card}]")
    log(f"train_features: leaves kept whole: {ranks[0]['whole_leaves']}")
    want = {k: world * (mc.text_layers + 1) for k in launches["plain"]}
    if device == "cuda" and any(v != want for v in launches.values()):
        raise AssertionError(f"train_features: K4 launches {launches}")
    return {"backend": backend, "launches": launches,
            "step_ms": {m: float(np.median([t for o in ranks
                                            for t in o["step_ms"][m]]))
                        for m in FEATURES_MODES},
            "held_mib": {m: {k: v / 2 ** 20 for k, v in
                             ranks[0]["held"][m].items()}
                         for m in FEATURES_MODES},
            "collective_ms": {k: float(np.median([o["collective_ms"][k]
                                                  for o in ranks]))
                              for k in ranks[0]["collective_ms"]},
            "worst_share": max(o["f32"][m]["worst"][0] for o in ranks
                               for m in FEATURES_MODES[1:]),
            "repeat_share": max(o["f32"]["repeat"]["worst"][0]
                                for o in ranks)}


def _trace_kernels(profile_dir: Path) -> dict:
    """K4's kernel records by direction in the Chrome traces under
    ``profile_dir`` (the names of K4_PROFILE_KERNELS), and the traced
    step's wall (its ``train_step`` region, host clock, with the
    profiler on)."""
    counts = {part: 0 for part in K4_PROFILE_KERNELS}
    events, step_ms = 0, None
    for path in profile_dir.glob("trace_*.json"):
        for e in json.loads(path.read_text()).get("traceEvents", []):
            events += 1
            name = e.get("name", "")
            if name == "train_step" and e.get("cat") == "user_annotation":
                step_ms = e.get("dur", 0) / 1e3
            for part, kernels in K4_PROFILE_KERNELS.items():
                if e.get("cat") == "kernel" and any(k in name
                                                    for k in kernels[:2]):
                    counts[part] += 1
    return {"events": events, "step_ms": step_ms, **counts}


def _features_trainer(card: str, model, root: Path, device: str = "cuda",
                      n_batches: int = FEATURES_TRAIN_BATCHES) -> dict:
    """One Trainer epoch with profile_dir at batch 32, bf16; the traced
    warm step's K4 records by name; validate()."""
    mc, params, state, vocab, i2w = model
    B = FEATURES_B
    train_ds = SyntheticCorpus(mc, i2w, n_batches, B, SEED + 4)
    val_ds = SyntheticCorpus(mc, i2w, 1, B, SEED + 5)
    trace_dir = root / "trace"
    trainer = Trainer(train_config(B), mc, params["embedding"]["table"],
                      train_ds, val_ds, device=device, log_fn=log,
                      profile_dir=trace_dir)
    _reset_launches()
    t0 = time.perf_counter()
    loss = trainer.run_epoch(0)
    _sync(device)
    epoch_s = time.perf_counter() - t0
    launches = _launches()
    want = dict(ZERO_LAUNCHES,
                lstm_train_fwd=(mc.text_layers + 1) * n_batches,
                lstm_train_bwd=(mc.text_layers + 1) * n_batches)
    traced = _trace_kernels(trace_dir) if trainer._profiled else {}
    log(f"train_features: Trainer epoch with profile_dir, {n_batches} steps "
        f"of {B}, bf16: loss {loss:.4f}, {epoch_s * 1e3:.1f} ms with the "
        f"traced step and the trace's export; launched {launches} (want "
        f"{want}); traced a warm step: {trainer._profiled}, its trace "
        f"{traced} [{card}]")
    if device == "cuda":
        if launches != want:
            raise AssertionError(f"train_features: epoch launches {launches}")
        check_routes("train_features: K4 forward", lstm_layer_train.fwd_routes,
                     want["lstm_train_fwd"])
        check_routes("train_features: K4 backward",
                     lstm_layer_train.bwd_routes, want["lstm_train_bwd"])
        if not trainer._profiled or not (traced["forward"]
                                         and traced["backward"]):
            raise AssertionError(f"train_features: the trace of a warm step "
                                 f"holds no K4 records by name: {traced}")
    if not np.isfinite(loss):
        raise AssertionError(f"train_features: epoch loss {loss}")
    _reset_launches()
    val = trainer.validate()
    _sync(device)
    val_launches = _launches()
    val_want = dict(ZERO_LAUNCHES, lstm_seq=mc.text_layers + 1,
                    trimodal_attention=mc.target_steps,
                    vggish_conv_int8=len(V.POOLS), quantize_s8=len(V.POOLS))
    log(f"train_features: validate() launched {val_launches} (want "
        f"{val_want}), loss {val['loss']:.4f} [{card}]")
    if device == "cuda" and val_launches != val_want:
        raise AssertionError(f"train_features: validate launches "
                             f"{val_launches}")
    shutil.rmtree(trace_dir, ignore_errors=True)
    return {"trainer": trainer, "launches": launches,
            "validate_launches": val_launches, "traced": traced,
            "epoch_ms": epoch_s * 1e3}


def _features_checkpoints(card: str, trainer, root: Path) -> dict:
    """The trained flagship state saved to msgpack synchronously and
    asynchronously in turns (the time the caller is blocked, the host
    copy included), equal bytes and a load round trip; the orbax backend
    where tensorstore imports."""
    import importlib

    from mmqg_tpu_torch import checkpoint as ckpt_io
    from mmqg_tpu_torch.compat.from_jax import train_state_to_numpy

    ts = trainer.train_state
    d = root / "ckpt"

    def host():
        return train_state_to_numpy(ts.model, ts.opt_state, ts.step)

    blocked = {"sync": [], "async": []}
    writer_ms = []
    for kind in ("sync", "async", "async", "sync"):
        t0 = time.perf_counter()
        ckpt_io.save_checkpoint(d, kind, host(), {"epoch": 0},
                                async_save=kind == "async")
        blocked[kind].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        ckpt_io.wait_for_pending()
        if kind == "async":
            writer_ms.append((time.perf_counter() - t0) * 1e3)
    size = (d / "sync.msgpack").stat().st_size
    same = (d / "sync.msgpack").read_bytes() == (d / "async.msgpack"
                                                 ).read_bytes()
    ref = host()
    back = ckpt_io.load_checkpoint(d, "async")
    exact = all(np.array_equal(a, b) for a, b in
                zip(tree_leaves(back), tree_leaves(ref)))
    log(f"train_features: msgpack checkpoint {size / 2 ** 20:.1f} MiB; the "
        f"caller blocked, in turns: sync " + " / ".join(
            f"{t:.1f}" for t in blocked["sync"]) + " ms, async " + " / ".join(
            f"{t:.1f}" for t in blocked["async"]) + " ms (then the writer "
        + " / ".join(f"{t:.1f}" for t in writer_ms) + f" ms); async bytes "
        f"== sync bytes {same}; load round trip exact {exact} [{card}]")
    if not (same and exact):
        raise AssertionError("train_features: asynchronous checkpoint")
    try:
        importlib.import_module("tensorstore")
        have_ts = True
    except ImportError:
        have_ts = False
    out = {"msgpack_mib": size / 2 ** 20,
           "blocked_ms": {k: float(np.median(v)) for k, v in blocked.items()},
           "writer_ms": float(np.median(writer_ms)), "tensorstore": have_ts}
    log(f"train_features: tensorstore imports on this host: {have_ts}")
    if have_ts:
        t0 = time.perf_counter()
        ckpt_io.save_checkpoint(d, "orbax", ref, backend="orbax")
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = ckpt_io.load_checkpoint(d, "orbax")
        load_ms = (time.perf_counter() - t0) * 1e3
        exact = all(np.array_equal(a, b) for a, b in
                    zip(tree_leaves(back), tree_leaves(ref)))
        log(f"train_features: orbax save {save_ms:.1f} ms, load "
            f"{load_ms:.1f} ms, every leaf exact {exact} [{card}]")
        if not exact:
            raise AssertionError("train_features: orbax round trip")
        out.update(orbax_save_ms=save_ms, orbax_load_ms=load_ms)
    else:
        try:
            ckpt_io.save_checkpoint(d, "orbax", ref, backend="orbax")
        except ImportError as e:
            log(f"train_features: backend='orbax' raised ImportError: {e}")
        else:
            raise AssertionError("train_features: orbax without tensorstore "
                                 "did not raise")
        if ckpt_io.has_checkpoint(d, "orbax"):
            raise AssertionError("train_features: orbax wrote a checkpoint "
                                 "without tensorstore")
    shutil.rmtree(d, ignore_errors=True)
    return out


def phase_train_features(card: str, model, device: str = "cuda") -> dict:
    """19. train_features: ZeRO-1/FSDP, a profiled Trainer epoch and the
    checkpoint writer at the flagship's full width (``device`` "cpu"
    rehearses it, with the kernels' plain versions)."""
    t0 = time.perf_counter()
    ranks = _features_ranks(card, model, device)
    with tempfile.TemporaryDirectory(prefix="mmqg_features_") as tmp:
        trained = _features_trainer(card, model, Path(tmp), device)
        ckpts = _features_checkpoints(card, trained.pop("trainer"),
                                      Path(tmp))
    wall = time.perf_counter() - t0
    log(f"train_features: phase wall {wall:.1f} s")
    return {"ranks": ranks, "trainer": trained, "checkpoints": ckpts,
            "wall_s": wall}


# ------------------------------------------------------------- model axis

MA_B = 16                 # the tensor-parallel step's rows (one data row)
MA_RTOL = 1e-4            # a gradient leaf vs one process, share of its max
MA_TOWER_RTOL = 5e-2      # the ReLU conv towers (as phase 10)
MA_LOSS_RTOL = 1e-4
MA_TIMEOUT = 600          # seconds a rank may take before the phase fails
MA_PP_TOL = 1e-5          # GPipe vs the sequential stack (JAX's bound)


def _ma_steps(blob, grid, device: str) -> dict:
    """One rank of the model_axis phase (a spawned process)."""
    from mmqg_tpu_torch.dryrun import gpipe_deltas
    from mmqg_tpu_torch.optim import Transform, tree_map_with_path
    from mmqg_tpu_torch.parallel import model_axis, zero
    from mmqg_tpu_torch.parallel.mesh import row_block, sp_greedy_decode

    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)
    mc = ModelConfig(**json.loads(blob["mc"]))
    params, state = blob["params"], blob["model_state"]
    host = {k: np.array(v) for k, v in blob["host"].items()}
    caps = {k: int(v) for k, v in blob["caps"].items()}
    rows = len(host["valid"])
    lo, hi = row_block(grid.data_index, grid.dp, rows)
    mine = to_device({k: v[lo:hi] for k, v in host.items()}, dev)
    whole = to_device(host, dev)
    data = grid.data_group if grid.dp > 1 else None
    base = make_optimizer(train_config(MA_B))
    grads = []

    def update(g, s, p):
        grads.append(g)
        return base.update(g, s, p)
    opt = Transform(base.init, update)

    def fresh(group=data):
        model = params_from_numpy(params, state, dev, trainable=True)
        qg_model.set_process_group(model, group)
        return TrainState(model, opt.init(qg_model.param_tree(model)))

    out = {"rank": grid.rank, "shape": grid.shape, "rows": hi - lo}
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    # f32: one process on every row, then the grid
    ts = fresh(None)
    grads.clear()
    ts, m = make_train_step(mc, opt, dtype=torch.float32)(ts, whole, None,
                                                          **caps)
    ref_loss = float(m["loss"])
    ref_grads = tree_map(lambda g: g.detach().cpu(), grads[0])
    names = list(_leaf_names(ref_grads))
    del ts
    grads.clear()
    _reset_launches()
    ts = fresh()
    step = make_train_step(mc, opt, dtype=torch.float32, grid=grid)
    ts, m = step(ts, mine, None, **caps)
    _sync(device)
    out["launches"] = _launches()
    out["fwd_routes"] = dict(lstm_layer_train.fwd_routes)
    out["bwd_routes"] = dict(lstm_layer_train.bwd_routes)
    tp = ts.model.tp
    got = tree_map_with_path(
        lambda path, g: (g if tp.dims.get(path) is None else
                         model_axis.gather_along(g, tp.dims[path], tp.group)
                         ).detach().cpu(), grads[0])
    rel = _grad_rel(got, ref_grads, names)
    smooth = [n for n in names if not _in_tower(n)]
    tower = [n for n in names if _in_tower(n)]
    out["f32"] = {
        "loss": float(m["loss"]), "ref_loss": ref_loss,
        "worst": max((rel[n][0], n) for n in smooth),
        "worst_tower": max((rel[n][0], n) for n in tower),
        "bad": [n for n, (r, _) in rel.items()
                if r > (MA_TOWER_RTOL if _in_tower(n) else MA_RTOL)],
        "split": len(tp.split), "leaves": len(tp.dims),
        "vocab_parallel": tp.vocab}
    meta = tree_map(lambda a: torch.empty(np.shape(a), device="meta"),
                    params)
    opt_meta = base.init(meta)
    out["held"] = zero.held_bytes(ts)
    out["rule"] = {"params": zero.grid_rule_bytes(meta, grid.shape,
                                                  data=False),
                   "opt_state": zero.grid_rule_bytes(opt_meta, grid.shape,
                                                     data=False),
                   "whole_params": zero.grid_rule_bytes(meta, (1, 1))}
    split_bytes = sum(math.prod(tp.shapes[path]) * 4 for path, _ in tp.split)
    out["gather_mib"] = split_bytes / 2 ** 20
    out["gather_ms"] = _timed(lambda: tp.gather(vocab=True) or tp.release(),
                              device)
    del ts, step
    # a sequence-parallel (gather-free) f32 step: the plain step's loss
    ts = fresh()
    ts, m = make_train_step(mc, opt, dtype=torch.float32, grid=grid,
                            sp_mesh=grid, sp_gather_free=True)(
        ts, mine, None, **caps)
    out["sp_loss"] = float(m["loss"])
    del ts
    # SP decodes of the 32 requests (f32) against the unsharded greedy
    req = {k: np.array(v) for k, v in blob["requests"].items()}
    req_t = to_device(req, dev)
    rcaps = {k: int(v) for k, v in blob["request_caps"].items()}
    plain = params_from_numpy(params, state, dev)
    with torch.no_grad():
        want = DEC.decode_batch(plain, mc, req_t, strategy="greedy",
                                max_len=mc.target_steps - 1,
                                dtype=torch.float32, **rcaps)
    del plain
    ts = fresh()
    model_axis.shard(ts, grid)
    out["sp_decode"] = {}
    for gf in (False, True):
        _reset_launches()
        toks = sp_greedy_decode(ts.model, mc, req_t, grid,
                                max_len=mc.target_steps - 1, gather_free=gf,
                                dtype=torch.float32)
        _sync(device)
        out["sp_decode"][gf] = {
            "equal_rows": int((toks == want).all(dim=1).sum()),
            "rows": int(want.shape[0]), "launches": _launches()}
    del ts
    cudnn.deterministic, cudnn.benchmark = saved
    # bf16 steps in turns: the grid's and one process's on this rank's rows
    states = {"tensor_parallel": (fresh(), make_train_step(
        mc, base, dtype=torch.bfloat16, grid=grid)),
        "one_process": (fresh(None), make_train_step(
            mc, base, dtype=torch.bfloat16))}
    for ts_, step_ in states.values():          # warm-up
        step_(ts_, mine, None, **caps)
    walls = {k: [] for k in states}
    for name in list(states) + list(states)[::-1]:
        ts_, step_ = states[name]
        _sync(device)
        t0 = time.perf_counter()
        _, m = step_(ts_, mine, None, **caps)
        _sync(device)
        walls[name].append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"model_axis: {name} bf16 loss")
    out["step_ms"] = walls
    del states
    # toy stages 256 wide, 8 microbatches of 32 rows a data row
    out["gpipe"] = gpipe_deltas(grid, dev, width=256, n_micro=8, mb=32,
                                seed=SEED + 21)
    return out


def model_axis_rank(rank: int, world: int, port: int, backend: str,
                    device: str, inputs: str, result: str) -> None:
    """One rank of the model_axis phase's grid (a spawned process)."""
    import torch.distributed as dist

    from mmqg_tpu_torch import checkpoint as ckpt_io
    from mmqg_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = TF32
    torch.backends.cudnn.allow_tf32 = TF32
    dev = torch.device(device)
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:       # rehearsed on the CPU: the ranks share its cores
        torch.set_num_threads(1)
    multihost.initialize_multihost(f"localhost:{port}", world, rank,
                                   device=dev, backend=backend,
                                   timeout_s=MA_TIMEOUT)
    blob = ckpt_io.msgpack_restore(Path(inputs).read_bytes())
    grid = multihost.Grid(tuple(int(x) for x in blob["shape"]))
    print(f"model_axis: rank {rank} at {grid} backend "
          f"{dist.get_backend()} on {dev}\n", end="", flush=True)
    torch.save(_ma_steps(blob, grid, device), result)
    dist.destroy_process_group()


def _ma_grid(card: str, model, shape, device: str) -> dict:
    """The model_axis phase's ranks on a ``shape`` grid, checked."""
    from mmqg_tpu_torch import checkpoint as ckpt_io

    mc, params, state, vocab, i2w = model
    world = shape[0] * shape[1]
    host = batch_arrays(SyntheticCorpus(mc, i2w, 1, MA_B * shape[0],
                                        SEED + 20, max_audio_s=8).batch(0))
    caps = dict(audio_cap=DEC.audio_bucket(mc, host["audio_len"]),
                frames_cap=DEC.frames_bucket(mc, host["frames_len"]))
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device="cpu",
                      dtype=torch.float32)
    req = pipe._pack(*requests(mc, N_REQUESTS, SEED + 1))
    rcaps = dict(audio_cap=DEC.audio_bucket(mc, req["audio_len"]),
                 frames_cap=DEC.frames_bucket(mc, req["frames_len"]))
    cards = torch.cuda.device_count() if device == "cuda" else 0
    backend = "nccl" if device == "cuda" and cards >= world else "gloo"
    with tempfile.TemporaryDirectory(prefix="mmqg_model_axis_") as tmp:
        inputs = Path(tmp) / "inputs.msgpack"
        # He-scaled VGGish convs, so the audio attention has gradients to
        # compare (he_vggish, as phase 10)
        inputs.write_bytes(ckpt_io.msgpack_serialize({
            "params": he_vggish(params), "model_state": state, "host": host,
            "caps": {k: np.int64(v) for k, v in caps.items()},
            "requests": req,
            "request_caps": {k: np.int64(v) for k, v in rcaps.items()},
            "shape": np.asarray(shape, np.int64),
            "mc": json.dumps(mc._asdict())}))
        if device == "cuda":
            torch.cuda.empty_cache()        # the ranks may share the card
        ranks = _spawn_ranks("model_axis", model_axis_rank, world, backend,
                             device, inputs, Path(tmp), MA_TIMEOUT)
    where = ("the CPU (a rehearsal)" if device != "cuda" else
             "one card: the processes test the split and the collectives, "
             "not scaling" if backend == "gloo" else f"{world} cards")
    log(f"model_axis: grid {shape} (data, model), {backend}, {where}; "
        f"{MA_B} rows a data row, Adam lr 1e-4, caps {caps}")
    want_k4 = {"persistent": mc.text_layers + 1, "per_step": 0}
    for out in ranks:
        r, f = out["rank"], out["f32"]
        log(f"model_axis: rank {r} f32 step: loss {f['loss']:.6f} vs one "
            f"process {f['ref_loss']:.6f}; worst gradient leaf "
            f"{f['worst'][1]} {f['worst'][0]:.2e} of its max (tol "
            f"{MA_RTOL:.0e}), conv towers' worst {f['worst_tower'][1]} "
            f"{f['worst_tower'][0]:.2e} (tol {MA_TOWER_RTOL:.0e}); "
            f"{f['split']} of {f['leaves']} parameter leaves split, vocab "
            f"projection column-parallel {f['vocab_parallel']}; K4 launches "
            f"fwd {out['launches']['lstm_train_fwd']} bwd "
            f"{out['launches']['lstm_train_bwd']}, routes fwd "
            f"{out['fwd_routes']} bwd {out['bwd_routes']} [{card}]")
        if f["bad"] or abs(f["loss"] - f["ref_loss"]) > MA_LOSS_RTOL * abs(
                f["ref_loss"]) or not f["vocab_parallel"]:
            raise AssertionError(f"model_axis: rank {r} f32 step differs "
                                 f"from one process: {f['bad']}")
        if device == "cuda" and (out["fwd_routes"] != want_k4
                                 or out["bwd_routes"] != want_k4):
            raise AssertionError(f"model_axis: rank {r} K4 routes")
        log(f"model_axis: rank {r} SP (gather-free) f32 step loss "
            f"{out['sp_loss']:.6f} vs {f['loss']:.6f}")
        if abs(out["sp_loss"] - f["loss"]) > MA_LOSS_RTOL * abs(f["loss"]):
            raise AssertionError(f"model_axis: rank {r} SP loss")
        held, rule = out["held"], out["rule"]
        log(f"model_axis: rank {r} holds between steps: parameters "
            f"{held['params'] / 2 ** 20:.1f} MiB (rule "
            f"{rule['params'] / 2 ** 20:.1f}, whole "
            f"{rule['whole_params'] / 2 ** 20:.1f}), optimizer state "
            f"{held['opt_state'] / 2 ** 20:.1f} MiB (rule "
            f"{rule['opt_state'] / 2 ** 20:.1f}); the model group's "
            f"all-gather of the {out['gather_mib']:.1f} MiB of split leaves "
            f"alone {out['gather_ms']:.1f} ms [{card}]")
        if held != {k: rule[k] for k in held}:
            raise AssertionError(f"model_axis: rank {r} holds {held}")
        for gf, d in out["sp_decode"].items():
            log(f"model_axis: rank {r} sp_greedy_decode gather_free={gf}: "
                f"{d['equal_rows']} of {d['rows']} rows equal the unsharded "
                f"greedy tokens (f32); launches {d['launches']}")
            if d["equal_rows"] != d["rows"]:
                raise AssertionError(f"model_axis: rank {r} SP decode "
                                     f"gather_free={gf}")
        log(f"model_axis: rank {r} bf16 step ms in turns: " + ", ".join(
            f"{k} " + " / ".join(f"{t:.1f}" for t in v)
            for k, v in out["step_ms"].items()) + f" [{card}]")
        pp = out["gpipe"]
        log(f"model_axis: rank {r} GPipe {pp['stages']} stages: forward "
            f"{pp['fwd']:.1e}, gradients {pp['grad']:.1e} of their max vs "
            f"the sequential stack (tol {MA_PP_TOL:.0e}); {pp['ms']:.1f} ms "
            f"forward + backward [{card}]")
        if pp["fwd"] > MA_PP_TOL or pp["grad"] > MA_PP_TOL:
            raise AssertionError(f"model_axis: rank {r} GPipe")
    k4 = {k: sum(o["launches"][k] for o in ranks)
          for k in ("lstm_train_fwd", "lstm_train_bwd")}
    if device == "cuda" and any(v != world * (mc.text_layers + 1)
                                for v in k4.values()):
        raise AssertionError(f"model_axis: K4 launches {k4}")
    return {"backend": backend, "shape": shape, "k4": k4,
            "sp_decode_launches": ranks[0]["sp_decode"],
            "step_ms": {k: float(np.median([t for o in ranks
                                            for t in o["step_ms"][k]]))
                        for k in ranks[0]["step_ms"]},
            "gather_ms": float(np.median([o["gather_ms"] for o in ranks])),
            "gather_mib": ranks[0]["gather_mib"],
            "held_mib": {k: v / 2 ** 20 for k, v in ranks[0]["held"].items()},
            "gpipe_ms": ranks[0]["gpipe"]["ms"]}


def _ma_serving(card: str, model, device: str) -> dict:
    """QGPipeline.shard(shape=(1, 2)): the 32 requests greedy and by beam
    (f32) against the unsharded pipeline, with the launches of a replica
    row."""
    from mmqg_tpu_torch.parallel import make_mesh

    mc, params, state, vocab, i2w = model
    req = requests(mc, N_REQUESTS, SEED + 1)
    cards = torch.cuda.device_count() if device == "cuda" else 0
    devices = ([torch.device(device, i) for i in range(2)] if cards > 1
               else [torch.device(device, 0)] * 2)
    mesh = make_mesh((1, 2), devices=devices)
    pipe = QGPipeline(None, mc, params, state, vocab, i2w, device=device,
                      dtype=torch.float32)
    sharded = copy.copy(pipe).shard(mesh)
    held = sharded.replicas.stores[0].held_bytes()
    pipe.generate(*req)                       # warm-up
    sharded.generate(*req)
    _reset_launches()
    ref = pipe.generate(*req)
    single = _launches()
    _reset_launches()
    got = sharded.generate(*req)
    launches = _launches()
    if device == "cuda":        # the routes are read here, before timing
        check_dp_launches(single, launches, 1)
    walls = {"unsharded": [], "sharded": []}
    for name in ("unsharded", "sharded", "sharded", "unsharded"):
        walls[name].append(_wall_questions(
            pipe if name == "unsharded" else sharded, req))
    log(f"model_axis: shard(shape=(1, 2)) over {[str(d) for d in devices]}: "
        f"the split leaves {', '.join(f'{b / 2 ** 20:.1f}' for b in held)} "
        f"MiB a device between batches; f32 greedy generate() of "
        f"{N_REQUESTS} requests in turns: " + ", ".join(
            f"{k} " + " / ".join(f"{t:.1f}" for t in v) + " ms"
            for k, v in walls.items())
        + f" [{card}]; launches unsharded {single}, sharded {launches}")
    same = {"greedy": got == ref,
            "beam": sharded.generate(*req, strategy="beam",
                                     beam_size=BEAM_SIZE)
            == pipe.generate(*req, strategy="beam", beam_size=BEAM_SIZE)}
    log(f"model_axis: f32 shard(shape=(1, 2)) == unsharded questions {same}")
    if not all(same.values()):
        raise AssertionError(f"model_axis: tensor-parallel serving {same}")
    sharded.replicas.close()
    return {"launches": launches, "held_mib": [b / 2 ** 20 for b in held],
            "generate_ms": {k: float(np.median(v)) for k, v in walls.items()}}


def phase_model_axis(card: str, model, device: str = "cuda") -> dict:
    """20. model_axis: tensor and sequence parallelism, GPipe and the
    multichip dry run at the flagship's full width (``device`` "cpu"
    rehearses it, with the kernels' plain versions)."""
    from mmqg_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    cards = torch.cuda.device_count() if device == "cuda" else 0
    grids = {"1x2": _ma_grid(card, model, (1, 2), device)}
    if cards >= 4:
        grids["2x2"] = _ma_grid(card, model, (2, 2), device)
    serving = _ma_serving(card, model, device)
    t1 = time.perf_counter()
    dry = dryrun_multichip(cards if cards > 1 else 4, device=device)
    log(f"model_axis: dryrun_multichip {dry['mesh']} over {dry['backend']} "
        f"in {time.perf_counter() - t1:.1f} s")
    wall = time.perf_counter() - t0
    log(f"model_axis: phase wall {wall:.1f} s")
    return {"grids": grids, "serving": serving,
            "dryrun": {k: v for k, v in dry.items() if k != "pp"},
            "wall_s": wall}


class Clock:
    """Wall seconds by phase, printed as each ends and summed at the end."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.phases = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = now - self.last
        self.last = now
        log(f"phase {name}: {self.phases[name]:.1f} s")


def main_dp_clis() -> None:
    """``--dp-clis``: the data-parallel CLIs over every visible card."""
    dev = phase_device()
    phase_build()
    log("dp-clis: " + json.dumps(phase_dp_clis(dev["card"])))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))


def main() -> None:
    clock = Clock()
    dev = phase_device()
    phase_build()
    clock.lap("device+build")
    k1 = phase_k1(dev["card"])
    k2 = phase_k2(dev["card"])
    k4 = phase_k4(dev["card"])
    clock.lap("K1+K2+K4")
    model = flagship()
    launches = phase_main(dev["card"], model)
    phase_card_vs_cpu(model)
    clock.lap("main+card/cpu")
    strategies = phase_strategies(dev["card"], model)
    clock.lap("strategies")
    train_launches = phase_train(dev["card"], model)
    phase_train_card_vs_cpu(model)
    clock.lap("train+train card/cpu")
    serving = he_serving(model)
    k3 = phase_k3(dev["card"], serving)
    int8 = phase_int8(dev["card"], serving)
    phase_calibrate(dev["card"], serving)
    clock.lap("K3+int8+calibrate")
    with tempfile.TemporaryDirectory(prefix="mmqg_smoke_") as root:
        t0 = time.perf_counter()
        jobs, durations = make_lectures(root, alpha_vocab(N_VOCAB)[1])
        log(f"video: fixtures written in {time.perf_counter() - t0:.1f} s")
        video = phase_video(dev["card"], model, jobs, durations)
        phase_serve(dev["card"], model, video, root)
    clock.lap("video+serve")
    configs = phase_configs(dev["card"])
    clock.lap("configs")
    window = phase_window_attention(dev["card"])
    clock.lap("window_attention")
    dp = phase_dp(dev["card"])
    clock.lap("dp")
    offline = phase_offline(dev["card"], model)
    clock.lap("offline")
    features = phase_train_features(dev["card"], model)
    clock.lap("train_features")
    axis = phase_model_axis(dev["card"], model)
    clock.lap("model_axis")
    log(f"phases: {time.perf_counter() - clock.t0:.1f} s in all")
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "mmqg_tpu", "flax",
                                     "optax", "orbax")]
    if loaded:
        raise AssertionError(f"JAX, flax, optax, orbax or the JAX package "
                             f"was imported: {loaded}")
    by_config = {name: c["launches"]["greedy"]
                 for name, c in configs["serving"].items()}
    trained = {config_name(CONFIG_CASES[0]): configs["train"]["launches"],
               config_name(CONFIG_CASES[1]):
                   configs["train"]["non_attn_launches"]}

    def per_config(kernel: str, runs=by_config) -> dict:
        """A kernel's launches in one greedy generate() (one train step)
        of each configuration of phase 16."""
        return {name: counts[kernel] for name, counts in runs.items()}

    def on_features(kernel: str) -> dict:
        """A kernel's launches on phase 19's paths: the profiled Trainer
        epoch and its validate() (this process), and one f32 step of each
        mode over the two ranks (their counters summed)."""
        out = {"trainer_epoch": features["trainer"]["launches"][kernel],
               "validate": features["trainer"]["validate_launches"][kernel]}
        if kernel.startswith("lstm_train"):
            out["ranks_f32_step"] = {
                mode: counts[kernel] for mode, counts in
                features["ranks"]["launches"].items()}
        return out

    def on_offline(kernel: str) -> dict:
        """A kernel's launches on phase 18's paths: the measured epoch on
        the prepared corpus, its validate(), and one f32 generate() of the
        imported reference checkpoint."""
        return {"train_epoch": offline["train"]["launches"][kernel],
                "steps": offline["train"]["steps"],
                "validate": offline["train"]["validate_launches"][kernel],
                "imported_generate": offline["bridges"]["launches"][kernel]}

    def on_axis(kernel: str) -> dict:
        """A kernel's launches on phase 20's paths: one greedy generate()
        of shard(shape=(1, 2)) (one replica row), rank 0's SP decodes
        (f32, both modes) and the f32 tensor-parallel step of each grid
        (its ranks' counters summed)."""
        out = {"tp_serving_greedy": axis["serving"]["launches"][kernel],
               "sp_decode": {
                   ("gather_free" if gf else "gather"): d["launches"][kernel]
                   for gf, d in axis["grids"]["1x2"]["sp_decode_launches"]
                   .items()}}
        if kernel.startswith("lstm_train"):
            out["tp_step"] = {name: g["k4"][kernel]
                              for name, g in axis["grids"].items()}
        return out

    kernels = [
        {"name": "lstm_seq", "route": "cuda",
         "design": "persistent cooperative sweep (Wh in shared memory, "
                   "mma.sync h.Wh, grid barrier a step) + mma.sync input "
                   "GEMM",
         "source": "mmqg_tpu_torch/csrc/lstm_seq.cu",
         "replaces": "mmqg_tpu/ops/lstm_pallas.py:100",
         "launches": launches["lstm_seq"],
         "launches_by_config": per_config("lstm_seq"),
         "launches_offline": on_offline("lstm_seq"),
         "launches_train_features": on_features("lstm_seq"),
         "launches_model_axis": on_axis("lstm_seq"),
         "launches_dp": dp["serving"]["launches"]["lstm_seq"], **k1},
        {"name": "trimodal_attention", "route": "cuda",
         "design": "blocks of 16 batch rows x 16 positions x 128 memory "
                   "columns, mma.sync bf16 scores, flash-decoding partials "
                   "merged by the last block of each tile (atomic counter)",
         "source": "mmqg_tpu_torch/csrc/trimodal_attention.cu",
         "replaces": "mmqg_tpu/ops/attention_pallas.py:83",
         "launches": launches["trimodal_attention"],
         "launches_by_config": per_config("trimodal_attention"),
         "launches_offline": on_offline("trimodal_attention"),
         "launches_train_features": on_features("trimodal_attention"),
         "launches_model_axis": on_axis("trimodal_attention"),
         "launches_dp": dp["serving"]["launches"]["trimodal_attention"],
         **strategies, **k2},
        {"name": "lstm_train_fwd", "route": "cuda",
         "design": "K1's persistent sweep emitting h, c and gates + "
                   "mma.sync input GEMM",
         "source": "mmqg_tpu_torch/csrc/lstm_train.cu",
         "replaces": "mmqg_tpu/ops/lstm_train_pallas.py:147",
         "launches": train_launches["lstm_train_fwd"],
         "launches_by_config": per_config("lstm_train_fwd", trained),
         "launches_offline": on_offline("lstm_train_fwd"),
         "launches_train_features": on_features("lstm_train_fwd"),
         "launches_model_axis": on_axis("lstm_train_fwd"),
         "launches_dp": dp["training"]["launches"][2]["lstm_train_fwd"],
         **k4["fwd"]},
        {"name": "lstm_train_bwd", "route": "cuda",
         "design": "persistent sweep + mma.sync GEMMs",
         "source": "mmqg_tpu_torch/csrc/lstm_train.cu",
         "replaces": "mmqg_tpu/ops/lstm_train_pallas.py:209",
         "launches": train_launches["lstm_train_bwd"],
         "launches_by_config": per_config("lstm_train_bwd", trained),
         "launches_offline": on_offline("lstm_train_bwd"),
         "launches_train_features": on_features("lstm_train_bwd"),
         "launches_model_axis": on_axis("lstm_train_bwd"),
         "launches_dp": dp["training"]["launches"][2]["lstm_train_bwd"],
         **k4["bwd"]},
        {"name": "vggish_conv", "route": "cuda",
         "design": "wgmma implicit GEMM, 3-stage cp.async ring",
         "source": "mmqg_tpu_torch/csrc/vggish_conv.cu",
         "replaces": "mmqg_tpu/ops/vggish_pallas.py:137",
         "launches_model_axis": on_axis("vggish_conv"), **k3},
        {"name": "vggish_conv_int8", "route": "cuda",
         "design": "s8 wgmma (m64n128k32) implicit GEMM, K3's ring and "
                   "tiles; epilogue folds each example's max or writes the "
                   "next layer's int8 input",
         "source": "mmqg_tpu_torch/csrc/vggish_conv.cu",
         "replaces": "mmqg_tpu/models/audio_encoder.py:157",
         "launches": launches["vggish_conv_int8"],
         "launches_by_config": per_config("vggish_conv_int8"),
         "launches_offline": on_offline("vggish_conv_int8"),
         "launches_train_features": on_features("vggish_conv_int8"),
         "launches_model_axis": on_axis("vggish_conv_int8"),
         "launches_dp": dp["serving"]["launches"]["vggish_conv_int8"],
         **int8["conv"]},
        {"name": "quantize_s8", "route": "cuda",
         "design": "the int8 tower's activation quantize: one pass, 16 "
                   "values a thread (port-only: XLA ops in JAX)",
         "source": "mmqg_tpu_torch/csrc/vggish_conv.cu",
         "replaces": "mmqg_tpu/models/audio_encoder.py:147",
         "launches": launches["quantize_s8"],
         "launches_by_config": per_config("quantize_s8"),
         "launches_offline": on_offline("quantize_s8"),
         "launches_train_features": on_features("quantize_s8"),
         "launches_model_axis": on_axis("quantize_s8"),
         "launches_dp": dp["serving"]["launches"]["quantize_s8"],
         **int8["quant"]},
        {"name": "bn_epilogue", "route": "cuda",
         "design": "one grid-stride pass over a conv output, 8 channels a "
                   "thread: eval batchnorm as one fma, the block's shortcut "
                   "(f32, or the down conv's output through its own "
                   "batchnorm), ReLU, bf16 and/or f32 stores (port-only: "
                   "XLA fuses these in JAX)",
         "source": "mmqg_tpu_torch/csrc/bn_epilogue.cu",
         "replaces": "mmqg_tpu/models/video_resnet.py:101",
         "launches_by_config": {
             name: c["epilogue_launches"]["greedy"]
             for name, c in configs["serving"].items()},
         **configs["serving"][config_name(CONFIG_CASES[0])]["bn_epilogue"]},
        {"name": "window_attention", "route": "cuda",
         "design": "a block of 5 warps per (window, head): K, V and the bias "
                   "table's column in shared memory, mma.sync bf16 scores "
                   "and P.V, an online softmax in exp2, the shift's regions "
                   "and the padded keys from coordinates, windows of "
                   "padding alone written as zeros (port-only: the JAX "
                   "package has no Video Swin encoder)",
         "source": "mmqg_tpu_torch/csrc/window_attention.cu",
         "replaces": "none",
         "launches_a_trunk": WIN_BLOCKS, **window}]
    log("offline: " + json.dumps({
        "stage_ms": offline["stage_ms"], "splits": offline["splits"],
        "train": {k: v for k, v in offline["train"].items()
                  if "launches" not in k},
        "round_trip_s": offline["bridges"]["round_trip_s"],
        "convert_wall_s": offline["convert"]["wall_s"],
        "wall_s": offline["wall_s"]}))
    log("dp: " + json.dumps({
        "replicas": dp["serving"]["replicas"],
        "generate_ms": dp["serving"]["generate_ms"],
        "train": {k: v for k, v in dp["training"].items()
                  if k != "launches"}}))
    log("train_features: " + json.dumps({
        "ranks": features["ranks"], "epoch_ms": features["trainer"][
            "epoch_ms"], "traced": features["trainer"]["traced"],
        "checkpoints": features["checkpoints"],
        "wall_s": features["wall_s"]}))
    log("model_axis: " + json.dumps({
        "grids": {k: {kk: vv for kk, vv in g.items()
                      if kk != "sp_decode_launches"}
                  for k, g in axis["grids"].items()},
        "serving": {k: v for k, v in axis["serving"].items()
                    if k != "launches"},
        "dryrun": axis["dryrun"], "wall_s": axis["wall_s"]}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))


if __name__ == "__main__":
    main_dp_clis() if sys.argv[1:] == ["--dp-clis"] else main()
