"""Build and drive the PyTorch + CUDA port (mmqg_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device   the card's name and power limit (nvidia-smi), torch/CUDA/nvcc
2. build    nvcc builds the kernels in mmqg_tpu_torch/csrc/ (seconds)
3. K1       lstm_seq kernel vs its plain PyTorch version, on the card
4. K2       trimodal_attention kernel vs its plain version, on the card
5. main     QGPipeline at the flagship's full width (random weights from a
            seed) answers 32 greedy requests; K1 must launch 4x per encode
            and K2 21x per decode
6. card/cpu the same pipeline in f32 on 4 requests, on the card and on the
            CPU: identical greedy tokens, logits within a stated tolerance

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.models.qg_model import ModelConfig, init_params
from mmqg_tpu_torch.ops import _build
from mmqg_tpu_torch.ops.attention import (trimodal_attention,
                                          trimodal_attention_plain)
from mmqg_tpu_torch.ops.lstm import lstm_seq, lstm_seq_plain
from mmqg_tpu_torch.pipeline import QGPipeline

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


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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
    got = lstm_seq(*args, dtype=dtype)
    ref = lstm_seq_plain(*args, dtype=dtype)
    torch.cuda.synchronize()
    err = max(max_abs(g, r) for g, r in zip(got, ref))
    ms = cuda_ms(lambda: lstm_seq(*args, dtype=dtype))
    plain_ms = cuda_ms(lambda: lstm_seq_plain(*args, dtype=dtype), iters=3)
    return err, ms, plain_ms


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
    shapes = (("text layer 0", 32, 283, 300, 512),
              ("text layer 1", 32, 283, 512, 512),
              ("video", 32, 101, 1000, 512))
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, T, In, H in shapes:
            err, ms, plain_ms = _k1_case(rng, B, T, In, H, dtype, dev)
            log(f"K1 lstm_seq {name} B={B} T={T} In={In} H={H} "
                f"{str(dtype)[6:]}: max|d|={err:.3e} (tol "
                f"{K1_TOL[dtype]:.0e}) kernel {ms:.3f} ms plain "
                f"{plain_ms:.3f} ms [{card}]")
            if not err <= K1_TOL[dtype]:
                raise AssertionError(f"K1 {name} {dtype}: max|d| {err} > "
                                     f"{K1_TOL[dtype]}")
            if dtype == torch.bfloat16 and name == "text layer 0":
                summary = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return summary


def _k2_case(rng, B, dtype, dev):
    Dq, Lt, La, Ht, Hv, Ha = 812, 283, 101, 512, 512, 128

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)
    w_t = t(rng.randn(Lt + 2 * La, Dq) / np.sqrt(Dq))
    b = t(rng.randn(Lt + 2 * La), torch.float32)
    q = t(rng.randn(B, Dq))
    mems = [t(rng.randn(B, L, Hm)) for L, Hm in ((Lt, Ht), (La, Hv), (La, Ha))]
    lens = [torch.from_numpy(rng.randint(1, L + 1, B).astype(np.int32)).to(dev)
            for L in (Lt, La, La)]
    args = (w_t, b, q, *mems, *lens)
    got = trimodal_attention(*args)
    ref = trimodal_attention_plain(*args)
    torch.cuda.synchronize()
    err = max(max_abs(g, r) for g, r in zip(got[:3], ref[:3]))
    err = max([err] + [max_abs(got[3][k], ref[3][k]) for k in got[3]])
    ms = cuda_ms(lambda: trimodal_attention(*args), iters=50)
    plain_ms = cuda_ms(lambda: trimodal_attention_plain(*args), iters=20)
    return err, ms, plain_ms


def phase_k2(card: str) -> dict:
    rng = np.random.RandomState(SEED + 1)
    dev = torch.device("cuda")
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B in (32, 128):
            err, ms, plain_ms = _k2_case(rng, B, dtype, dev)
            log(f"K2 trimodal_attention B={B} Dq=812 L=283/101/101 "
                f"{str(dtype)[6:]}: max|d|={err:.3e} (tol "
                f"{K2_TOL[dtype]:.0e}) kernel {ms:.4f} ms plain "
                f"{plain_ms:.4f} ms [{card}]")
            if not err <= K2_TOL[dtype]:
                raise AssertionError(f"K2 B={B} {dtype}: max|d| {err} > "
                                     f"{K2_TOL[dtype]}")
            if dtype == torch.bfloat16 and B == 32:
                summary = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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


def _encode_decode(pipe, req):
    """(memories, tokens, logits) of one request batch, through the same
    functions generate() runs."""
    host = pipe._pack(*req)
    mem, state = DEC.encode(pipe.model, pipe.mc, pipe._to_device(host),
                            audio_cap=DEC.audio_bucket(pipe.mc,
                                                       host["audio_len"]),
                            frames_cap=DEC.frames_bucket(pipe.mc,
                                                         host["frames_len"]),
                            dtype=pipe.dtype)
    toks, logits = DEC.decode_from_memories(
        pipe.model, mem, state, max_len=pipe.mc.target_steps - 1,
        dtype=pipe.dtype, return_logits=True)
    return mem, toks, logits


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
        "tower: bf16 VGGish (embed_examples) -- the JAX package's int8 "
        "serving variant (audio_int8_serving) is not ported")
    pipe.generate(*req)                      # warm-up: cuDNN plans, caches
    torch.cuda.synchronize()

    lstm_seq.launches = 0
    trimodal_attention.launches = 0
    t0 = time.perf_counter()
    questions = pipe.generate(*req, strategy="greedy")
    wall = time.perf_counter() - t0
    launches = {"lstm_seq": lstm_seq.launches,
                "trimodal_attention": trimodal_attention.launches}
    want = {"lstm_seq": mc.text_layers + 1,
            "trimodal_attention": mc.target_steps - 1}
    log(f"main: one generate() of {N_REQUESTS} requests launched {launches}"
        f" (want {want}: {mc.text_layers} text layers + 1 video layer per "
        f"encode, {mc.target_steps - 1} attention steps per decode)")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    if len(questions) != N_REQUESTS or not all(
            isinstance(q, str) for q in questions):
        raise AssertionError("generate() did not return one string a request")

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
    mem, toks, logits = _encode_decode(pipe, req)
    finite = all(bool(torch.isfinite(m).all()) for m in mem[:3])
    if not (finite and bool(torch.isfinite(logits).all())):
        raise AssertionError("non-finite memories or logits")
    if tuple(logits.shape) != (N_REQUESTS, mc.target_steps - 1, mc.n_vocab):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    log(f"main: greedy batch {N_REQUESTS}: {N_REQUESTS / wall:.1f} "
        f"questions/s ({wall * 1e3:.1f} ms generate(), host packing "
        f"included); encode {np.median(enc_ms):.2f} ms, decode "
        f"{np.median(dec_ms):.2f} ms (median of 3, caps "
        f"audio={caps['audio_cap']} frames={caps['frames_cap']}) [{card}]")
    log(f"main: e.g. {questions[0][:80]!r}")
    return launches


def phase_card_vs_cpu(model) -> None:
    """The same f32 pipeline on 4 requests on the card (kernels) and on the
    CPU (plain versions): identical greedy tokens, logits within LOGIT_TOL."""
    mc, params, state, vocab, i2w = model
    req = tuple(r[:4] for r in requests(mc, N_REQUESTS, SEED + 2))
    out = {}
    for device in ("cuda", "cpu"):
        pipe = QGPipeline(None, mc, params, state, vocab, i2w, device=device,
                          dtype=torch.float32)
        _, toks, logits = _encode_decode(pipe, req)
        out[device] = (toks.cpu(), logits.cpu())
    same = torch.equal(out["cuda"][0], out["cpu"][0])
    err = max_abs(out["cuda"][1], out["cpu"][1])
    log(f"card vs cpu (f32, 4 requests, {mc.target_steps - 1} steps): greedy"
        f" tokens identical={same}; logits max|d|={err:.3e} (tol "
        f"{LOGIT_TOL:.0e})")
    if not same or not err <= LOGIT_TOL:
        raise AssertionError("card and CPU disagree")


# f32 logits, card vs CPU: the parity contract's 1e-5. cuBLAS/cuDNN and the
# CPU libraries sum in other orders through the VGGish stack and 283 + 21
# recurrent steps; measured 4.8e-7 on an H100 (700 W).
LOGIT_TOL = 1e-5


def main() -> None:
    dev = phase_device()
    phase_build()
    k1 = phase_k1(dev["card"])
    k2 = phase_k2(dev["card"])
    model = flagship()
    launches = phase_main(dev["card"], model)
    phase_card_vs_cpu(model)
    kernels = [
        {"name": "lstm_seq", "route": "cuda",
         "source": "mmqg_tpu_torch/csrc/lstm_seq.cu",
         "replaces": "mmqg_tpu/ops/lstm_pallas.py:100",
         "launches": launches["lstm_seq"], **k1},
        {"name": "trimodal_attention", "route": "cuda",
         "source": "mmqg_tpu_torch/csrc/trimodal_attention.cu",
         "replaces": "mmqg_tpu/ops/attention_pallas.py:83",
         "launches": launches["trimodal_attention"], **k2}]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))


if __name__ == "__main__":
    main()
