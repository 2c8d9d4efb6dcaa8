"""chip_smoke.py, rehearsed on the CPU: it refuses to run without a CUDA
device (and alone, without the repo), and its request and pipeline driving
works end to end at a tiny size with the plain kernel versions."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from mmqg_tpu_torch.models.qg_model import ModelConfig, init_params
from mmqg_tpu_torch.ops.attention import trimodal_attention
from mmqg_tpu_torch.ops.lstm import lstm_seq
from mmqg_tpu_torch.pipeline import QGPipeline

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and ("ok" in obj or "kernels" in obj):
            return True
    return False


def test_refuses_without_cuda_and_alone(tmp_path):
    proc = _run(REPO)
    assert proc.returncode != 0 and not _printed_result(proc.stdout)
    assert "no CUDA device" in proc.stderr
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run(tmp_path)
    assert alone.returncode != 0 and not _printed_result(alone.stdout)


def test_main_path_rehearsal_on_cpu():
    """The phase-5/6 driving (requests, pipeline, encode + decode with
    logits) at tiny widths, where every kernel wrapper runs its plain
    version and so counts no launch."""
    mc = ModelConfig(n_vocab=50, word_emb_dim=8, hidden_dim=16, text_layers=2,
                     dec_layers=2, video_hidden_dim=16, audio_emb_dim=8,
                     flatten_dim=10, context_max_length=12, av_max_length=5,
                     target_steps=5, frame_size=32, mel_frames=16,
                     mel_bins=16, sample_rate=1600, stft_window=64,
                     stft_hop=32)
    params, state = init_params(mc, seed=0)
    words = ["<pad>", "<start>", "<end>"] + [f"w{i}" for i in range(3, 50)]
    vocab = {w: i for i, w in enumerate(words)}
    i2w = {str(i): w for i, w in enumerate(words)}
    pipe = QGPipeline(None, mc, params, state, vocab, i2w,
                      dtype=torch.float32)
    req = chip_smoke.requests(mc, 3, seed=1)
    assert all(1 <= len(f) <= mc.av_max_length for f in req[1])
    lstm_seq.launches = trimodal_attention.launches = 0
    questions = pipe.generate(*req)
    assert len(questions) == 3
    assert lstm_seq.launches == 0 and trimodal_attention.launches == 0
    mem, toks, logits = chip_smoke._encode_decode(pipe, req)
    assert tuple(logits.shape) == (4, mc.target_steps - 1, mc.n_vocab)
    assert bool(torch.isfinite(logits).all())
    assert questions == pipe._to_words(toks.numpy())[:3]
    np.testing.assert_array_equal(mem.text_len.numpy()[3:], 1)
