"""Fixtures of the benchmark's CPU tests: a copy of ``portbench/``'s data
files with every configuration cut to a tiny size and every mix to a few
requests, so that a whole run (driver, judge, readers) fits on the CPU.
Tests marked ``cuda`` need the card and skip without one."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
PKG = HERE.parent
REPO = PKG.parent

TINY = {"n_vocab": 60, "word_emb_dim": 8, "hidden_dim": 16,
        "text_layers": 2, "dec_layers": 2, "video_hidden_dim": 16,
        "audio_emb_dim": 8, "flatten_dim": 10, "context_max_length": 24,
        "av_max_length": 16, "target_steps": 6, "frame_size": 28}
TINY_MIX = {"bulk_b32": {"batch": 3, "batches": 2, "words": [3, 30],
                         "frames": [2, 12], "audio_s": [1, 2],
                         "judge_sample": 4}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's kernels have no "
        "CPU mode); skipped without one")


def tiny_copy(dst: Path) -> Path:
    """``portbench``'s data files under ``dst``, cut to the tiny size; the
    drivers and readers are copied as they are."""
    for sub in ("configs", "mixes", "workloads", "traffic", "metrics"):
        shutil.copytree(PKG / sub, dst / sub)
    for f in (dst / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update(TINY)
        f.write_text(json.dumps(cfg))
    for f in (dst / "mixes").glob("*.json"):
        mix = json.loads(f.read_text())
        mix.update(TINY_MIX.get(f.stem, {}))
        f.write_text(json.dumps(mix))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_copy(tmp_path / "portbench")


@pytest.fixture
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())
