"""Test harness: force an 8-device virtual CPU platform BEFORE jax initialises
so multi-chip sharding logic is exercised without TPU hardware (SURVEY.md §4).
One shared bootstrap with the driver's dryrun gate — see
mmqg_tpu/parallel/bootstrap.py for the why of each step."""

from mmqg_tpu.parallel.bootstrap import force_virtual_cpu_devices

force_virtual_cpu_devices(8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mmqg_tpu.config import Config  # noqa: E402


def pytest_runtest_logreport(report):
    """When MMQG_CASE_LOG names a file, append each finished case's outcome
    as it completes (line-flushed). The mesh-suite wrapper
    (test_parallel.py) sets this in its CHILD pytest so an XLA:CPU
    rendezvous SIGABRT mid-suite loses only the in-flight case: the retry
    deselects everything already completed instead of re-running ~35 min
    of passed cases (round-4 VERDICT weak #6)."""
    import os
    path = os.environ.get("MMQG_CASE_LOG")
    if path and report.when == "call":
        with open(path, "a") as f:
            f.write(f"{report.outcome} {report.nodeid}\n")
            f.flush()


def pytest_collection_modifyitems(config, items):
    """Run the virtual-mesh suite FIRST, the end-to-end suite last.

    The mesh tests' collectives are the part of the suite vulnerable to
    XLA:CPU's rendezvous-starvation abort (root cause + real fix: the
    timeout flags above; history in NOTES_NEXT_ROUND.md "Known flake",
    repro in scripts/repro_cpu_mesh_abort.py). Running them first — before
    the box is busy with the long e2e compiles — keeps even the warning
    path quiet."""
    def key(item):
        path = str(item.fspath)
        if path.endswith("test_parallel.py"):
            return -1
        return 1 if path.endswith("test_end_to_end.py") else 0
    items.sort(key=key)


@pytest.fixture(scope="session")
def tiny_config(tmp_path_factory) -> Config:
    """A miniature Config: tiny sequence lengths / frames / audio so every
    test compiles in seconds on CPU."""
    root = tmp_path_factory.mktemp("tiny")
    from mmqg_tpu.models.video_encoder import flatten_dim_for

    return Config(
        output_path=root / "results",
        dataset_path=root / "dataset",
        data_path=root / "data",
        glove_path=root / "glove.6B",
        glove_emb_dim=8,
        epochs=2,
        batch_size=4,
        eval_batch_size=4,
        question_max_length=6,
        context_max_length=12,
        av_max_length=3,
        frame_size=32,
        flatten_dim=flatten_dim_for(32),
        video_hidden_dim=16,
        text_lstm_hidden_dim=16,
        text_lstm_layers=2,
        dec_lstm_hidden_dim=16,
        dec_lstm_layers=2,
        audio_emb=8,
        audio_sample_rate=1600,
        stft_window=64,
        stft_hop=32,
        mel_bins=16,
        mel_frames_per_example=16,
        use_pallas=False,
    ).ensure_dirs()


@pytest.fixture(scope="session")
def tiny_corpus(tiny_config):
    """Synthetic corpus + artifacts on disk (frames npy, wav clips, splits)."""
    from tests.fixtures import build_tiny_corpus

    return build_tiny_corpus(tiny_config, n_questions=12, seed=0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the PyTorch port's "
        "CUDA kernels have no CPU mode); skipped without one")
