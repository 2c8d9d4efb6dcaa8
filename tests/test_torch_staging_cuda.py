"""Reused page-locked staging on the card (``mmqg_tpu_torch/staging.py``
through ``QGPipeline._pack`` / ``_to_device``): a block is never written
while its copy to the card is in flight, and calls dispatched back to back
each get their own questions. Every test needs an NVIDIA GPU and nvcc (the
port's kernels have no CPU mode) and skips without them. The file imports no
JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_staging_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from mmqg_tpu_torch import pipeline as PL
from mmqg_tpu_torch.models.qg_model import ModelConfig, init_params

pytestmark = pytest.mark.cuda

N_VOCAB = 64
# ~1 s of the card's clock: the stream is held while a test dispatches
HOLD_CYCLES = 2_000_000_000


@pytest.fixture(scope="module")
def pipe():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU "
                    "mode")
    from mmqg_tpu_torch.ops import _build
    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    mc = ModelConfig(n_vocab=N_VOCAB)          # the flagship's widths
    params, state = init_params(mc, seed=0)
    # a random decoder gives every input the same question: scale it up,
    # as a trained one is, so that the questions follow the inputs
    rng = np.random.RandomState(1)
    dec = params["decoder"]
    for layer in dec["lstm"]["layers"]:
        layer["wx"], layer["wh"] = layer["wx"] * 4, layer["wh"] * 4
    dec["out"]["w"] = dec["out"]["w"] * 20
    dec["out"]["b"] = (0.5 * rng.randn(*dec["out"]["b"].shape)).astype(
        np.float32)
    params["embedding"]["table"] = params["embedding"]["table"] * 4
    words = ["<pad>", "<start>", "<end>"] + [f"w{i}" for i in
                                             range(3, N_VOCAB)]
    return PL.QGPipeline(None, mc, params, state,
                         {w: i for i, w in enumerate(words)},
                         {str(i): w for i, w in enumerate(words)},
                         device="cuda")


def _batch(mc, n, frames, seconds, seed):
    """``n`` requests whose frame counts and audio lengths are drawn from
    ``frames`` and ``seconds`` by a fixed generator (so two seeds give the
    same shapes) and whose contents are drawn from ``seed``."""
    shapes = np.random.RandomState(n)
    counts = shapes.randint(frames[0], frames[1] + 1, n)
    lengths = shapes.randint(seconds[0] * mc.sample_rate,
                             seconds[1] * mc.sample_rate + 1, n)
    rng = np.random.RandomState(seed)
    fs = mc.frame_size
    return ([" ".join(f"w{w}" for w in rng.randint(3, N_VOCAB, 60))
             for _ in range(n)],
            [rng.randint(0, 256, (c, fs, fs, 3), np.uint8) for c in counts],
            [(rng.randn(s) * 3000).astype(np.int16) for s in lengths])


def _batches(mc):
    """Two batches of other shapes, then a third of the first's shapes
    with other contents."""
    return (_batch(mc, 8, (60, 101), (20, 32), seed=1),
            _batch(mc, 4, (20, 40), (8, 12), seed=2),
            _batch(mc, 8, (60, 101), (20, 32), seed=3))


def test_a_copy_in_flight_is_not_overwritten(pipe):
    """The stream is held, three batches are packed and shipped, the first
    and third into the same layout: the host does not wait for the copies,
    the third pack waits for the first's blocks, and every batch reaches
    the card as packed."""
    batches = _batches(pipe.mc)
    want = [{k: v.copy() for k, v in pipe._pack(*b).items()}
            for b in batches]
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    first = pipe._to_device(pipe._pack(*batches[0]))
    enqueued = time.perf_counter() - t0
    got = [first] + [pipe._to_device(pipe._pack(*b)) for b in batches[1:]]
    torch.cuda.synchronize()
    assert enqueued < 0.3, enqueued      # the copies did not wait
    for w, g in zip(want, got):
        for k, t in g.items():
            assert torch.equal(t.cpu(), torch.from_numpy(w[k])), k
    assert all(b.mem.is_pinned() for s in pipe._staging._slots
               for b in s.blocks.values())


def test_async_calls_each_get_their_own_questions(pipe):
    """Two calls of other shapes dispatched back to back behind a held
    stream, then a third of the first's shapes: each returns its own
    synchronous generate()'s questions, every call ships from page-locked
    staging, and a second pass allocates nothing."""
    batches = _batches(pipe.mc)
    want = [pipe.generate(*b) for b in batches]
    assert want[0] != want[2]
    before = dict(PL.h2d_staged)
    allocated = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        finishers = [pipe.generate_async(*b) for b in batches]
        assert [f() for f in finishers] == want
        allocated.append(PL.h2d_staged["allocated"])
    assert PL.h2d_staged["pinned"] - before["pinned"] == 6
    assert PL.h2d_staged["pageable"] == before["pageable"]
    assert allocated[1] == allocated[0]
    assert len(pipe._staging._slots) == 2
