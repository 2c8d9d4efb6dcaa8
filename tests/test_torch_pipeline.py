"""QGPipeline of the PyTorch port: packing vs the JAX pipeline, generate vs
its own decode_batch + tokens_to_words, and the no-JAX import rule."""

import functools
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu import decode as JDEC
from mmqg_tpu.models import qg_model as JQ
from mmqg_tpu.pipeline import QGPipeline as JaxPipeline
from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch.models import qg_model as TQ
from mmqg_tpu_torch.pipeline import QGPipeline, row_seed_array
from mmqg_tpu_torch.utils import prng
from tests.torch_port_fixtures import tiny_model

torch.set_num_threads(1)
N_VOCAB = 40


def _vocab():
    words = ["<pad>", "<start>", "<end>"] + [f"w{i}" for i in range(3, N_VOCAB)]
    return ({w: i for i, w in enumerate(words)},
            {str(i): w for i, w in enumerate(words)})


@pytest.fixture(scope="module")
def pipes(tiny_config):
    mc, params, state = tiny_model(tiny_config, n_vocab=N_VOCAB, seed=4)
    vocab, i2w = _vocab()
    jax_pipe = JaxPipeline(tiny_config, mc, params, state, vocab, i2w)
    port = QGPipeline(tiny_config, TQ.ModelConfig(**mc._asdict()), params,
                      state, vocab, i2w, device="cpu", dtype=torch.float32)
    return jax_pipe, port, (params, state, vocab, i2w)


def _requests(cfg, n, seed):
    rng = np.random.RandomState(seed)
    fs, rate = cfg.frame_size, cfg.audio_sample_rate
    contexts = [" ".join(f"w{rng.randint(3, N_VOCAB)}" if rng.rand() > 0.2
                         else "unknownword"
                         for _ in range(rng.randint(0, 20))) for _ in range(n)]
    frames = [None if i % 3 == 2 else
              rng.randint(0, 256, (rng.randint(1, 6), fs, fs, 3), np.uint8)
              for i in range(n)]
    audio = [None if i % 4 == 3 else
             (rng.randn(rng.randint(10, 4 * rate)) * 3000).astype(np.int16)
             if i % 2 else
             (rng.randn(rng.randint(10, 4 * rate)) * 0.3).astype(np.float32)
             for i in range(n)]
    return contexts, frames, audio


@pytest.mark.parametrize("n,seed,caps", [(1, 0, {}), (3, 1, {}), (5, 2, {}),
                                         (4, 3, {"frames_cap": 2}),
                                         (4, 4, {"audio_cap": 1}),
                                         (2, 5, {"frames_cap": 9,
                                                 "audio_cap": 9})])
def test_pack_matches_jax_byte_for_byte(pipes, tiny_config, n, seed, caps):
    jax_pipe, port, _ = pipes
    req = _requests(tiny_config, n, seed)
    ref = jax_pipe._pack(*req, **caps)
    got = port._pack(*req, **caps)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert got[k].tobytes() == ref[k].tobytes(), k
    for m in range(1, 70):
        assert port._batch_bucket(m) == jax_pipe._batch_bucket(m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generate_is_decode_batch_then_words(pipes, tiny_config, dtype):
    _, port, _ = pipes
    port.dtype = dtype
    try:
        contexts, frames, audio = _requests(tiny_config, 3, seed=6)
        questions = port.generate(contexts, frames, audio)
        host = port._pack(contexts, frames, audio)
        toks = DEC.decode_batch(port.model, port.mc, port._to_device(host),
                                max_len=port.mc.target_steps - 1, dtype=dtype)
        words = DEC.tokens_to_words(toks.numpy(), port.index_to_word)
        assert questions == [" ".join(w) for w in words][:3]
        assert len(questions) == 3 and all(isinstance(q, str)
                                           for q in questions)
    finally:
        port.dtype = torch.float32


def test_generate_async_pins_caps_and_guards_strategy(pipes, tiny_config):
    _, port, _ = pipes
    contexts, frames, audio = _requests(tiny_config, 2, seed=8)
    finish = port.generate_async(contexts, frames, audio)
    assert finish() == port.generate(contexts, frames, audio, seed=3,
                                     row_seeds=[7, 9])  # greedy ignores them
    caps = {"frames_cap": 2, "audio_cap": 1}
    host = port._pack(contexts, frames, audio, **caps)
    toks = DEC.decode_batch(port.model, port.mc, port._to_device(host),
                            max_len=port.mc.target_steps - 1,
                            dtype=port.dtype, **caps)
    assert (port.generate_async(contexts, frames, audio, **caps)()
            == port._to_words(toks.numpy())[:2])
    # every strategy: decode_batch / beam_decode_batch, then _to_words
    batch = port._to_device(port._pack(contexts, frames, audio))
    max_len = port.mc.target_steps - 1
    seeds = torch.from_numpy(row_seed_array(2, 2, [2**31 + 5, -3]))
    for strategy, k in (("sampling", 1), ("topk", 3), ("topp", 1),
                        ("beam", 3)):
        if strategy == "beam":
            toks = DEC.beam_decode_batch(port.model, port.mc, batch,
                                         max_len=max_len, beam_size=3,
                                         dtype=port.dtype)
        else:
            toks = DEC.decode_batch(port.model, port.mc, batch,
                                    prng.prng_key(5), strategy=strategy,
                                    max_len=max_len, k=k, p=0.8,
                                    dtype=port.dtype, row_seeds=seeds)
        assert port.generate_async(
            contexts, frames, audio, strategy=strategy, beam_size=3, topk=k,
            top_p=0.8, seed=5, row_seeds=[2**31 + 5, -3])() == (
                port._to_words(toks.numpy())[:2]), strategy
    with pytest.raises(ValueError, match="unknown strategy"):
        port.generate(contexts, frames, audio, strategy="nucleus")
    # the non-attention decoder is ported: it needs parameters of its own
    # (the attention decoder's are refused), and on them generate() gives
    # the JAX pipeline's questions (f32)
    mc = port.mc._replace(decoder="non_attn")
    with pytest.raises(ValueError, match="decoder='non_attn'"):
        QGPipeline(None, mc, *pipes[2], device="cpu")
    params, state = TQ.init_params(mc, 4)
    vocab, i2w = pipes[2][2:]
    na = QGPipeline(tiny_config, mc, params, state, vocab, i2w,
                    device="cpu", dtype=torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JDEC, "decode_batch",
                   functools.partial(JDEC.decode_batch, dtype=jnp.float32))
        ref = JaxPipeline(tiny_config, JQ.ModelConfig(**mc._asdict()),
                          params, state, vocab, i2w)
        assert (na.generate(contexts, frames, audio)
                == ref.generate(contexts, frames, audio))


@pytest.mark.parametrize("strategy", ["sampling", "topp", "beam"])
def test_generate_matches_the_jax_pipeline_bf16(pipes, tiny_config, strategy):
    """Both pipelines at their serving dtype, bf16, with row seeds that
    wrap (>= 2**31, negative, >= 2**32): the same questions."""
    jax_pipe, port, _ = pipes
    port.dtype = torch.bfloat16
    try:
        req = _requests(tiny_config, 3, seed=9)
        kw = dict(strategy=strategy, seed=7, top_p=0.8,
                  row_seeds=[2**31 + 5, -3, 2**32 + 1])
        assert port.generate(*req, **kw) == jax_pipe.generate(*req, **kw)
    finally:
        port.dtype = torch.float32


def test_row_seeds_make_a_request_independent_of_its_batch(pipes,
                                                           tiny_config):
    _, port, _ = pipes
    contexts, frames, audio = _requests(tiny_config, 4, seed=10)
    caps = {"frames_cap": 3, "audio_cap": 3}
    ids = [101, 2**31 + 7, -9, 4]
    together = port.generate_async(contexts, frames, audio, seed=1,
                                   strategy="sampling", row_seeds=ids,
                                   **caps)()
    for i in range(4):
        alone = port.generate_async(contexts[i:i + 1], frames[i:i + 1],
                                    audio[i:i + 1], seed=1,
                                    strategy="sampling", row_seeds=ids[i:i + 1],
                                    **caps)()
        assert alone == together[i:i + 1], i
    assert (row_seed_array(4, 2, [2**31 + 7, -9, 5]).tolist()
            == [-2**31 + 7, -9, 2, 3])
    with pytest.raises(ValueError, match="row_seeds"):
        row_seed_array(4, 3, [1, 2])


def test_av_bucket_key_matches_jax(pipes, tiny_config):
    jax_pipe, port, _ = pipes
    rate = tiny_config.audio_sample_rate
    for f, a in ((None, None), (1, 10), (2, rate), (3, 3 * rate),
                 (9, 9 * rate)):
        frames = None if f is None else np.zeros((f, 2, 2, 3), np.uint8)
        audio = None if a is None else np.zeros(a, np.int16)
        assert (port.av_bucket_key(frames, audio)
                == jax_pipe.av_bucket_key(frames, audio))


def test_port_imports_no_jax():
    """Importing the whole port leaves JAX, flax and mmqg_tpu unloaded."""
    code = ("import sys, mmqg_tpu_torch.pipeline, mmqg_tpu_torch.checkpoint; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mmqg_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
