"""Data-parallel serving of the PyTorch port (``mmqg_tpu_torch.parallel``,
``QGPipeline.shard``) vs the JAX package, on the CPU.

The padding and row-block rules equal ``mmqg_tpu.parallel.mesh``'s. A
pipeline sharded over two CPU replicas answers every strategy (greedy,
sampling, top-k, top-p, beam) with the tokens of the JAX pipeline on the
same request batch (GSPMD keeps JAX's mesh result equal to its
single-device one), and of the port unsharded, in f32, at batch sizes 5
and 8, in mode trimodal (conv-LSTM) and mode text; greedy logits within
1e-5. The per-batch sampling stream of a batch split over replicas draws
the padded global batch's noise and each replica takes its rows, so its
tokens equal JAX's decode of the whole padded batch.
"""

import copy
from functools import partial

import numpy as np
import pytest
import torch

from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch import evaluate as EV
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.data.dataset import QGDataset
from mmqg_tpu_torch.data.vocab import END_ID, PAD_ID
from mmqg_tpu_torch.models import qg_model as TQ
from mmqg_tpu_torch.parallel import make_mesh, pad_batch, row_block
from mmqg_tpu_torch.parallel.replicas import Replicas
from mmqg_tpu_torch.pipeline import QGPipeline
from mmqg_tpu_torch.utils import prng

torch.set_num_threads(1)
LOGITS_ATOL = 1e-5
CPU2 = ["cpu", "cpu"]
STRATEGIES = {"greedy": {}, "sampling": {"seed": 3},
              "topk": {"topk": 3, "seed": 3}, "topp": {"top_p": 0.9,
                                                       "seed": 3},
              "beam": {"beam_size": 4}}


def _requests(cfg, n, seed, words):
    rng = np.random.RandomState(seed)
    fs, rate = cfg.frame_size, cfg.audio_sample_rate
    contexts = [" ".join(words[rng.randint(3, len(words))]
                         for _ in range(rng.randint(1, 14)))
                for _ in range(n)]
    frames = [None if i % 4 == 3 else
              rng.randint(0, 256, (rng.randint(1, cfg.av_max_length + 1),
                                   fs, fs, 3), np.uint8) for i in range(n)]
    audio = [None if i % 3 == 2 else
             (rng.randn(rng.randint(10, 3 * rate)) * 3000).astype(np.int16)
             for i in range(n)]
    return contexts, frames, audio


@pytest.fixture(scope="module")
def pipes(tiny_config):
    """{mode: (JAX pipeline, port, port sharded over two CPU replicas)},
    f32, for modes trimodal and text."""
    from tests.torch_port_fixtures import f32_pipelines

    with f32_pipelines(tiny_config) as (jax_pipe, port):
        out = {}
        for mode in ("trimodal", "text"):
            j, p = jax_pipe, port
            if mode != "trimodal":
                j, p = copy.copy(jax_pipe), copy.copy(port)
                j.mc = jax_pipe.mc._replace(mode=mode)
                p.mc = port.mc._replace(mode=mode)
            out[mode] = (j, p, copy.copy(p).shard(devices=CPU2))
        yield out


def _jax_beam_f32(jax_pipe, host, beam_size):
    """The JAX package's beam search on a packed batch with its decoder
    step in f32 (it always beams in bf16), unjitted so that no cached bf16
    trace is reused."""
    from unittest import mock

    import jax.numpy as jnp
    from mmqg_tpu import decode as JDEC
    from mmqg_tpu.models import decoder as JD

    mc = jax_pipe.mc
    caps = (JDEC.audio_bucket(mc, host["audio_len"])
            if mc.mode == "trimodal" else None,
            JDEC.frames_bucket(mc, host["frames_len"])
            if mc.mode != "text" else None)
    b = {k: jnp.asarray(v) for k, v in host.items()}
    mem, st = JDEC.encode_jit(jax_pipe.params, jax_pipe.model_state, mc, b,
                              False, *caps, jnp.float32)
    with mock.patch.object(JD, "step", partial(JD.step, dtype=jnp.float32)):
        return np.asarray(JDEC.beam_from_memories.__wrapped__(
            jax_pipe.params, mem, st, max_len=mc.target_steps - 1,
            beam_size=beam_size, use_pallas=False))


_jax_refs = {}


def _jax_questions(jax_pipe, mode, n, req, strategy):
    key = (mode, n, strategy)
    if key not in _jax_refs:
        kw = STRATEGIES[strategy]
        if strategy == "beam":
            host = jax_pipe._pack(*req)
            toks = _jax_beam_f32(jax_pipe, host, kw["beam_size"])
            _jax_refs[key] = jax_pipe._to_words(toks)[:n]
        else:
            _jax_refs[key] = jax_pipe.generate(*req, strategy=strategy, **kw)
    return _jax_refs[key]


@pytest.mark.parametrize("dp", [2, 3])
@pytest.mark.parametrize("n", [5, 8])
def test_pad_batch_and_row_blocks_match_jax(tiny_config, dp, n):
    """``pad_batch`` pads as ``pad_and_shard_batch`` does (valid False,
    the three lengths 1, zeros elsewhere), and ``row_block`` gives each
    data-axis position the rows the JAX sharding gives its device."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec
    from mmqg_tpu.parallel import make_mesh as jax_mesh
    from mmqg_tpu.parallel import pad_and_shard_batch

    rng = np.random.RandomState(n)
    batch = {"context_ids": rng.randint(0, 9, (n, 4)).astype(np.int32),
             "context_len": rng.randint(2, 5, n).astype(np.int32),
             "frames_len": rng.randint(2, 5, n).astype(np.int32),
             "target_len": rng.randint(2, 5, n).astype(np.int32),
             "audio_pcm": rng.randint(-9, 9, (n, 6)).astype(np.int16),
             "valid": np.ones(n, bool)}
    mesh = jax_mesh((dp, 1), devices=jax.devices()[:dp])
    ref = {k: np.asarray(v) for k, v in
           pad_and_shard_batch({k: v.copy() for k, v in batch.items()},
                               mesh).items()}
    got = pad_batch(batch, dp)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].tobytes() == \
            ref[k].tobytes(), k
    rows = len(got["valid"])
    spans = NamedSharding(mesh, PartitionSpec("data")).devices_indices_map(
        (rows,))
    for r, d in enumerate(mesh.devices[:, 0]):
        s = spans[d][0]
        assert row_block(r, dp, rows) == (s.start or 0,
                                          rows if s.stop is None else s.stop)
    with pytest.raises(ValueError):
        row_block(0, dp, rows + 1)


@pytest.mark.parametrize("mode", ["trimodal", "text"])
@pytest.mark.parametrize("n", [5, 8])
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_sharded_generate_matches_jax_and_unsharded(pipes, tiny_config, mode,
                                                    n, strategy):
    from tests.torch_port_fixtures import WORDS

    jax_pipe, port, sharded = pipes[mode]
    req = _requests(tiny_config, n, 20 + n, WORDS)
    kw = STRATEGIES[strategy]
    got = sharded.generate(*req, strategy=strategy, **kw)
    assert got == port.generate(*req, strategy=strategy, **kw)
    assert got == _jax_questions(jax_pipe, mode, n, req, strategy)
    assert len(got) == n and any(got)


def test_sharded_greedy_logits_match_jax(tiny_config):
    """Each replica's greedy logits (its row block of a packed batch, with
    the AV caps of the whole batch) are JAX's logits of those rows within
    1e-5, on the tiny model of the unsharded logits test
    (``test_torch_decode.py``: random weights, logits of order 1; the
    peaked decoder's logits reach ~10, where f32 rounding alone moves
    them by ~1e-5)."""
    import jax
    import jax.numpy as jnp
    from mmqg_tpu import decode as JDEC
    from mmqg_tpu.data.vocab import START_ID
    from mmqg_tpu.models import decoder as JD
    from tests.torch_port_fixtures import WORDS, tiny_model

    mc, params, state = tiny_model(tiny_config, n_vocab=len(WORDS), seed=3)
    tmc = TQ.ModelConfig(**mc._asdict())
    vocab = {w: i for i, w in enumerate(WORDS)}
    port = QGPipeline(tiny_config, tmc, params, state, vocab,
                      {str(i): w for i, w in enumerate(WORDS)},
                      device="cpu", dtype=torch.float32)
    replicas = Replicas(port.model, make_mesh(devices=CPU2))
    host = port._pack(*_requests(tiny_config, 5, 25, WORDS))
    caps = dict(audio_cap=DEC.audio_bucket(tmc, host["audio_len"]),
                frames_cap=DEC.frames_bucket(tmc, host["frames_len"]))
    max_len = mc.target_steps - 1

    def logits(model, batch, lo, total):
        mem, st = DEC.encode(model, tmc, batch, dtype=torch.float32, **caps)
        return DEC.decode_from_memories(model, mem, st, max_len=max_len,
                                        dtype=torch.float32,
                                        return_logits=True)[1]
    got = replicas.map(logits, host)()
    mem, st = JDEC.encode_jit(params, state, mc,
                              {k: jnp.asarray(v) for k, v in host.items()},
                              False, caps["audio_cap"], caps["frames_cap"],
                              jnp.float32)
    step = jax.jit(partial(JD.step, use_pallas=False, dtype=jnp.float32))
    tok = jnp.full((len(host["valid"]),), START_ID, jnp.int32)
    ref = []
    for _ in range(max_len):
        lg, st, _ = step(params["decoder"], params["embedding"]["table"],
                         tok, mem, st)
        ref.append(np.asarray(lg))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    ref = np.stack(ref, axis=1)
    toks = ref.argmax(-1)
    # rows stay comparable while unfinished (finished rows feed PAD)
    live = np.concatenate([np.ones((len(toks), 1), bool),
                           ~np.isin(toks[:, :-1], (END_ID, PAD_ID))],
                          axis=1).cumprod(axis=1).astype(bool)
    assert got.shape == ref.shape and live.sum() > len(toks)
    np.testing.assert_allclose(got[live], ref[live], atol=LOGITS_ATOL)


@pytest.mark.parametrize("strategy,k", [("sampling", 1), ("topk", 3),
                                        ("topp", 1)])
def test_per_batch_stream_split_matches_jax_padded(pipes, tiny_config,
                                                   strategy, k):
    """A 5-row batch on two replicas pads to 6; with the per-batch stream
    each replica draws the noise of all 6 rows a step (the global shape)
    and keeps its 3: the tokens are JAX's decode of the padded batch, row
    for row. Drawing 3 rows' noise instead gives other tokens."""
    import jax
    import jax.numpy as jnp
    from mmqg_tpu import decode as JDEC
    from tests.torch_port_fixtures import WORDS

    jax_pipe, port, sharded = pipes["trimodal"]
    host = port._pack(*_requests(tiny_config, 5, 31, WORDS))
    host = {k_: v[:5] for k_, v in host.items()}        # 5 rows, unbucketed
    mc = port.mc
    caps = dict(audio_cap=DEC.audio_bucket(mc, host["audio_len"]),
                frames_cap=DEC.frames_bucket(mc, host["frames_len"]))
    kw = dict(strategy=strategy, max_len=mc.target_steps - 1, k=k, p=0.9,
              dtype=torch.float32, **caps)

    def run(model, batch, lo, total, whole=True):
        return DEC.decode_batch(model, mc, batch, prng.prng_key(7),
                                global_rows=(lo, total) if whole else None,
                                **kw)
    got = sharded.replicas.map(run, host)()
    padded = pad_batch(host, 2)
    ref = np.asarray(JDEC.decode_batch(
        jax_pipe.params, jax_pipe.model_state, jax_pipe.mc,
        {k_: jnp.asarray(v) for k_, v in padded.items()},
        jax.random.PRNGKey(7), strategy=strategy, max_len=kw["max_len"],
        k=k, p=0.9, use_pallas=False, dtype=jnp.float32, **caps))
    np.testing.assert_array_equal(got, ref)
    local = sharded.replicas.map(partial(run, whole=False), host)()
    assert not np.array_equal(local, ref)


def test_sharded_evaluate_matches_unsharded(tiny_config, tiny_corpus):
    """``evaluate(mesh=...)`` over two CPU replicas: the predictions and
    BLEU of the unsharded evaluate, greedy and beam, with an eval batch
    that pads (5 rows on 2 replicas)."""
    ds = QGDataset(tiny_config, tiny_config.test_file)
    mc = TQ.ModelConfig.from_config(tiny_config, n_vocab=len(ds.vocab))
    params, state = TQ.init_params(mc, 0)
    model = params_from_numpy(params, state, "cpu")
    mesh = make_mesh(devices=CPU2)
    for strategy in ("greedy", "beam"):
        kw = dict(strategy=strategy, batch_size=5, pred_max_len=4)
        ref = EV.evaluate(model, mc, ds, **kw)
        got = EV.evaluate(model, mc, ds, mesh=mesh, **kw)
        assert got == ref


def test_sharded_evaluate_over_the_streaming_loader(tiny_config,
                                                    tiny_corpus):
    """``evaluate(mesh=...)`` over the streaming loader's three rotating
    buffers, with batches that need no padding (2 rows on 2 replicas, so
    the row blocks are views of the buffers) and more batches than
    buffers: a block is read after the loader has refilled its buffer
    unless the replicas copy it first. The predictions equal the
    unsharded evaluate's over the materialised split."""
    from mmqg_tpu_torch.data.streaming import StreamingLoader

    stream = StreamingLoader(tiny_config, tiny_config.train_file,
                             batch_size=2)
    assert len(stream) > 3 * 2
    ds = QGDataset(tiny_config, tiny_config.train_file)
    mc = TQ.ModelConfig.from_config(tiny_config, n_vocab=len(ds.vocab))
    params, state = TQ.init_params(mc, 0)
    model = params_from_numpy(params, state, "cpu")
    kw = dict(strategy="beam", batch_size=2, pred_max_len=6)
    ref = EV.evaluate(model, mc, ds, **kw)
    got = EV.evaluate(model, mc, stream, mesh=make_mesh(devices=CPU2), **kw)
    assert got == ref


def test_replicas_keep_the_model_on_its_device_and_copy_it_elsewhere():
    mc = TQ.ModelConfig(n_vocab=12, word_emb_dim=4, hidden_dim=8,
                        text_layers=1, dec_layers=1, video_hidden_dim=8,
                        audio_emb_dim=4, context_max_length=5,
                        av_max_length=2, target_steps=3, mode="text")
    params, state = TQ.init_params(mc, 1)
    model = params_from_numpy(params, state, "cpu")
    reps = Replicas(model, make_mesh(devices=["cpu"] * 3))
    assert reps.models[0] is model and len(reps.models) == 3
    assert reps.models[1] is not model
    for a, b in zip(TQ.param_tree(reps.models[2])["decoder"]["out"].values(),
                    TQ.param_tree(model)["decoder"]["out"].values()):
        assert torch.equal(a, b)
    mesh = make_mesh((1, 2), devices=CPU2)
    assert mesh.shape == {"data": 1, "model": 2}
    assert mesh.row(0) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():   # the default is the card's
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError):
        make_mesh((3, 1), devices=CPU2)


def test_replicas_gather_rows_in_order_under_thread_stress():
    """Twelve replicas, a tiny switch interval and twelve callers mapping
    at once (more threads than this box's cores): every gather returns
    its own batch's rows in row order, the padding's rows after them."""
    import sys
    import threading

    mc = TQ.ModelConfig(n_vocab=12, word_emb_dim=4, hidden_dim=8,
                        text_layers=1, dec_layers=1, video_hidden_dim=8,
                        audio_emb_dim=4, context_max_length=5,
                        av_max_length=2, target_steps=3, mode="text")
    params, state = TQ.init_params(mc, 1)
    reps = Replicas(params_from_numpy(params, state, "cpu"),
                    make_mesh(devices=["cpu"] * 12))

    def rows(model, batch, lo, total):
        return batch["context_ids"][:, 0] * 1000 + total

    failures = []

    def caller(k):
        for n in (13, 24, 7):
            ids = np.arange(n, dtype=np.int32) + 100 * k
            host = {"context_ids": ids[:, None].repeat(3, 1),
                    "valid": np.ones(n, bool)}
            got = reps.map(rows, host)()
            total = -(-n // 12) * 12
            want = np.concatenate([ids, np.zeros(total - n, np.int32)])
            if not np.array_equal(got, want * 1000 + total):
                failures.append((k, n))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        reps.close()
    assert not any(t.is_alive() for t in threads) and not failures
