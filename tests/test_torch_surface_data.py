"""The data layer's keywords and calls that complete the port's surface,
against the JAX package on the tiny corpus:

* ``QGDataset(vocab=, index_to_word=, max_audio_seconds=)``,
  ``batches(drop_last=)`` and ``num_batches``: every array of every
  batch equal to the JAX dataset's, shuffled with the same
  ``np.random.Generator`` or not;
* ``StreamingLoader`` with the same keywords and ``pack_threads=``,
  ``batches(drop_last=)``: batch for batch equal to the JAX loader's, the
  port packing by its native pool or in Python;
* ``data.native.available``, ``load_wav_mono`` and ``load_frames`` on the
  port's own build of ``native/mmqg_host.cpp``, held to the port's Python
  readers (``data.wav``, ``np.load``) as the JAX package's
  ``tests/test_native.py`` holds its own, and None where the library is
  not available.

The JAX side packs in Python here: its native library is never built or
loaded by these tests (its two routes give the same bytes)."""

import json

import numpy as np
import pytest
import torch

from mmqg_tpu.data import dataset as JD
from mmqg_tpu.data import native as jnative
from mmqg_tpu.data import streaming as JS
from mmqg_tpu_torch.data import dataset as TD
from mmqg_tpu_torch.data import native
from mmqg_tpu_torch.data import streaming as TS
from mmqg_tpu_torch.data import wav as wavio

torch.set_num_threads(1)
FIELDS = ("context_ids", "context_len", "frames", "frames_len", "audio_pcm",
          "audio_len", "target_ids", "target_len", "question_id", "valid")


@pytest.fixture(autouse=True)
def jax_packs_in_python(monkeypatch):
    monkeypatch.setattr(jnative, "pack_batch_async", lambda *a, **k: None)


@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    """The port's packing route; the threads the native pool is given are
    recorded in the returned list."""
    threads = []
    if request.param == "python":
        monkeypatch.setattr(native, "pack_batch_async", lambda *a, **k: None)
    else:
        assert native.get_lib() is not None
        real = native.pack_batch_async

        def spy(*a, n_threads=2, **k):
            threads.append(n_threads)
            return real(*a, n_threads=n_threads, **k)
        monkeypatch.setattr(native, "pack_batch_async", spy)
    return request.param, threads


def _copies(batches) -> list:
    """Every batch, copied (a streaming loader's media buffers rotate)."""
    return [type(b)(**{k: (v.copy() if isinstance(v, np.ndarray) else v)
                       for k, v in vars(b).items()}) for b in batches]


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.questions == r.questions and g.size == r.size
        for k in FIELDS:
            a, b = getattr(g, k), getattr(r, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k


def _vocab_files(config):
    with open(config.vocab_file) as f:
        vocab = json.load(f)
    with open(config.index_to_word_file) as f:
        i2w = json.load(f)
    return vocab, i2w


def _swapped_vocab(config, questions_file):
    """The corpus's vocabulary with the ids of the first two words of the
    split's first context swapped (and the index the same way): batches
    encode differently from the files'."""
    vocab, i2w = _vocab_files(config)
    with open(questions_file) as f:
        words = json.load(f)[0]["context"].split()
    a = words[0]
    b = next(w for w in words if vocab[w] != vocab[a])
    vocab = dict(vocab, **{a: vocab[b], b: vocab[a]})
    i2w = dict(i2w, **{str(vocab[a]): a, str(vocab[b]): b})
    return vocab, i2w


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("max_audio_seconds", [None, 1])
def test_dataset_batches_equal_jax(tiny_config, tiny_corpus, drop_last,
                                   max_audio_seconds):
    """Unshuffled and shuffled with the same generator, the padded or the
    dropped tail; the PCM buffer ``(max_audio_seconds or av_max_length)
    * audio_sample_rate`` wide, longer clips cut there."""
    kw = dict(max_audio_seconds=max_audio_seconds)
    ref = JD.QGDataset(tiny_config, tiny_config.train_file, **kw)
    got = TD.QGDataset(tiny_config, tiny_config.train_file, **kw)
    width = ((max_audio_seconds or tiny_config.av_max_length)
             * tiny_config.audio_sample_rate)
    assert got.audio_pcm.shape == ref.audio_pcm.shape == (len(got), width)
    assert got.audio_len.max() == min(width, ref.audio_len.max()) > 0
    n = len(got)
    for B in (3, 5, n, n + 1):
        assert got.num_batches(B) == ref.num_batches(B) == -(-n // B)
        assert got.num_batches(B, drop_last=True) == ref.num_batches(
            B, drop_last=True) == n // B
    for shuffle in (False, True):
        g = list(got.batches(5, shuffle=shuffle,
                             rng=np.random.default_rng(3),
                             drop_last=drop_last))
        r = list(ref.batches(5, shuffle=shuffle,
                             rng=np.random.default_rng(3),
                             drop_last=drop_last))
        assert len(g) == got.num_batches(5, drop_last)
        assert all(b.valid.all() for b in g) or not drop_last
        _assert_batches_equal(g, r)


def test_dataset_takes_a_vocab_and_an_index(tiny_config, tiny_corpus):
    """Given dicts replace the config's files, on both sides: the ids
    follow the given vocabulary, and the index is the one given."""
    vocab, i2w = _swapped_vocab(tiny_config, tiny_config.val_file)
    ref = JD.QGDataset(tiny_config, tiny_config.val_file, vocab, i2w)
    got = TD.QGDataset(tiny_config, tiny_config.val_file, vocab, i2w)
    assert got.vocab is vocab and got.index_to_word is i2w
    default = TD.QGDataset(tiny_config, tiny_config.val_file)
    assert not np.array_equal(got.context_ids, default.context_ids)
    _assert_batches_equal(list(got.batches(4)), list(ref.batches(4)))


def test_streaming_batches_equal_jax(tiny_config, tiny_corpus, route):
    """Shuffled batches of 5 with the given vocabulary, a 1 s PCM buffer
    and three pack threads: the JAX loader's, batch for batch; the native
    pool was given the three threads."""
    name, threads = route
    vocab, i2w = _swapped_vocab(tiny_config, tiny_config.train_file)
    kw = dict(batch_size=5, max_audio_seconds=1, pack_threads=3)
    before = dict(TS.pack_routes)
    loader = TS.StreamingLoader(tiny_config, tiny_config.train_file, vocab,
                                i2w, **kw)
    assert loader.vocab is vocab and loader.index_to_word is i2w
    got = _copies(loader.batches(shuffle=True, rng=np.random.default_rng(4),
                                 drop_last=False))
    ref = _copies(JS.StreamingLoader(
        tiny_config, tiny_config.train_file, vocab, i2w, **kw).batches(
        shuffle=True, rng=np.random.default_rng(4), drop_last=False))
    _assert_batches_equal(got, ref)
    assert len(got) == -(-len(loader) // 5)
    assert got[0].audio_pcm.shape[1] == tiny_config.audio_sample_rate
    packed = {k: TS.pack_routes[k] - before[k] for k in before}
    assert packed == {"native": 0, "python": 0, name: len(got)}
    assert threads == ([3] * len(got) if name == "native" else [])


@pytest.mark.parametrize("shuffle", [False, True])
def test_streaming_drop_last_equals_the_materialised_split(
        tiny_config, tiny_corpus, route, shuffle):
    """With ``drop_last`` the streaming batches are QGDataset's, the tail
    left out (the JAX loader raises NotImplementedError there: it always
    pads)."""
    got = _copies(TS.StreamingLoader(
        tiny_config, tiny_config.train_file, batch_size=3).batches(
        shuffle=shuffle, rng=np.random.default_rng(5), drop_last=True))
    ref = list(TD.QGDataset(tiny_config, tiny_config.train_file).batches(
        3, shuffle=shuffle, rng=np.random.default_rng(5), drop_last=True))
    assert len(got) == len(ref) > 0
    assert all(b.valid.all() for b in got)
    _assert_batches_equal(got, ref)
    with pytest.raises(NotImplementedError):
        next(JS.StreamingLoader(tiny_config, tiny_config.train_file,
                                batch_size=3).batches(drop_last=True))


# ------------------------------------------------- the native single calls

def test_the_host_runtime_is_the_ports_own_build():
    lib = native.get_lib()
    assert native.available() and lib is not None
    assert native.HOST_LIB_PATH.parent == native.BUILD_DIR
    assert lib._name == str(native.HOST_LIB_PATH)


def test_load_wav_mono_matches_the_python_reader(tmp_path):
    """A stereo 44.1 kHz wav to mono int16 at 16 kHz: the Python reader's
    samples to within the int16 step and the resampler's rounding (the
    JAX package's tolerance), its length to 2 samples; ``max_samples``
    caps it."""
    rate = 44100
    t = np.arange(rate) / rate
    sig = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    path = tmp_path / "a.wav"
    wavio.write_wav(path, np.stack([sig, sig * 0.5], axis=1), rate)
    py = wavio.load_mono_16k(path, 16000)
    nat = native.load_wav_mono(path, 16000, 64000)
    assert nat is not None and nat.dtype == np.int16
    assert abs(len(nat) - len(py)) <= 2
    n = min(len(nat), len(py))
    np.testing.assert_allclose(nat[:n] / 32767.0, py[:n], atol=2e-3)
    capped = native.load_wav_mono(path, 16000, 1000)
    np.testing.assert_array_equal(capped, nat[:1000])
    # the same rate: a copy of the samples, to the int16 step
    same = tmp_path / "b.wav"
    wavio.write_wav(same, sig[:16000], 16000)
    np.testing.assert_allclose(native.load_wav_mono(same, 16000, 16000)
                               / 32767.0, wavio.load_mono_16k(same, 16000),
                               atol=1 / 32767.0)
    bad = tmp_path / "c.wav"
    bad.write_bytes(b"RIFF0000WAVEjunk")
    assert native.load_wav_mono(bad, 16000, 100) is None


def test_load_frames_matches_numpy(tmp_path):
    fr = np.random.RandomState(0).randint(0, 256, (5, 16, 16, 3), np.uint8)
    path = tmp_path / "f.npy"
    np.save(path, fr)
    out = native.load_frames(path, 8, 16, 16)
    np.testing.assert_array_equal(out, np.load(path))
    np.testing.assert_array_equal(native.load_frames(path, 3, 16, 16),
                                  fr[:3])
    assert native.load_frames(path, 4, 8, 8) is None        # other H, W
    blob = path.read_bytes()
    cut = tmp_path / "g.npy"
    cut.write_bytes(blob[:len(blob) // 2])                   # short payload
    assert native.load_frames(cut, 5, 16, 16) is None
    assert native.load_frames(tmp_path / "missing.npy", 5, 16, 16) is None


def test_loaders_return_none_without_the_library(tmp_path, monkeypatch):
    """Where the host runtime cannot be built or loaded, the calls return
    None (the caller falls back to the Python readers)."""
    path = tmp_path / "f.npy"
    np.save(path, np.zeros((2, 8, 8, 3), np.uint8))
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert not native.available()
    assert native.load_frames(path, 2, 8, 8) is None
    assert native.load_wav_mono(tmp_path / "a.wav", 16000, 10) is None
