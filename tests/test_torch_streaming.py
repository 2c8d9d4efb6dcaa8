"""The port's streaming loader (``mmqg_tpu_torch.data.streaming``) vs the
JAX package's, on the tiny corpus: the same batches field for field, byte
for byte, by either packing route (the native pack pool built from
``native/mmqg_host.cpp`` into the port's build directory, or the Python
loop), with and without shuffling and media; ``local_rows`` packs the
media of its block of rows only, as JAX's; the route taken is counted."""

import numpy as np
import pytest
import torch

from mmqg_tpu.data import native as jnative
from mmqg_tpu.data.streaming import StreamingLoader as JaxLoader
from mmqg_tpu_torch.data import native
from mmqg_tpu_torch.data import streaming as S
from mmqg_tpu_torch.data.dataset import QGDataset
from mmqg_tpu_torch.data.streaming import StreamingLoader

torch.set_num_threads(1)
FIELDS = ("context_ids", "context_len", "frames", "frames_len", "audio_pcm",
          "audio_len", "target_ids", "target_len", "question_id", "valid")


@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    """Both loaders on one packing route: the python route takes away
    each package's native packer."""
    if request.param == "python":
        monkeypatch.setattr(native, "pack_batch_async",
                            lambda *a, **k: None)
        monkeypatch.setattr(jnative, "pack_batch_async",
                            lambda *a, **k: None)
    else:
        assert native.get_host_lib() is not None
        assert native.HOST_LIB_PATH.parent == native.BUILD_DIR
    return request.param


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.questions == r.questions and g.size == r.size
        for k in FIELDS:
            a, b = getattr(g, k), getattr(r, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k


def _copies(loader, **kw):
    """Every batch, copied (a loader's media buffers rotate)."""
    out = []
    for b in loader.batches(**kw):
        out.append(type(b)(**{k: (v.copy() if isinstance(v, np.ndarray)
                                  else v) for k, v in vars(b).items()}))
    return out


@pytest.mark.parametrize("batch_size,shuffle,load_media",
                         [(4, False, True), (5, True, True),
                          (3, True, False)])
def test_batches_equal_jax(tiny_config, tiny_corpus, route, batch_size,
                           shuffle, load_media):
    kw = dict(batch_size=batch_size, load_media=load_media)
    before = dict(S.pack_routes)
    got = _copies(StreamingLoader(tiny_config, tiny_config.train_file, **kw),
                  shuffle=shuffle, rng=np.random.default_rng(3))
    ref = _copies(JaxLoader(tiny_config, tiny_config.train_file, **kw),
                  shuffle=shuffle, rng=np.random.default_rng(3))
    _assert_batches_equal(got, ref)
    if load_media:
        assert max(b.frames_len.max() for b in got) > 1
        assert max(b.audio_len.max() for b in got) > 0
    packed = {k: S.pack_routes[k] - before[k] for k in before}
    assert packed == {"native": 0, "python": 0, route:
                      len(got) if load_media else 0}


def test_streaming_equals_the_materialised_split(tiny_config, tiny_corpus):
    """Unshuffled, the streaming batches are QGDataset's."""
    got = _copies(StreamingLoader(tiny_config, tiny_config.val_file,
                                  batch_size=4))
    ref = list(QGDataset(tiny_config, tiny_config.val_file).batches(4))
    _assert_batches_equal(got, ref)


@pytest.mark.parametrize("local_rows", [(0, 2), (2, 4), (3, 3)])
def test_local_rows_pack_only_their_block(tiny_config, tiny_corpus, route,
                                          local_rows):
    """Media only in [start, stop) of every batch, the JAX loader's bytes
    there and its zeros elsewhere (frames_len 1, audio_len 0); the text
    fields stay whole."""
    kw = dict(batch_size=4, local_rows=local_rows)
    got = _copies(StreamingLoader(tiny_config, tiny_config.train_file, **kw))
    ref = _copies(JaxLoader(tiny_config, tiny_config.train_file, **kw))
    _assert_batches_equal(got, ref)
    full = _copies(StreamingLoader(tiny_config, tiny_config.train_file,
                                   batch_size=4))
    lo, hi = local_rows
    outside = np.r_[0:lo, hi:4]
    for g, f in zip(got, full):
        assert np.array_equal(g.frames[lo:hi], f.frames[lo:hi])
        assert np.array_equal(g.audio_len[lo:hi], f.audio_len[lo:hi])
        assert not g.frames[outside].any() and not g.audio_pcm[outside].any()
        assert (g.frames_len[outside] == 1).all()
        assert np.array_equal(g.context_ids, f.context_ids)
    with pytest.raises(ValueError):
        StreamingLoader(tiny_config, tiny_config.train_file, batch_size=4,
                        local_rows=(3, 5))


def test_batch_size_is_the_loaders(tiny_config, tiny_corpus):
    loader = StreamingLoader(tiny_config, tiny_config.train_file,
                             batch_size=4)
    with pytest.raises(ValueError, match="preallocated"):
        next(loader.batches(5))
    assert len(loader) == len(loader.records) > 0
