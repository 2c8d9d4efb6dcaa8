"""The traffic generators: one seed gives the same requests; another seed
the same sizes in another order, with other contents."""

import json

import numpy as np

from portbench import gen
from portbench.tests.conftest import PKG, TINY, TINY_MIX


def _cfg(name="trimodal_attn"):
    cfg = json.loads((PKG / "configs" / f"{name}.json").read_text())
    cfg.update(TINY)
    return cfg


def _mix(name):
    return dict(json.loads((PKG / "mixes" / f"{name}.json").read_text()),
                **TINY_MIX[name])


def _sizes(pool):
    """Each size's multiset: words, frames, audio samples."""
    rows = [(len(c.split()), len(f), len(a))
            for cs, fs, as_ in pool for c, f, a in zip(cs, fs, as_)]
    return [sorted(col) for col in zip(*rows)]


def test_bulk_pool_same_seed_same_requests():
    a = gen.bulk_pool(_cfg(), _mix("bulk_b32"), 2**33 + 5, "cpu")
    b = gen.bulk_pool(_cfg(), _mix("bulk_b32"), 2**33 + 5, "cpu")
    for (ca, fa, aa), (cb, fb, ab) in zip(a, b):
        assert ca == cb
        assert all(np.array_equal(x, y) for x, y in zip(fa, fb))
        assert all(np.array_equal(x, y) for x, y in zip(aa, ab))


def test_bulk_pool_other_seed_same_sizes_other_contents():
    a = gen.bulk_pool(_cfg(), _mix("bulk_b32"), 1, "cpu")
    b = gen.bulk_pool(_cfg(), _mix("bulk_b32"), 2, "cpu")
    assert _sizes(a) == _sizes(b)
    assert [c for cs, _, _ in a for c in cs] != [c for cs, _, _ in b
                                                 for c in cs]


def test_text_video_pool_has_no_audio():
    pool = gen.bulk_pool(_cfg("text_video_nonattn"), _mix("bulk_b32"), 1,
                         "cpu")
    assert all(a is None for _, _, a in pool)


def test_train_corpus_same_seed_same_samples():
    mix = json.loads((PKG / "mixes" / "train_b32.json").read_text())
    mix.update(batch=3, batches=2, words=[3, 20], question_words=[1, 4],
               frames=[2, 12], audio_s=[1, 2])
    a = gen.train_corpus(_cfg(), mix, 2**32 + 1, "cpu")
    b = gen.train_corpus(_cfg(), mix, 2**32 + 1, "cpu")
    c = gen.train_corpus(_cfg(), mix, 2**32 + 2, "cpu")
    assert a["contexts"] == b["contexts"] and a["questions"] == b["questions"]
    assert all(np.array_equal(x, y) for x, y in zip(a["frames"], b["frames"]))
    assert all(np.array_equal(x, y) for x, y in zip(a["audio"], b["audio"]))
    assert a["questions"] != c["questions"]
    assert (sorted(len(q.split()) for q in a["questions"])
            == sorted(len(q.split()) for q in c["questions"]))
