"""The port's BLEU (``mmqg_tpu_torch.metrics``) against the JAX package's
(``mmqg_tpu.metrics``): both are pure Python, so every score is held
equal, ``==`` on floats. Seeded random token lists over a small alphabet
(so n-grams repeat and match): one to four references, empty hypotheses
and references, hypotheses shorter than every n, each of the four
weightings, with and without +1 smoothing; the corpus score over whole
corpora; the reference-compatible score on word strings
(``bleu_suite``, which goes through it, is held to JAX's in
``test_torch_port_imports.py``)."""

import numpy as np
import pytest

from mmqg_tpu import metrics as JM
from mmqg_tpu_torch import metrics as TM

WEIGHTS = list(TM.BLEU_WEIGHTS.values())


def _tokens(rng, lo, hi, vocab=3):
    return [f"w{int(t)}" for t in rng.randint(0, vocab, rng.randint(lo, hi))]


def _cases(seed, n=60):
    """(references, hypothesis) pairs: 1-4 references of 0-11 tokens,
    hypotheses of 0-11 tokens (so some are empty and some shorter than
    every n-gram order)."""
    rng = np.random.RandomState(seed)
    return [([_tokens(rng, 0, 12) for _ in range(rng.randint(1, 5))],
             _tokens(rng, 0, 12)) for _ in range(n)]


def test_weights_are_the_jax_packages():
    assert TM.BLEU_WEIGHTS == JM.BLEU_WEIGHTS


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_sentence_bleu_equals_jax(seed, weights, smooth):
    cases = _cases(seed)
    got = [TM.sentence_bleu(r, h, weights, smooth=smooth) for r, h in cases]
    want = [JM.sentence_bleu(r, h, weights, smooth=smooth) for r, h in cases]
    assert got == want
    assert any(0.0 < g < 1.0 for g in got)     # not all degenerate
    assert TM.sentence_bleu([["a", "b"]], [], weights, smooth=smooth) == 0.0


def test_smoothing_changes_the_score_as_jax():
    """A hypothesis with unigram matches but no bigram match: 0 without
    smoothing, the +1 smoothed value with it, on both sides."""
    refs, hyp = [["a", "b", "c", "d"]], ["d", "c", "b", "a"]
    w = TM.BLEU_WEIGHTS["bleu_2"]
    assert TM.sentence_bleu(refs, hyp, w) == 0.0
    got = TM.sentence_bleu(refs, hyp, w, smooth=True)
    assert got == JM.sentence_bleu(refs, hyp, w, smooth=True) > 0.0


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("seed", [2, 3])
def test_corpus_bleu_equals_jax(seed, weights):
    cases = _cases(seed, n=40)
    refs = [r for r, _ in cases]
    hyps = [h for _, h in cases]
    got = TM.corpus_bleu(refs, hyps, weights)
    assert got == JM.corpus_bleu(refs, hyps, weights) and got > 0.0
    # per-example slices, an empty corpus, empty reference lists
    for lo in range(0, 40, 7):
        assert TM.corpus_bleu(refs[lo:lo + 3], hyps[lo:lo + 3], weights) \
            == JM.corpus_bleu(refs[lo:lo + 3], hyps[lo:lo + 3], weights)
    assert TM.corpus_bleu([], [], weights) == JM.corpus_bleu([], [],
                                                             weights) == 0.0
    assert TM.corpus_bleu([[]], [["w1"]], weights) == JM.corpus_bleu(
        [[]], [["w1"]], weights)


def test_closest_ref_len_equals_jax():
    rng = np.random.RandomState(4)
    for _ in range(50):
        refs = [_tokens(rng, 0, 12) for _ in range(rng.randint(1, 5))]
        n = int(rng.randint(0, 12))
        assert TM._closest_ref_len(refs, n) == JM._closest_ref_len(refs, n)


def _sentences(seed, n=40):
    """(question, predicted words): short lowercase sentences over a small
    word list, some empty."""
    rng = np.random.RandomState(seed)
    words = ["what", "is", "the", "a", "of", "cell", "energy", "why", "how"]

    def sentence(lo, hi):
        return [words[i] for i in rng.randint(0, len(words),
                                              rng.randint(lo, hi))]
    return [(" ".join(sentence(0, 8)), sentence(0, 8)) for _ in range(n)]


@pytest.mark.parametrize("weights", WEIGHTS)
def test_reference_compat_bleu_equals_jax(weights):
    cases = _sentences(5)
    got = [TM.reference_compat_bleu(q, p, weights) for q, p in cases]
    assert got == [JM.reference_compat_bleu(q, p, weights) for q, p in cases]
    assert TM.reference_compat_bleu("", ["a"], weights) == 0.0
