"""BLEU for validation and evaluation (``mmqg_tpu/metrics.py``), pure Python.

* ``sentence_bleu`` / ``corpus_bleu``: standard BLEU (one or more
  references, optional +1 smoothing of the n > 1 precisions, the standard
  brevity penalty; the corpus score sums the counts over the corpus);
* ``reference_compat_bleu``: what the reference actually computed (NLTK's
  ``sentence_bleu(question.split(), pred_words)``: each ground-truth word
  is one reference, iterated as characters), for comparisons against
  reference runs;
* ``bleu_suite``: one predicted question against its ground truth with the
  four weightings the reference logs, by either.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence, Tuple

BLEU_WEIGHTS = {
    "bleu_1": (1.0, 0.0, 0.0, 0.0),
    "bleu_2": (0.5, 0.5, 0.0, 0.0),
    "bleu_3": (0.33, 0.33, 0.33, 0.0),
    "bleu": (0.25, 0.25, 0.25, 0.25),
}


def _ngrams(seq: Sequence, n: int) -> Counter:
    return Counter(tuple(seq[i:i + n]) for i in range(len(seq) - n + 1))


def modified_precision(references: List[Sequence], hypothesis: Sequence,
                       n: int) -> Tuple[int, int]:
    """Clipped n-gram match count and total hypothesis n-gram count."""
    hyp_counts = _ngrams(hypothesis, n)
    if not hyp_counts:
        return 0, 0
    max_ref: Counter = Counter()
    for ref in references:
        for ng, c in _ngrams(ref, n).items():
            max_ref[ng] = max(max_ref[ng], c)
    clipped = sum(min(c, max_ref.get(ng, 0)) for ng, c in hyp_counts.items())
    return clipped, sum(hyp_counts.values())


def _closest_ref_len(references: List[Sequence], hyp_len: int) -> int:
    """The reference length closest to ``hyp_len``, the shorter on a tie."""
    return min((abs(len(r) - hyp_len), len(r)) for r in references)[1]


def brevity_penalty(ref_len: int, hyp_len: int) -> float:
    if hyp_len == 0:
        return 0.0
    if hyp_len > ref_len:
        return 1.0
    return math.exp(1.0 - ref_len / hyp_len)


def sentence_bleu(references: List[Sequence], hypothesis: Sequence,
                  weights: Tuple[float, ...] = BLEU_WEIGHTS["bleu"],
                  smooth: bool = False) -> float:
    """Standard sentence BLEU. ``references`` is a list of token sequences;
    ``smooth`` adds one to the match and the total count of every n > 1."""
    if not hypothesis:
        return 0.0
    ps = []
    for i, w in enumerate(weights):
        if w == 0.0:
            continue
        num, den = modified_precision(references, hypothesis, i + 1)
        if smooth and i > 0:
            num, den = num + 1, den + 1
        if num == 0 or den == 0:
            return 0.0
        ps.append(w * math.log(num / den))
    bp = brevity_penalty(_closest_ref_len(references, len(hypothesis)),
                         len(hypothesis))
    return bp * math.exp(sum(ps))


def corpus_bleu(list_of_references: List[List[Sequence]],
                hypotheses: List[Sequence],
                weights: Tuple[float, ...] = BLEU_WEIGHTS["bleu"]) -> float:
    """Standard corpus BLEU: the clipped matches, the totals and the
    lengths summed over the corpus before the precisions are taken."""
    tot_num = [0] * len(weights)
    tot_den = [0] * len(weights)
    ref_len = hyp_len = 0
    for refs, hyp in zip(list_of_references, hypotheses):
        hyp_len += len(hyp)
        ref_len += _closest_ref_len(refs, len(hyp)) if refs else 0
        for i, w in enumerate(weights):
            if w == 0.0:
                continue
            num, den = modified_precision(refs, hyp, i + 1)
            tot_num[i] += num
            tot_den[i] += den
    ps = []
    for i, w in enumerate(weights):
        if w == 0.0:
            continue
        if tot_num[i] == 0 or tot_den[i] == 0:
            return 0.0
        ps.append(w * math.log(tot_num[i] / tot_den[i]))
    return brevity_penalty(ref_len, hyp_len) * math.exp(sum(ps))


def reference_compat_bleu(question: str, pred_words: List[str],
                          weights: Tuple[float, ...] = BLEU_WEIGHTS["bleu"]
                          ) -> float:
    """What the reference computed: sentence BLEU with every word of
    ``question`` as one reference, a sequence of characters."""
    refs: List[Sequence] = [list(word) for word in question.split()]
    if not refs:
        return 0.0
    return sentence_bleu(refs, pred_words, weights)


def bleu_suite(question: str, pred_words: List[str], *,
               compat: bool = False) -> dict:
    """bleu, bleu_1, bleu_2 and bleu_3 of ``pred_words`` against
    ``question``."""
    if compat:
        return {k: reference_compat_bleu(question, pred_words, w)
                for k, w in BLEU_WEIGHTS.items()}
    refs = [question.split()]
    return {k: sentence_bleu(refs, pred_words, w)
            for k, w in BLEU_WEIGHTS.items()}
