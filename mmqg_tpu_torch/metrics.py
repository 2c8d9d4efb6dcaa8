"""BLEU for validation and evaluation (``mmqg_tpu/metrics.py``), pure Python.

``bleu_suite`` scores one predicted question against its ground truth with
the four weightings the reference logs: standard sentence BLEU with one
reference and the standard brevity penalty, or, with ``compat=True``, what
the reference actually computed (NLTK's ``sentence_bleu(question.split(),
pred_words)``: each ground-truth word is one reference, iterated as
characters), for comparisons against reference runs.
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


def brevity_penalty(ref_len: int, hyp_len: int) -> float:
    if hyp_len == 0:
        return 0.0
    if hyp_len > ref_len:
        return 1.0
    return math.exp(1.0 - ref_len / hyp_len)


def sentence_bleu(references: List[Sequence], hypothesis: Sequence,
                  weights: Tuple[float, ...] = BLEU_WEIGHTS["bleu"]) -> float:
    """Standard sentence BLEU. ``references`` is a list of token sequences."""
    if not hypothesis:
        return 0.0
    ps = []
    for i, w in enumerate(weights):
        if w == 0.0:
            continue
        num, den = modified_precision(references, hypothesis, i + 1)
        if num == 0 or den == 0:
            return 0.0
        ps.append(w * math.log(num / den))
    ref_len = min((abs(len(r) - len(hypothesis)), len(r))
                  for r in references)[1]
    return brevity_penalty(ref_len, len(hypothesis)) * math.exp(sum(ps))


def bleu_suite(question: str, pred_words: List[str], *,
               compat: bool = False) -> dict:
    """bleu, bleu_1, bleu_2 and bleu_3 of ``pred_words`` against
    ``question``."""
    if compat:
        refs: List[Sequence] = [list(word) for word in question.split()]
        if not refs:
            return {k: 0.0 for k in BLEU_WEIGHTS}
    else:
        refs = [question.split()]
    return {k: sentence_bleu(refs, pred_words, w)
            for k, w in BLEU_WEIGHTS.items()}
