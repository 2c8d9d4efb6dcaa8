"""What decides ``correct`` for a served model: a sample of the answers
the timed path gave, drawn from the seed with the longest in it, each read
back into the tokens it was served and scored by the f32 reference.

For each sampled request the reference runs once over its prompt with its
served tokens (teacher-forced) and reads, at each position, the gap by
which the served token's logit lies below the reference's best there.
``logit_gap`` is the widest of them and ``logit_gap_mean`` their mean.
Both swing with the seed's weights: where the reference's best two logits
lie far apart a program flips a token nowhere, whatever its precision. So
the number compared is ``logit_gap_per_tie``, the sum of the gaps over the
number of near ties among the positions compared (at least one), a near
tie being a position at which the reference's best two logits lie within
``NEAR_TIE`` of each other: a program's flips come from its near ties, so
this reads its rounding and not how many ties the weights make.

A question shorter than the decode's steps stopped on ``<end>`` or
``<pad>`` (both stop it, and the served words cannot say which): that
position's served logit is the larger of the two. A word outside the
vocabulary or a question longer than the decode's steps cannot be a
served answer and fails the run outright.

The control (``control_`` and the same names) reads, at the same positions
of the same prompts and tokens, the gap of the token the lower-precision
reference puts first.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.gen import rng_for
from portbench.reference import inputs as RI
from portbench.reference.model import END, PAD, Reference

Loaded = Tuple[str, Optional[np.ndarray], Optional[np.ndarray]]
NOTHING = 1e9   # the gap reported when no served token could be compared
NEAR_TIE = 0.05  # logits: the reference's best two closer than this


class Answer:
    """One served answer: ``load()`` gives (context, uint8 frames, int16
    PCM) from what both sides were handed; ``question`` is what came
    back."""

    def __init__(self, load: Callable[[], Loaded], question: str):
        self.load, self.question = load, question


def tokens_of(question: str, vocab: Dict[str, int], steps: int
              ) -> Optional[Tuple[List[int], bool]]:
    """(served token ids, whether the decode stopped) of a question, or
    None where it cannot have been served."""
    words = question.split()
    if len(words) > steps or any(w not in vocab for w in words):
        return None
    ids = [vocab[w] for w in words]
    stopped = len(ids) < steps
    return ids + ([END] if stopped else []), stopped


def sample(answers: Sequence[Answer], k: int, seed: int) -> List[int]:
    """``k`` indices drawn from the seed, the longest question first."""
    if not answers:
        return []
    longest = max(range(len(answers)),
                  key=lambda i: len(answers[i].question.split()))
    rest = [i for i in range(len(answers)) if i != longest]
    pick = rng_for(seed, 5).permutation(len(rest))[:max(0, k - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


def _gaps(z: torch.Tensor, served: List[int], stopped: bool) -> torch.Tensor:
    """Per position, the reference's best logit minus the served one's."""
    idx = torch.tensor(served, device=z.device)
    chosen = z.gather(1, idx[:, None])[:, 0]
    if stopped:
        chosen[-1] = torch.maximum(z[-1, END], z[-1, PAD])
    return z.max(dim=1).values - chosen


def _load(cfg: Dict, vocab: Dict[str, int], answers: Sequence[Answer]):
    ids, frames, pcms = [], [], []
    for a in answers:
        context, f, p = a.load()
        ids.append(RI.context_ids(context, vocab,
                                  cfg["context_max_length"])[0])
        frames.append(RI.frames_u8(f, cfg["av_max_length"]))
        pcms.append(p)
    return ids, frames, pcms


def _summary(gaps: List[torch.Tensor], ties: int, prefix: str = ""
             ) -> Dict[str, float]:
    """The widest and the mean of the per-position gaps, and their sum per
    near tie."""
    if not gaps:
        return {}
    every = torch.cat(gaps)
    return {f"{prefix}logit_gap": float(every.max()),
            f"{prefix}logit_gap_mean": float(every.mean()),
            f"{prefix}logit_gap_per_tie": float(every.sum()) / max(ties, 1)}


def served_gaps(cfg: Dict, params: Dict, state: Dict, vocab: Dict[str, int],
                answers: Sequence[Answer], device, *, block: int = 16,
                control: bool = False) -> Dict[str, float]:
    """Reference readings over ``answers``: ``logit_gap`` (the widest gap
    of a served token), ``logit_gap_mean`` (their mean over the positions
    compared), ``logit_gap_per_tie`` (their sum over the near ties),
    ``tokens`` (positions compared), ``near_ties``, ``unservable``
    (answers no decode could have given) and, with ``control``, the same
    gaps of the fp8 reference's first choices scored by the f32 reference,
    prefixed ``control_``."""
    steps = cfg["target_steps"] - 1
    ref = Reference(cfg, params, state, device)
    low = Reference(cfg, params, state, device, "fp8") if control else None
    ours: List[torch.Tensor] = []
    theirs: List[torch.Tensor] = []
    bad = ties = 0
    parsed = []
    for a in answers:
        t = tokens_of(a.question, vocab, steps)
        if t is None:
            bad += 1
        else:
            parsed.append((a, t))
    with torch.no_grad():
        for b0 in range(0, len(parsed), block):
            chunk = parsed[b0:b0 + block]
            ids, frames, pcms = _load(cfg, vocab, [a for a, _ in chunk])
            toks = [t[0] for _, t in chunk]
            zs = ref.logits(ids, frames, pcms, toks)
            for z, (_, (served, stopped)) in zip(zs, chunk):
                ours.append(_gaps(z, served, stopped).cpu())
                top2 = z.topk(2, dim=1).values
                ties += int((top2[:, 0] - top2[:, 1] < NEAR_TIE).sum())
            if low is not None:
                for z, zl in zip(zs, low.logits(ids, frames, pcms, toks)):
                    pick = zl.argmax(dim=1)
                    theirs.append((z.max(dim=1).values
                                   - z.gather(1, pick[:, None])[:, 0]).cpu())
            del zs
    del ref, low
    gc.collect()
    n_tok = sum(len(g) for g in ours)
    # no answer judged is no evidence: it cannot pass
    out = {"logit_gap": NOTHING, "logit_gap_mean": NOTHING,
           "logit_gap_per_tie": NOTHING, **_summary(ours, ties),
           "tokens": n_tok, "near_ties": ties, "unservable": bad}
    if control:
        out.update(_summary(theirs, ties, "control_"))
    return out
