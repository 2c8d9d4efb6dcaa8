"""The general traffic generator: requests and arrivals from a mix's
parameters and the seed.

Every seed gets the same set of sizes (word counts, frame counts, audio
lengths), spread evenly over each range and
dealt out in a seed-drawn order; the seed draws the contents (word ids,
pixels, audio samples). So two seeds do the same work in another order.
Pixels and samples are drawn on ``device`` in one call each and copied to
the host once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def spread(lo: float, hi: float, n: int) -> np.ndarray:
    """``n`` integers evenly spread over [lo, hi] (the midpoints of n equal
    steps, rounded)."""
    return np.round(lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(np.int64)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) & (2**63 - 1))
    return g


def vocab(n_vocab: int) -> Tuple[Dict[str, int], Dict[str, str]]:
    """(vocab, index_to_word): <pad>, <start>, <end>, then w3, w4, ..."""
    words = ["<pad>", "<start>", "<end>"] + [f"w{i}" for i in
                                             range(3, n_vocab)]
    return ({w: i for i, w in enumerate(words)},
            {str(i): w for i, w in enumerate(words)})


def _contexts(rng, counts, n_vocab: int) -> List[str]:
    ids = rng.integers(3, n_vocab, int(counts.sum()))
    out, off = [], 0
    for n in counts:
        out.append(" ".join(f"w{i}" for i in ids[off:off + n]))
        off += n
    return out


def _pixels(counts, size: int, seed: int, device) -> List[np.ndarray]:
    per = size * size * 3
    flat = torch.randint(0, 256, (int(counts.sum()) * per,), dtype=torch.uint8,
                         generator=torch_gen(seed, 1, device),
                         device=device).cpu().numpy()
    out, off = [], 0
    for n in counts:
        out.append(flat[off * per:(off + n) * per].reshape(n, size, size, 3))
        off += n
    return out


def _samples(counts, seed: int, device) -> List[np.ndarray]:
    """Gaussian noise at 3000 / 32768 of full scale, int16."""
    x = torch.randn(int(counts.sum()), generator=torch_gen(seed, 2, device),
                    device=device)
    flat = (x * 3000.0).round().clamp(-32768, 32767).to(
        torch.int16).cpu().numpy()
    out, off = [], 0
    for n in counts:
        out.append(flat[off:off + n])
        off += n
    return out


def bulk_pool(cfg: Dict, mix: Dict, seed: int, device) -> List[Tuple]:
    """``mix["batches"]`` request batches of ``mix["batch"]``, each
    (contexts, frames, audio) as ``QGPipeline.generate`` takes them:
    transcripts of ``mix["words"]`` words, ``mix["frames"]`` uint8 frames
    at the configuration's frame size, and (trimodal) int16 PCM of
    ``mix["audio_s"]`` seconds at its sample rate."""
    B, nb = mix["batch"], mix["batches"]
    N = B * nb
    rng = rng_for(seed, 0)
    words = rng.permutation(spread(*mix["words"], N))
    nframes = rng.permutation(spread(*mix["frames"], N))
    contexts = _contexts(rng, words, cfg["n_vocab"])
    frames = _pixels(nframes, cfg["frame_size"], seed, device)
    audio = [None] * N
    if cfg["mode"] == "trimodal":
        sr = cfg["sample_rate"]
        lens = rng.permutation(spread(mix["audio_s"][0] * sr,
                                      mix["audio_s"][1] * sr, N))
        audio = _samples(lens, seed, device)
    return [(contexts[i * B:(i + 1) * B], frames[i * B:(i + 1) * B],
             audio[i * B:(i + 1) * B] if cfg["mode"] == "trimodal" else None)
            for i in range(nb)]


def train_corpus(cfg: Dict, mix: Dict, seed: int, device) -> Dict:
    """A training corpus of ``mix["batches"] * mix["batch"]`` samples:
    transcripts of ``mix["words"]`` words, questions of
    ``mix["question_words"]`` words, ``mix["frames"]`` uint8 frames and
    ``mix["audio_s"]`` seconds of int16 PCM (trimodal)."""
    N = mix["batch"] * mix["batches"]
    rng = rng_for(seed, 9)
    words = rng.permutation(spread(*mix["words"], N))
    qwords = rng.permutation(spread(*mix["question_words"], N))
    nframes = rng.permutation(spread(*mix["frames"], N))
    out = {"contexts": _contexts(rng, words, cfg["n_vocab"]),
           "questions": _contexts(rng, qwords, cfg["n_vocab"]),
           "frames": _pixels(nframes, cfg["frame_size"], seed, device),
           "audio": [None] * N}
    if cfg["mode"] == "trimodal":
        sr = cfg["sample_rate"]
        lens = rng.permutation(spread(mix["audio_s"][0] * sr,
                                      mix["audio_s"][1] * sr, N))
        out["audio"] = _samples(lens, seed, device)
    return out
