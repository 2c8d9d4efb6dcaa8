"""Weights from the seed, in the port's parameter layout.

The benchmark's own initialiser (not the port's ``init_params``): every
leaf is a slice of one uniform draw made on the device by a
``torch.Generator`` seeded with ``--seed``, scaled per leaf, then copied
to the host once. The leaves are numpy views of that one buffer, in the
pytree ``QGPipeline`` takes (dense ``w (In, Out)``, LSTM ``wx (In, 4H)``,
``wh (H, 4H)``, ``b (4H,)`` with gates i, f, g, o, conv ``w (kh, kw, In,
Out)``, batchnorm ``scale``/``bias`` and running ``mean``/``var``); the
reference takes the same leaves.

Scales: Xavier for the LSTMs and the attention heads, He for the ReLU conv
and fc towers (so activations keep their size through VGGish's six convs),
and a vocabulary projection wide enough that the logits follow the decoder
state, so that greedy tokens vary from step to step.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.arith import VGGISH_BLOCKS, VIDEO_CHANNELS

# (path, shape, kind, scale): kind "u" is U(-scale, scale); "pos" is
# U(lo, hi) for a positive running variance, scale = (lo, hi)
Leaf = Tuple[Tuple, Tuple[int, ...], str, object]

LSTM_GAIN = 2.0      # LSTM wx, wh: Xavier times this, so inputs outweigh biases
ATTN_GAIN = 3.0      # attention heads: Xavier times this (sharper maps)
OUT_GAIN = 24.0      # vocabulary projection: w ~ U(+-OUT_GAIN / sqrt(3 H))


def _xavier(i: int, o: int) -> float:
    return math.sqrt(6.0 / (i + o))


def _he(fan_in: int) -> float:
    return math.sqrt(6.0 / fan_in)


def layout(cfg: Dict) -> List[Leaf]:
    """Every leaf of the configuration's parameters and batchnorm state."""
    D, H = cfg["word_emb_dim"], cfg["hidden_dim"]
    Hv, Ha, V = cfg["video_hidden_dim"], cfg["audio_emb_dim"], cfg["n_vocab"]
    leaves: List[Leaf] = [(("params", "embedding", "table"), (V, D), "u", 1.0)]

    def lstm(prefix, in_dim, hidden, n):
        for li in range(n):
            i = in_dim if li == 0 else hidden
            leaves.append((prefix + ("layers", li, "wx"), (i, 4 * hidden), "u",
                           LSTM_GAIN * _xavier(i, 4 * hidden)))
            leaves.append((prefix + ("layers", li, "wh"),
                           (hidden, 4 * hidden), "u",
                           LSTM_GAIN * _xavier(hidden, 4 * hidden)))
            leaves.append((prefix + ("layers", li, "b"), (4 * hidden,), "u",
                           0.2))

    def conv(prefix, cin, cout):
        leaves.append((prefix + ("w",), (3, 3, cin, cout), "u",
                       _he(9 * cin)))
        leaves.append((prefix + ("b",), (cout,), "u", 0.05))

    def dense(prefix, i, o, scale):
        leaves.append((prefix + ("w",), (i, o), "u", scale))
        leaves.append((prefix + ("b",), (o,), "u", 0.05))

    lstm(("params", "text_enc", "lstm"), D, H, cfg["text_layers"])
    if cfg["mode"] in ("text_video", "trimodal"):
        cin = 3
        for i, c in enumerate(VIDEO_CHANNELS):
            conv(("params", "video_enc", "convs", i), cin, c)
            leaves.append((("params", "video_enc", "bns", i, "scale"), (c,),
                           "pos", (0.8, 1.2)))
            leaves.append((("params", "video_enc", "bns", i, "bias"), (c,),
                           "u", 0.1))
            leaves.append((("state", "video_enc", "bns", i, "mean"), (c,),
                           "u", 0.1))
            leaves.append((("state", "video_enc", "bns", i, "var"), (c,),
                           "pos", (0.5, 1.5)))
            cin = c
        lstm(("params", "video_enc", "lstm"), cfg["flatten_dim"], Hv, 1)
    if cfg["mode"] == "trimodal":
        cin, ci = 1, 0
        for c_out, reps in VGGISH_BLOCKS:
            for _ in range(reps):
                conv(("params", "audio_enc", "convs", ci), cin, c_out)
                cin, ci = c_out, ci + 1
        flat = (cfg["mel_frames"] // 16) * (cfg["mel_bins"] // 16) * cin
        dense(("params", "audio_enc", "fc1"), flat, 4096, _he(flat))
        dense(("params", "audio_enc", "fc2"), 4096, 4096, _he(4096))
        dense(("params", "audio_enc", "fc3"), 4096, Ha, _he(4096))
    if cfg["decoder"] == "attn":
        q = D + H
        for name, length in (("text", cfg["context_max_length"]),
                             ("video", cfg["av_max_length"]),
                             ("audio", cfg["av_max_length"])):
            leaves.append((("params", "decoder", "attn", f"w_{name}"),
                           (q, length), "u", ATTN_GAIN * _xavier(q, length)))
            leaves.append((("params", "decoder", "attn", f"b_{name}"),
                           (length,), "u", 0.5))
        dec_in = D + H + Ha + Hv
    else:
        dec_in = D + Ha + Hv
    lstm(("params", "decoder", "lstm"), dec_in, H, cfg["dec_layers"])
    dense(("params", "decoder", "out"), H, V, OUT_GAIN / math.sqrt(3 * H))
    return leaves


def _insert(tree: Dict, path: Tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(path[-1], int):
        while len(node) <= path[-1]:
            node.append(None)
        node[path[-1]] = value
    else:
        node[path[-1]] = value


def make(cfg: Dict, seed: int, device="cuda") -> Tuple[Dict, Dict]:
    """(params, model_state) pytrees of float32 numpy leaves, drawn from
    ``seed`` on ``device`` in one call."""
    leaves = layout(cfg)
    sizes = [int(np.prod(shape)) for _, shape, _, _ in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device,
                      dtype=torch.float32)
    off = 0
    for (_, _, kind, scale), n in zip(leaves, sizes):
        lo, hi = scale if kind == "pos" else (-scale, scale)
        flat[off:off + n].mul_(hi - lo).add_(lo)
        off += n
    host = flat.cpu().numpy()
    del flat
    tree: Dict = {"params": {}, "state": {}}
    off = 0
    for (path, shape, _, _), n in zip(leaves, sizes):
        _insert(tree, path, host[off:off + n].reshape(shape))
        off += n
    state = tree["state"]
    if "video_enc" in state:
        for bn in state["video_enc"]["bns"]:
            bn["count"] = np.zeros((), np.float32)
    return tree["params"], state
