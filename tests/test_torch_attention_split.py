"""K2's tiled kernel, modelled on the CPU.

The CUDA kernel splits each segment's positions into chunks, keeps a
flash-decoding partial per (row, chunk) -- the chunk's max score m, the sum
s of exp(score - m) and the context sum of exp(score - m) mem -- and merges
them: M = max m, S = sum s exp(m - M), ctx = sum exp(m - M) ctx_c / S, maps
exp(score - M) / S below the length and 0 past it. ``split_softmax_plain``
writes that arithmetic out in plain PyTorch; here it is held to the JAX
package's ``trimodal_attention_xla`` in f32 and to the Pallas kernel in
interpret mode, at chunk sizes 1, 7, 32 and >= L and lengths 1, L and mid.
Tolerance: atol 1e-5, the f32 bar of tests/test_torch_attention.py (the
merge's rescaling by exp(m_c - M) moves a value by ~1e-7 of itself). The
kernel itself is held to the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu.ops import attention as JA
from mmqg_tpu.ops.attention_pallas import trimodal_attention_pallas
from mmqg_tpu_torch.ops.attention import (TriModalAttention,
                                          split_softmax_plain,
                                          trimodal_attention)

torch.set_num_threads(1)
ATOL = 1e-5
B, Dq, Lt, La, Ht, Hv, Ha = 3, 12, 20, 9, 16, 8, 8


def _case(lengths: str, seed: int = 0):
    rng = np.random.RandomState(seed)
    params = JA.init(jax.random.PRNGKey(seed), query_dim=Dq, text_len=Lt,
                     av_len=La)
    arrays = tuple(a.astype(np.float32) for a in (
        rng.randn(B, Dq), rng.randn(B, Lt, Ht), rng.randn(B, La, Hv),
        rng.randn(B, La, Ha)))
    lens = tuple({"one": np.ones(B), "full": np.full(B, L),
                  "mid": np.asarray([L // 2 + 1, 1, L])}[lengths].astype(
                      np.int32) for L in (Lt, La, La))
    return params, arrays, lens


_REFS = {}


def _refs(lengths: str):
    """(XLA, Pallas-interpret) outputs of the case, computed once."""
    if lengths not in _REFS:
        params, arrays, lens = _case(lengths)
        jargs = (params, *(jnp.asarray(a) for a in arrays),
                 *(jnp.asarray(n) for n in lens))
        _REFS[lengths] = (
            JA.trimodal_attention_xla(*jargs, dtype=jnp.float32),
            trimodal_attention_pallas(*jargs, dtype=jnp.float32,
                                      interpret=True))
    return _REFS[lengths]


def _split_model(lengths: str, chunk: int):
    """The tiled kernel's outputs by ``split_softmax_plain``, one segment at
    a time on the f32 scores q . W + b."""
    params, arrays, lens = _case(lengths)
    attn = TriModalAttention(*(torch.tensor(np.asarray(p)) for p in params))
    w_t, b = attn.weights(torch.float32)
    q, et, ev, ea = (torch.from_numpy(a) for a in arrays)
    scores = q @ w_t.t() + b
    out = {}
    for name, lo, hi, mem, n in (("text", 0, Lt, et, lens[0]),
                                 ("video", Lt, Lt + La, ev, lens[1]),
                                 ("audio", Lt + La, Lt + 2 * La, ea, lens[2])):
        out[name] = split_softmax_plain(scores[:, lo:hi], mem,
                                        torch.from_numpy(n), chunk)
    return out


@pytest.mark.parametrize("lengths", ["one", "full", "mid"])
@pytest.mark.parametrize("chunk", [1, 7, 32, 64])
def test_split_softmax_and_merge_match_xla_and_pallas(lengths, chunk):
    got = _split_model(lengths, chunk)
    for ref in _refs(lengths):
        ctx = {"text": ref[0], "audio": ref[1], "video": ref[2]}
        for name in ("text", "video", "audio"):
            np.testing.assert_allclose(got[name][0].numpy(),
                                       np.asarray(ctx[name]), atol=ATOL,
                                       err_msg=f"ctx {name}")
            np.testing.assert_allclose(got[name][1].numpy(),
                                       np.asarray(ref[3][name]), atol=ATOL,
                                       err_msg=f"maps {name}")


def test_cpu_trimodal_attention_counts_no_launch_and_no_route():
    """On CPU tensors K2 runs its plain version and counts no launch."""
    params, arrays, lens = _case("mid", seed=1)
    attn = TriModalAttention(*(torch.tensor(np.asarray(p)) for p in params))
    args = (*attn.weights(torch.float32),
            *(torch.from_numpy(a) for a in arrays),
            *(torch.from_numpy(n) for n in lens))
    before = trimodal_attention.launches
    out = trimodal_attention(*args)
    assert trimodal_attention.launches == before
    assert out[0].shape == (B, Ht) and out[3]["audio"].shape == (B, La)
