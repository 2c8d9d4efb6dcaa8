"""K2 (trimodal_attention) of the PyTorch port vs the JAX package.

The port's plain version (what a CPU tensor runs) is held to the Pallas
kernel in interpret mode and to ``trimodal_attention_xla``, in f32 at atol
1e-5, as tests/test_attention_pallas.py holds the Pallas kernel. The CUDA
kernel is compared with the plain version on the card in
tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmqg_tpu.ops import attention as JA
from mmqg_tpu.ops.attention_pallas import trimodal_attention_pallas
from mmqg_tpu_torch.ops.attention import (TriModalAttention,
                                          trimodal_attention,
                                          trimodal_attention_plain)

torch.set_num_threads(1)
ATOL = 1e-5


def _setup(B=8, Dq=12, Lt=10, La=6, Ht=16, Hv=16, Ha=8, seed=0):
    rng = np.random.RandomState(seed)
    params = JA.init(jax.random.PRNGKey(seed), query_dim=Dq, text_len=Lt,
                     av_len=La)
    arrays = (rng.randn(B, Dq), rng.randn(B, Lt, Ht), rng.randn(B, La, Hv),
              rng.randn(B, La, Ha))
    arrays = tuple(a.astype(np.float32) for a in arrays)
    lens = tuple(rng.randint(1, L + 1, (B,)).astype(np.int32)
                 for L in (Lt, La, La))
    return params, arrays, lens


def _port(params, arrays, lens, dtype=torch.float32):
    attn = TriModalAttention(*(torch.tensor(np.asarray(p)) for p in params))
    w_t, b = attn.weights(dtype)
    q, et, ev, ea = (torch.from_numpy(a).to(dtype) for a in arrays)
    return trimodal_attention(w_t, b, q, et, ev, ea,
                              *(torch.from_numpy(n) for n in lens))


def _compare(got, ref, atol):
    for g, r, name in zip(got[:3], ref[:3], ("ctx_t", "ctx_a", "ctx_v")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol,
                                   err_msg=name)
    for k in ("text", "video", "audio"):
        np.testing.assert_allclose(got[3][k].numpy(), np.asarray(ref[3][k]),
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("B,seed", [(8, 0), (2, 2), (3, 3)])
def test_matches_pallas_interpret_and_xla(B, seed):
    params, arrays, lens = _setup(B=B, seed=seed)
    jargs = (params, *(jnp.asarray(a) for a in arrays),
             *(jnp.asarray(n) for n in lens))
    got = _port(params, arrays, lens)
    _compare(got, trimodal_attention_pallas(*jargs, dtype=jnp.float32,
                                            interpret=True), ATOL)
    _compare(got, JA.trimodal_attention_xla(*jargs, dtype=jnp.float32), ATOL)


def test_padding_is_invisible():
    """Memory past the true lengths must not change the contexts."""
    params, arrays, lens = _setup(seed=1)
    lens = (np.full_like(lens[0], 4),) + lens[1:]
    out1 = _port(params, arrays, lens)
    et = arrays[1].copy()
    et[:, 4:] = 1e6
    out2 = _port(params, (arrays[0], et) + arrays[2:], lens)
    np.testing.assert_allclose(out1[0].numpy(), out2[0].numpy(), atol=ATOL)
    np.testing.assert_array_equal(out1[3]["text"][:, 4:].numpy(), 0.0)


def test_bf16_follows_the_pallas_rounding():
    """bf16 operands with f32 alpha in the context sum, as the Pallas
    kernel; only f32 summation order separates the two."""
    params, arrays, lens = _setup(seed=4)
    jargs = (params, *(jnp.asarray(a) for a in arrays),
             *(jnp.asarray(n) for n in lens))
    ref = trimodal_attention_pallas(*jargs, dtype=jnp.bfloat16,
                                    interpret=True)
    _compare(_port(params, arrays, lens, torch.bfloat16), ref, 1e-5)


def test_plain_version_is_what_cpu_runs():
    params, arrays, lens = _setup(seed=5)
    attn = TriModalAttention(*(torch.tensor(np.asarray(p)) for p in params))
    args = (*attn.weights(torch.float32),
            *(torch.from_numpy(a) for a in arrays),
            *(torch.from_numpy(n) for n in lens))
    before = trimodal_attention.launches
    _compare(trimodal_attention(*args), trimodal_attention_plain(*args), 0.0)
    assert trimodal_attention.launches == before  # no kernel on the CPU
