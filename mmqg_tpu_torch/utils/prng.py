"""The parts of ``jax.random`` the decode uses, bit for bit, in PyTorch.

Reproduces JAX 0.9.0's threefry2x32 PRNG with ``jax_threefry_partitionable``
True (its default) and 64-bit mode off (``jax_enable_x64`` False): the same
seeds, keys, splits and fold-ins give the same bits, uniforms, Gumbel noise
and categorical draws as the JAX package's sampling decode
(``mmqg_tpu/decode.py::_categorical``).

A key is an int64 tensor whose last axis holds the two uint32 words of a
JAX key, ``(..., 2)``; every uint32 word is kept in an int64 and masked with
``& 0xFFFFFFFF`` after each add and shift (``torch.uint32``'s arithmetic
differs between the CPU and CUDA). A batch of keys ``(*K, 2)`` gives draws
of shape ``(*K, *shape)``, as ``jax.vmap`` over the keys would. Draws are
made on the key's device.

The JAX functions reproduced, in ``jax/_src/prng.py`` and
``jax/_src/random.py``:

- :func:`threefry2x32`: ``_threefry2x32_lowering`` (20 rounds, 5 key
  injections);
- :func:`prng_key`: ``random.PRNGKey`` / ``threefry_seed`` (x32: the seed
  wraps to its low 32 bits, the high word is 0);
- :func:`split`: ``_threefry_split_foldlike``, the hash of a 2x32 iota;
- :func:`fold_in`: ``threefry_fold_in`` (data wraps to uint32);
- :func:`random_bits`: ``_threefry_random_bits_partitionable`` at 32 bits,
  ``bits1 ^ bits2`` over a 2x32 iota of the shape;
- :func:`uniform`: ``random._uniform`` in float32 (mantissa bits OR 1.0,
  minus 1, scaled to [minval, maxval), then ``max(minval, .)``);
- :func:`gumbel`: ``random._gumbel`` in mode "low";
- :func:`categorical`: ``random.categorical`` with replacement,
  ``argmax(gumbel + logits)``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

Tensor = torch.Tensor
MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY_F32 = torch.finfo(torch.float32).tiny


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: Tensor, k2: Tensor, x1: Tensor,
                 x2: Tensor) -> Tuple[Tensor, Tensor]:
    """Threefry-2x32 of the counts ``(x1, x2)`` under the key ``(k1, k2)``,
    elementwise with broadcasting; uint32 words in int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def _words(key: Tensor) -> Tuple[Tensor, Tensor]:
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise ValueError(f"a key is an int64 tensor of shape (..., 2), got "
                         f"{key.dtype} {tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def prng_key(seed: int, device="cpu") -> Tensor:
    """``jax.random.PRNGKey(seed)`` (x32): ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _iota_2x32(shape: Sequence[int], device) -> Tuple[Tensor, Tensor]:
    """The high and low words of ``arange(prod(shape)).reshape(shape)``."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK


def _hash_iota(key: Tensor, shape: Sequence[int]) -> Tuple[Tensor, Tensor]:
    """threefry2x32 of a 2x32 iota of ``shape`` under each key of ``key``:
    two tensors of shape ``key.shape[:-1] + shape``."""
    k1, k2 = _words(key)
    hi, lo = _iota_2x32(tuple(shape), key.device)
    lead = k1.shape
    expand = (...,) + (None,) * len(shape)
    return threefry2x32(k1[expand], k2[expand],
                        hi.expand(*lead, *shape), lo.expand(*lead, *shape))


def split(key: Tensor, num: int = 2) -> Tensor:
    """``jax.random.split(key, num)``: keys ``key.shape[:-1] + (num, 2)``."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: Tensor, data: Union[int, Tensor]) -> Tensor:
    """``jax.random.fold_in(key, data)``; ``data`` (an int or an integer
    tensor broadcasting against ``key.shape[:-1]``) wraps to uint32, as an
    int32 does in JAX."""
    k1, k2 = _words(key)
    if isinstance(data, Tensor):
        data = data.to(device=key.device, dtype=torch.int64) & MASK
    else:
        data = torch.tensor(int(data) & MASK, dtype=torch.int64,
                            device=key.device)
    # threefry_seed(data) is the count pair (0, data)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key: Tensor, shape: Sequence[int]) -> Tensor:
    """32-bit ``jax.random.bits(key, shape)``: int64 tensor of uint32 words,
    shape ``key.shape[:-1] + shape``."""
    b1, b2 = _hash_iota(key, shape)
    return b1 ^ b2


def uniform(key: Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> Tensor:
    """float32 ``jax.random.uniform(key, shape, minval=, maxval=)``."""
    bits = random_bits(key, shape)
    # 23 mantissa bits under the exponent of 1.0: a float in [1, 2)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA contracts ``f * (hi - lo) + lo`` into one fused multiply-add:
    # f * (hi - lo) is exact in float64, so this rounds (almost always) once
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel(key: Tensor, shape: Sequence[int]) -> Tensor:
    """float32 ``jax.random.gumbel(key, shape, mode="low")``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY_F32, 1.0)))


def categorical(key: Tensor, logits: Tensor) -> Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32
    ``logits``: one key draws over all of ``logits`` (shape ``logits.shape``
    of noise), or a batch of keys ``(*K, 2)`` draws row by row over
    ``logits (*K, V)`` (``jax.vmap`` of a draw of shape ``(V,)``).
    Returns int64 indices of shape ``logits.shape[:-1]``."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical takes float32 logits, got "
                         f"{logits.dtype}")
    shape = logits.shape if key.dim() == 1 else logits.shape[key.dim() - 1:]
    return torch.argmax(gumbel(key, shape) + logits, dim=-1)
