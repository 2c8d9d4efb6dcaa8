"""The eval batchnorm epilogue of R(2+1)D-18's inference trunk.

Port-only: the JAX package leaves the batchnorm, shortcut add, ReLU and
casts between its convs to XLA's fusion. :func:`bn_epilogue` runs them as
one hand-written kernel (``csrc/bn_epilogue.cu``, see its header) over a
channels-last conv output ``x (..., C)``: the batchnorm folded to one
scale ``a`` and shift ``b`` per channel, then optionally a shortcut (an f32
tensor, or a second conv output with its own scale and shift), then
optionally a ReLU; it writes the next conv's input in the compute dtype
and/or the float value. Each step rounds as :func:`bn_epilogue_plain`
rounds it on the card (``torch.addcmul``, which aten's CUDA kernel
computes as one fma; the add; ``relu``), so the two agree bit for bit
there.

On a CUDA tensor :func:`bn_epilogue` launches the kernel (bf16 or float32
``x``, C % 8 == 0, contiguous, outside autograd) or raises; on a CPU tensor
it runs :func:`bn_epilogue_plain`. Any other device raises. Each launch
adds one to ``bn_epilogue.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mmqg_tpu_torch.ops import _build

Tensor = torch.Tensor
Out = Tuple[Optional[Tensor], Optional[Tensor]]

# the C entry's residual kinds
_NONE, _F32, _CONV = 0, 1, 2


def _up(x: Tensor) -> Tensor:
    """``x`` in float32, or in float64 when it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def bn_epilogue_plain(x: Tensor, a: Tensor, b: Tensor, *, relu: bool = False,
                      residual: Optional[Tensor] = None,
                      res_a: Optional[Tensor] = None,
                      res_b: Optional[Tensor] = None,
                      cast: Optional[torch.dtype] = None,
                      keep: bool = True) -> Out:
    """The eval chain in PyTorch operations: ``y = x * a + b`` in float32
    (float64 for float64 ``x``); plus ``residual`` (through ``residual *
    res_a + res_b`` when ``res_a`` is given); then a ReLU when ``relu``.
    Returns (``y`` cast to ``cast`` or None, ``y`` when ``keep`` else
    None)."""
    y = torch.addcmul(b, _up(x), a)
    if residual is not None:
        if res_a is not None:
            residual = torch.addcmul(res_b, _up(residual), res_a)
        y = y + residual
    if relu:
        y = y.relu_()
    return (None if cast is None else y.to(cast)), (y if keep else None)


def _check(x: Tensor, tensors) -> None:
    for name, (t, shape, dt) in tensors.items():
        if t.device != x.device:
            raise ValueError(f"bn_epilogue: {name} on {t.device}, x on "
                             f"{x.device}")
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"bn_epilogue: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, the kernel takes {shape} {dt}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"bn_epilogue: {name} is not contiguous and "
                             f"16-byte aligned")


def bn_epilogue(x: Tensor, a: Tensor, b: Tensor, *, relu: bool = False,
                residual: Optional[Tensor] = None,
                res_a: Optional[Tensor] = None,
                res_b: Optional[Tensor] = None,
                cast: Optional[torch.dtype] = None, keep: bool = True) -> Out:
    """:func:`bn_epilogue_plain` of a bf16 or float32 conv output ``x (...,
    C)``, ``a``, ``b``, ``res_a``, ``res_b`` f32 ``(C,)``, ``residual`` f32
    or (with ``res_a``) of ``x``'s dtype and shape; ``cast`` None or
    ``x``'s dtype. On CUDA one kernel launch reads each input once and
    writes each output once (float32 ``x``: one float32 output, returned
    for both); the kernel has no backward, so no input may need a
    gradient there."""
    if x.device.type == "cpu":
        return bn_epilogue_plain(x, a, b, relu=relu, residual=residual,
                                 res_a=res_a, res_b=res_b, cast=cast,
                                 keep=keep)
    if x.device.type != "cuda":
        raise ValueError(f"bn_epilogue: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, a, b, residual, res_a, res_b)):
        raise ValueError("bn_epilogue: the kernel has no backward; run it "
                         "under torch.no_grad() or on tensors that need no "
                         "gradient")
    C = x.shape[-1] if x.dim() else 0
    f32, bf16 = torch.float32, torch.bfloat16
    if x.dtype not in (bf16, f32) or C % 8 or not C:
        raise ValueError(f"bn_epilogue: the kernel takes a bf16 or float32 x "
                         f"whose last axis is a multiple of 8, not "
                         f"{tuple(x.shape)} {x.dtype}")
    if cast not in (None, x.dtype) or (cast is None and not keep):
        raise ValueError(f"bn_epilogue: the kernel writes {x.dtype} and/or "
                         f"float32, not cast={cast} keep={keep}")
    expected = {"x": (x, tuple(x.shape), x.dtype),
                "a": (a, (C,), f32), "b": (b, (C,), f32)}
    kind = _NONE
    if residual is not None:
        kind = _F32 if res_a is None else _CONV
        expected["residual"] = (residual, tuple(x.shape),
                                f32 if kind == _F32 else x.dtype)
        if kind == _CONV:
            if res_b is None:
                raise ValueError("bn_epilogue: res_a without res_b")
            expected["res_a"] = (res_a, (C,), f32)
            expected["res_b"] = (res_b, (C,), f32)
    _check(x, expected)
    positions = x.numel() // C
    wide = x.dtype == f32
    y16 = torch.empty_like(x) if cast is not None and not wide else None
    y32 = (torch.empty(x.shape, dtype=f32, device=x.device)
           if keep or wide else None)
    out = ((y32 if cast is not None else None), (y32 if keep else None)
           ) if wide else (y16, y32)
    if not positions:
        return out
    if positions >= 2**31:
        raise ValueError(f"bn_epilogue: {positions} positions, the kernel "
                         f"takes fewer than 2**31")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        rc = _build.library().mmqg_bn_epilogue(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), ptr(residual),
            ptr(res_a), ptr(res_b), ptr(y16), ptr(y32), positions, C, kind,
            int(relu), int(wide), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mmqg_bn_epilogue")
    with _build.COUNT_LOCK:
        bn_epilogue.launches += 1
    return out


bn_epilogue.launches = 0
