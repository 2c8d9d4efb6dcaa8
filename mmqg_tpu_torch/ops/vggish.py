"""K3: VGGish conv2..conv6, and the int8 conv of the serving audio tower.

Counterpart of ``mmqg_tpu/ops/vggish_pallas.py`` (:func:`vggish_features`
replaces ``vggish_features_pallas``) and of the int8 conv and activation
quantize in ``mmqg_tpu/models/audio_encoder.py::embed_examples_int8``
(:func:`conv3x3_relu_int8`, :func:`conv3x3_relu_int8_quant`,
:func:`quantize_s8`). All run hand-written kernels in
``csrc/vggish_conv.cu`` (see its header): a 3x3 SAME conv with bias, ReLU
and an optional 2x2 max pool fused, over NHWC activations and HWIO
weights; in bf16 and int8 a tensor-core implicit GEMM (wgmma), in f32 a
SIMT kernel; and the int8 tower's activation quantize.

On a CUDA tensor each wrapper launches the kernel or raises; on a CPU
tensor it runs the plain PyTorch version beside it. Any other device
raises. Each launch adds one to the wrapper's ``launches`` count.

Numerics. K3 (:func:`vggish_conv`): operands in the compute dtype, f32
sums, ``relu(acc + b)`` rounded to the dtype, then pooled -- the Pallas
kernel's ``_conv3x3_relu`` and ``_pool2``. int8 (:func:`conv3x3_relu_int8`):
int32 sums of int8 x int8, then ``relu(float(acc) * (sx[n] * sw[c]) +
b[c])`` with one f32 rounding per operation, rounded to the dtype, then
pooled -- ``embed_examples_int8``'s epilogue. The plain int8 version sums in
float64, which holds every such sum exactly (|sum| <= 127 * 127 * 9 * Cin
< 2^53), so kernel and plain agree bit for bit. The quantize
(:func:`quantize_activations`, true divisions, round half to even) is
monotone, so the fused kernel may quantize before or after the pool.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops import _build

Tensor = torch.Tensor

_DTYPES = (torch.float32, torch.bfloat16)
# conv2..conv6 of VGGish: whether a 2x2 pool follows each
POOLS = (True, False, True, False, True)
_TILE_C = 128     # output channels of a kernel block: Cout % 128 == 0


def _div(a: Tensor, b: float) -> Tensor:
    """``a / b`` by true division. PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which can differ from JAX's
    quotient in the last bit; a tensor divisor takes the true quotient."""
    return a / torch.full((1,), b, dtype=a.dtype, device=a.device)


def _pool2(x: Tensor) -> Tensor:
    N, H, W, C = x.shape
    return x.reshape(N, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def _conv3x3_sum(x: Tensor, w: Tensor, mm) -> Tensor:
    """Sum of the 9 shifted products ``mm(tap (N*H*W, Cin), w[ky, kx])`` of
    a 3x3 SAME conv: (N, H, W, Cout) in ``mm``'s result type."""
    N, H, W, Cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for ky in range(3):
        for kx in range(3):
            tap = xp[:, ky:ky + H, kx:kx + W, :].reshape(N * H * W, Cin)
            prod = mm(tap, w[ky, kx])
            acc = prod if acc is None else acc + prod
    return acc.reshape(N, H, W, w.shape[-1])


def _check(fn: str, dev: torch.device, expected) -> None:
    for name, (t, shape, dt) in expected.items():
        if t.device != dev:
            raise ValueError(f"{fn}: {name} on {t.device}, x on {dev}")
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{fn}: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"the kernel takes {shape} {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")


def _check_shape(fn: str, H: int, W: int, Cin: int, Cout: int, pool: bool,
                 cin_multiple: int) -> None:
    if Cin % cin_multiple or Cout % _TILE_C or (pool and (H % 2 or W % 2)):
        raise ValueError(
            f"{fn}: the kernel needs Cin % {cin_multiple} == 0, Cout % "
            f"{_TILE_C} == 0 and, when pooling, even H and W (Cin={Cin}, "
            f"Cout={Cout}, H={H}, W={W})")


# ------------------------------------------------------------------- K3

def pack_weights_kmajor(w: Tensor, dtype: torch.dtype) -> Tensor:
    """HWIO ``w (3, 3, Cin, Cout)`` as the bf16 kernel's B operand: (Cout,
    3, 3, Cin) in ``dtype``, contiguous, so row ``co`` holds the GEMM's K =
    (tap, Cin) for output channel ``co``."""
    return w.to(dtype).permute(3, 0, 1, 2).contiguous()


def vggish_conv_plain(x: Tensor, w: Tensor, b: Tensor, *, pool: bool,
                      dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """Plain PyTorch version of :func:`vggish_conv`: 9 shifted products
    with operands rounded to ``dtype`` and f32 sums (``_conv3x3_relu``)."""
    acc = _conv3x3_sum(x, w, lambda a, k: L.mm(a, k, dtype))
    y = torch.relu(acc + b).to(dtype)
    return _pool2(y) if pool else y


def vggish_conv(x: Tensor, w: Tensor, b: Tensor, *, pool: bool,
                dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """One VGGish conv layer: ``x (N, H, W, Cin)`` in ``dtype``, weights
    ``w (3, 3, Cin, Cout)`` (cast to ``dtype``), bias ``b (Cout,)`` f32.
    Returns relu(conv + b) in ``dtype``, (N, H, W, Cout), or 2x2-max-pooled
    (N, H/2, W/2, Cout) when ``pool``. Counts one launch per call on CUDA
    (``vggish_conv.launches``)."""
    if x.device.type == "cpu":
        return vggish_conv_plain(x, w, b, pool=pool, dtype=dtype)
    if x.device.type != "cuda":
        raise ValueError(f"vggish_conv: no kernel for device {x.device}")
    if dtype not in _DTYPES:
        raise ValueError(f"vggish_conv: compute dtype {dtype} not supported")
    N, H, W, Cin = x.shape
    Cout = w.shape[-1]
    # bf16: the tensor-core kernel takes its weights K-major and K 64
    # channels of one tap at a time; f32: the SIMT kernel takes HWIO
    bf16 = dtype == torch.bfloat16
    wc = pack_weights_kmajor(w, dtype) if bf16 else w.to(dtype).contiguous()
    _check("vggish_conv", x.device, {
        "x": (x, (N, H, W, Cin), dtype),
        "w": (wc, (Cout, 3, 3, Cin) if bf16 else (3, 3, Cin, Cout), dtype),
        "b": (b, (Cout,), torch.float32)})
    _check_shape("vggish_conv", H, W, Cin, Cout, pool, 64 if bf16 else 8)
    Ho, Wo = (H // 2, W // 2) if pool else (H, W)
    y = torch.empty((N, Ho, Wo, Cout), dtype=dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().mmqg_vggish_conv(
            x.data_ptr(), wc.data_ptr(), b.data_ptr(), y.data_ptr(), N, H, W,
            Cin, Cout, int(pool), int(bf16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mmqg_vggish_conv")
    with _build.COUNT_LOCK:
        vggish_conv.launches += 1
    return y


vggish_conv.launches = 0


def conv1_pool(convs: Sequence[L.Conv2d], mel: Tensor,
               dtype: torch.dtype) -> Tensor:
    """conv1 (C_in = 1) + ReLU + pool through the library conv, as the TPU
    kept it in XLA: (N, 96, 64) -> (N, 48, 32, 64) in ``dtype``."""
    c = convs[0]
    x = torch.relu(L.conv2d(mel[..., None], c.w, c.b, padding="SAME",
                            dtype=dtype, out_dtype=dtype))
    return L.maxpool2d(x, 2)


def _features(convs, mel, dtype, conv) -> Tensor:
    x = conv1_pool(convs, mel, dtype)
    for c, pool in zip(convs[1:], POOLS):
        x = conv(x, c.w, c.b, pool=pool, dtype=dtype)
    return x.reshape(x.shape[0], -1).float()  # NHWC flatten, f32 values


def vggish_features(convs: Sequence[L.Conv2d], mel: Tensor, *,
                    dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """(N, 96, 64) log-mel -> (N, 6 * 4 * 512) f32 conv features holding
    ``dtype`` values (``vggish_features_pallas``): conv1 and its pool
    through the library conv, conv2..conv6 through :func:`vggish_conv` (five
    launches on CUDA). Any N >= 1."""
    return _features(convs, mel, dtype, vggish_conv)


def vggish_features_plain(convs: Sequence[L.Conv2d], mel: Tensor, *,
                          dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """:func:`vggish_features` with :func:`vggish_conv_plain` layers."""
    return _features(convs, mel, dtype, vggish_conv_plain)


# ------------------------------------------------------------------ int8

def quantize_weights(w: Tensor):
    """(wq int8 (3, 3, Cin, Cout), sw f32 (Cout,)): per-output-channel
    scales ``max |w| / 127`` and ``round(w / max(sw, 1e-12))``
    (``embed_examples_int8``)."""
    sw = _div(w.abs().amax(dim=(0, 1, 2)), 127.0)
    wq = torch.round(w / torch.clamp(sw, min=1e-12)).to(torch.int8)
    return wq, sw


def quantize_activations(x: Tensor, scale: Optional[float] = None):
    """(xq int8, sx f32 (N,)) of post-ReLU activations ``x (N, H, W, C)``:
    one scale per example, ``max(max x, 1e-6) / 127`` (dynamic), or the
    static ``scale`` for every example with the quotient clipped to
    [0, 127]; round half to even (``embed_examples_int8``)."""
    xf = x.float()
    N = x.shape[0]
    if scale is not None:
        sx = torch.full((N,), scale, dtype=torch.float32, device=x.device)
        q = torch.clamp(xf / sx[:, None, None, None], 0.0, 127.0)
    else:
        sx = _div(torch.clamp(x.amax(dim=(1, 2, 3)).float(), min=1e-6), 127.0)
        q = xf / sx[:, None, None, None]
    return torch.round(q).to(torch.int8), sx


def conv3x3_relu_int8_plain(xq: Tensor, wq: Tensor, sx: Tensor, sw: Tensor,
                            b: Tensor, *, pool: bool,
                            dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """Plain PyTorch version of :func:`conv3x3_relu_int8`: exact integer
    sums in float64, then the f32 epilogue as separate operations."""
    acc = _conv3x3_sum(xq.double(), wq.double(), torch.matmul)
    y = acc.float() * (sx[:, None, None, None] * sw) + b
    y = torch.relu(y).to(dtype)
    return _pool2(y) if pool else y


INT8_ROUTES = ("wgmma", "dp4a")


def _int8_args(fn, xq, wq, sx, sw, b, dtype):
    if xq.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {xq.device}")
    if dtype not in _DTYPES:
        raise ValueError(f"{fn}: compute dtype {dtype} not supported")
    N, H, W, Cin = xq.shape
    Cout = wq.shape[-1]
    f32 = torch.float32
    _check(fn, xq.device, {
        "xq": (xq, (N, H, W, Cin), torch.int8),
        "wq": (wq, (3, 3, Cin, Cout), torch.int8), "sx": (sx, (N,), f32),
        "sw": (sw, (Cout,), f32), "b": (b, (Cout,), f32)})
    return N, H, W, Cin, Cout


def _conv_s8(xq, wq, sx, sw, b, pool, dtype, amax=None, sx_next=None,
             fn="conv3x3_relu_int8") -> Tensor:
    """Launch the s8 tensor-core conv (``mmqg_vggish_conv_s8``): y in
    ``dtype``, folding each example's max into ``amax`` when given, or the
    next layer's int8 input when ``sx_next`` is given."""
    N, H, W, Cin, Cout = _int8_args(fn, xq, wq, sx, sw, b, dtype)
    _check_shape(fn, H, W, Cin, Cout, pool, 32)
    wk = pack_weights_kmajor(wq, torch.int8)   # the GEMM's K-major B
    Ho, Wo = (H // 2, W // 2) if pool else (H, W)
    y = torch.empty((N, Ho, Wo, Cout), device=xq.device,
                    dtype=torch.int8 if sx_next is not None else dtype)
    with torch.cuda.device(xq.device):
        rc = _build.library().mmqg_vggish_conv_s8(
            xq.data_ptr(), wk.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            b.data_ptr(), y.data_ptr(),
            None if amax is None else amax.data_ptr(),
            None if sx_next is None else sx_next.data_ptr(), N, H, W, Cin,
            Cout, int(pool), int(dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mmqg_vggish_conv_s8")
    with _build.COUNT_LOCK:
        conv3x3_relu_int8.launches += 1
        conv3x3_relu_int8.routes["wgmma"] += 1
    return y


def conv3x3_relu_int8(xq: Tensor, wq: Tensor, sx: Tensor, sw: Tensor,
                      b: Tensor, *, pool: bool,
                      dtype: torch.dtype = torch.bfloat16,
                      force_route: Optional[str] = None) -> Tensor:
    """One quantized VGGish conv layer: ``xq (N, H, W, Cin)`` and ``wq
    (3, 3, Cin, Cout)`` int8, per-example ``sx (N,)``, per-channel ``sw
    (Cout,)`` and bias ``b (Cout,)`` f32. Returns relu(float(xq * wq) *
    (sx * sw) + b) in ``dtype``, 2x2-max-pooled when ``pool``. On CUDA each
    call counts one launch (``conv3x3_relu_int8.launches``) and its route
    (``.routes``): the s8 tensor-core kernel ("wgmma"), or with
    ``force_route="dp4a"`` the SIMT ``__dp4a`` kernel of the first port, a
    yardstick that is never chosen otherwise."""
    if force_route not in (None,) + INT8_ROUTES:
        raise ValueError(f"conv3x3_relu_int8: no route {force_route!r}")
    if xq.device.type == "cpu":
        return conv3x3_relu_int8_plain(xq, wq, sx, sw, b, pool=pool,
                                       dtype=dtype)
    if force_route != "dp4a":
        return _conv_s8(xq, wq, sx, sw, b, pool, dtype)
    N, H, W, Cin, Cout = _int8_args("conv3x3_relu_int8", xq, wq, sx, sw, b,
                                    dtype)
    _check_shape("conv3x3_relu_int8", H, W, Cin, Cout, pool, 32)
    # four consecutive input channels of one output channel per int32 word
    # (little-endian: channel 4k + i in byte i), the operand of __dp4a
    packed = wq.reshape(3, 3, Cin // 4, 4, Cout).permute(
        0, 1, 2, 4, 3).contiguous().view(torch.int32)[..., 0]
    Ho, Wo = (H // 2, W // 2) if pool else (H, W)
    y = torch.empty((N, Ho, Wo, Cout), dtype=dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        rc = _build.library().mmqg_vggish_conv_int8(
            xq.data_ptr(), packed.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            b.data_ptr(), y.data_ptr(), N, H, W, Cin, Cout, int(pool),
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mmqg_vggish_conv_int8")
    with _build.COUNT_LOCK:
        conv3x3_relu_int8.launches += 1
        conv3x3_relu_int8.routes["dp4a"] += 1
    return y


conv3x3_relu_int8.launches = 0
conv3x3_relu_int8.routes = dict.fromkeys(INT8_ROUTES, 0)  # launches by route


def conv3x3_relu_int8_quant(xq: Tensor, wq: Tensor, sx: Tensor, sw: Tensor,
                            b: Tensor, *, pool: bool,
                            dtype: torch.dtype = torch.bfloat16,
                            next_scale: Optional[float] = None):
    """:func:`conv3x3_relu_int8` followed by the next layer's quantize
    (:func:`quantize_activations` of its output): returns (xq_next int8,
    sx_next f32 (N,)). On CUDA the quantize is fused: with ``next_scale``
    (static) the conv's epilogue writes the int8 values; without it
    (dynamic) the epilogue writes the activations and folds each example's
    max, and one :func:`quantize_s8` launch makes the int8 values. Counts
    one ``conv3x3_relu_int8`` launch (and, dynamic, one ``quantize_s8``)."""
    if xq.device.type == "cpu":
        return quantize_activations(conv3x3_relu_int8_plain(
            xq, wq, sx, sw, b, pool=pool, dtype=dtype), next_scale)
    N = xq.shape[0]
    if next_scale is not None:
        sx_next = torch.full((N,), next_scale, dtype=torch.float32,
                             device=xq.device)
        return (_conv_s8(xq, wq, sx, sw, b, pool, dtype, sx_next=sx_next,
                         fn="conv3x3_relu_int8_quant"), sx_next)
    amax = torch.empty((N,), dtype=torch.float32, device=xq.device)
    y = _conv_s8(xq, wq, sx, sw, b, pool, dtype, amax=amax,
                 fn="conv3x3_relu_int8_quant")
    return quantize_s8(y, amax=amax)


def quantize_s8(x: Tensor, scale: Optional[float] = None, *,
                amax: Optional[Tensor] = None):
    """:func:`quantize_activations` as one hand-written kernel on CUDA
    (``mmqg_quantize_s8``): reads ``x (N, H, W, C)`` (f32 or bf16) once and
    writes int8 once. Dynamic scales take each example's max from ``amax
    (N,)`` when a conv folded it, else compute it first; ``scale`` gives
    static ones. Counts one launch per call (``quantize_s8.launches``)."""
    if x.device.type == "cpu":
        return quantize_activations(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_s8: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize_s8: dtype {x.dtype} not supported")
    N = x.shape[0]
    P = x.numel() // N
    if x.dim() != 4 or P % 16 or not x.is_contiguous():
        raise ValueError(f"quantize_s8: the kernel takes a contiguous (N, "
                         f"H, W, C) tensor with H * W * C % 16 == 0, not "
                         f"{tuple(x.shape)}")
    if scale is not None:
        mode = 2
        sx = torch.full((N,), scale, dtype=torch.float32, device=x.device)
    else:
        sx = torch.empty((N,), dtype=torch.float32, device=x.device)
        mode = 0 if amax is not None else 1
    if amax is None:
        amax = torch.empty((N,), dtype=torch.float32, device=x.device)
    elif tuple(amax.shape) != (N,) or amax.dtype != torch.float32 or (
            amax.device != x.device):
        raise ValueError("quantize_s8: amax must be (N,) f32 on x's device")
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().mmqg_quantize_s8(
            x.data_ptr(), amax.data_ptr(), sx.data_ptr(), xq.data_ptr(), N, P,
            mode, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mmqg_quantize_s8")
    with _build.COUNT_LOCK:
        quantize_s8.launches += 1
    return xq, sx


quantize_s8.launches = 0


def int8_convs(convs: Sequence[L.Conv2d], x: Tensor, *,
               dtype: torch.dtype = torch.bfloat16,
               act_scales: Optional[Sequence[float]] = None) -> Tensor:
    """conv2..conv6 of the int8 tower over conv1's pooled output ``x (N, 48,
    32, 64)`` in ``dtype``: conv2's input through :func:`quantize_s8`,
    conv2..conv5 each with the next layer's quantize
    (:func:`conv3x3_relu_int8_quant`), conv6 through
    :func:`conv3x3_relu_int8`. Returns (N, 6, 4, 512) in ``dtype``.
    ``act_scales`` (one float a layer) gives static scales. The weight
    quantize runs per call, as in JAX. On CUDA: five int8 conv launches,
    and five quantize launches (dynamic) or one (static)."""
    scales = (None,) * len(POOLS) if act_scales is None else act_scales
    xq, sx = quantize_s8(x, scales[0])
    last = len(POOLS) - 1
    for i, (c, pool) in enumerate(zip(convs[1:], POOLS)):
        wq, sw = quantize_weights(c.w)
        if i < last:
            xq, sx = conv3x3_relu_int8_quant(xq, wq, sx, sw, c.b, pool=pool,
                                             dtype=dtype,
                                             next_scale=scales[i + 1])
        else:
            x = conv3x3_relu_int8(xq, wq, sx, sw, c.b, pool=pool,
                                  dtype=dtype)
    return x
