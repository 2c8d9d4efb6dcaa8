"""Core layers: modules that hold parameters in the JAX package's layouts,
and plain functions on tensors.

Counterpart of ``mmqg_tpu/models/layers.py``. Layouts at the public surface
are the JAX ones, so the two packages compare like with like:

* dense ``w (In, Out)``, ``b (Out,)``;
* LSTM layer ``wx (In, 4H)``, ``wh (H, 4H)``, one summed ``b (4H,)``, gate
  order i, f, g, o;
* conv ``w (kh, kw, In, Out)`` (HWIO) on NHWC activations;
* batchnorm ``scale``/``bias`` parameters and ``mean``/``var`` running stats.

Dtype policy (the JAX package's): parameters are float32; a product takes
its operands rounded to the compute ``dtype`` and sums in float32 (JAX's
``preferred_element_type=float32``). ``torch.matmul`` on bfloat16 tensors
would round the *result* to bfloat16 instead, so :func:`mm` rounds the
operands and multiplies in float32: a product of two bfloat16 values is
exact in float32, so only the summation order differs from JAX.

Parameters are built frozen (``requires_grad=False``), which is what
serving wants; a trainer turns them on with ``model.requires_grad_(True)``.
Dropout draws from an explicit ``torch.Generator``: JAX's threefry streams
are not reproduced, only their distribution (keep probability ``1 - rate``,
kept values scaled by ``1 / (1 - rate)``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mmqg_tpu_torch.parallel import model_axis
from mmqg_tpu_torch.parallel.multihost import all_reduce_sum

Tensor = torch.Tensor
State = Tuple[Tensor, Tensor]


def _frozen(x: Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


def mm(x: Tensor, w: Tensor, dtype: torch.dtype) -> Tensor:
    """``x @ w`` with operands rounded to ``dtype`` and float32 sums."""
    if dtype != torch.float32:
        x, w = x.to(dtype), w.to(dtype)
    return torch.matmul(x.float(), w.float())


# ----------------------------------------------------------------------- dense

class Dense(nn.Module):
    """``x @ w + b``. With a ``column_group`` (the column-parallel vocab
    projection of a model axis, ``parallel.model_axis``) ``w`` holds this
    rank's columns and the result is this rank's columns of the output;
    ``b`` stays whole."""

    def __init__(self, w: Tensor, b: Tensor):
        super().__init__()
        self.w = _frozen(w)   # (In, Out)
        self.b = _frozen(b)   # (Out,)
        self.column_group = None

    def forward(self, x: Tensor, dtype: torch.dtype = torch.bfloat16) -> Tensor:
        g = self.column_group
        if g is None:
            return mm(x, self.w, dtype) + self.b
        return (mm(model_axis.copy_to_model(x, g), self.w, dtype)
                + model_axis.split_to_model(self.b, 0, g))


def embed(table: Tensor, ids: Tensor) -> Tensor:
    return F.embedding(ids.long(), table)


def dropout(x: Tensor, rate: float, generator: torch.Generator) -> Tensor:
    """Inverted dropout with a fresh mask from ``generator`` (on ``x``'s
    device): keep with probability ``1 - rate``, scale kept values by
    ``1 / (1 - rate)`` -- ``jnp.where(keep, x / (1 - rate), 0)``."""
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


# ------------------------------------------------------------------------ LSTM

class LSTMLayer(nn.Module):
    def __init__(self, wx: Tensor, wh: Tensor, b: Tensor):
        super().__init__()
        self.wx = _frozen(wx)   # (In, 4H)
        self.wh = _frozen(wh)   # (H, 4H)
        self.b = _frozen(b)     # (4H,)


class LSTM(nn.Module):
    def __init__(self, layers: Sequence[LSTMLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @property
    def hidden_dim(self) -> int:
        return self.layers[0].wh.shape[0]


def cell(layer: LSTMLayer, x: Tensor, h: Tensor, c: Tensor, *,
         dtype: torch.dtype = torch.bfloat16) -> State:
    """One LSTM cell step (``layers._cell``)."""
    gates = mm(x, layer.wx, dtype) + mm(h, layer.wh, dtype) + layer.b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_step(lstm: LSTM, x: Tensor, state: State, *,
              dropout_rate: float = 0.0,
              generator: Optional[torch.Generator] = None,
              dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, State]:
    """One time step through the whole stack (``layers.lstm_step``).
    ``state`` is (h, c), each (L, B, H). With a ``generator`` and a rate
    > 0 (training), every layer's output but the last is dropped out
    before it feeds the next layer; the state keeps the value before
    dropout. Returns (top h, state)."""
    h_all, c_all = state
    hs: List[Tensor] = []
    cs: List[Tensor] = []
    inp = x
    n = len(lstm.layers)
    for li, layer in enumerate(lstm.layers):
        inp, c_new = cell(layer, inp, h_all[li], c_all[li], dtype=dtype)
        hs.append(inp)
        cs.append(c_new)
        if generator is not None and dropout_rate > 0.0 and li < n - 1:
            inp = dropout(inp, dropout_rate, generator)
    return inp, (torch.stack(hs), torch.stack(cs))


def lstm_dims(lstm: LSTM) -> Tuple[int, int]:
    """(num_layers, hidden_dim) of ``lstm``."""
    return len(lstm.layers), lstm.hidden_dim


def lstm_zero_state(num_layers: int, batch: int, hidden_dim: int,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> State:
    """The zero (h, c), each (num_layers, batch, hidden_dim)."""
    z = torch.zeros((num_layers, batch, hidden_dim), dtype=dtype,
                    device=device)
    return z, z


def lstm_scan(lstm: LSTM, xs: Tensor, state: State = None, *,
              dropout_rate: float = 0.0,
              generator: Optional[torch.Generator] = None,
              dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, State]:
    """Whole sequence, layer by layer, no masking (``layers.lstm_scan``).
    With a ``generator`` and a rate > 0 (training), every layer's output
    sequence but the last is dropped out before it feeds the next layer.
    Returns (outputs (B, T, H), final (h, c) each (L, B, H))."""
    B, T, _ = xs.shape
    L, H = lstm_dims(lstm)
    if state is None:
        state = lstm_zero_state(L, B, H, device=xs.device)
    seq = xs
    final_h, final_c = [], []
    for li, layer in enumerate(lstm.layers):
        h, c = state[0][li], state[1][li]
        outs = []
        for t in range(T):
            h, c = cell(layer, seq[:, t], h, c, dtype=dtype)
            outs.append(h)
        seq = torch.stack(outs, dim=1)
        final_h.append(h)
        final_c.append(c)
        if generator is not None and dropout_rate > 0.0 and li < L - 1:
            seq = dropout(seq, dropout_rate, generator)
    return seq, (torch.stack(final_h), torch.stack(final_c))


# ------------------------------------------------------------------------ conv

class Conv2d(nn.Module):
    """Conv parameters; :func:`conv2d` applies them."""

    def __init__(self, w: Tensor, b: Tensor):
        super().__init__()
        self.w = _frozen(w)   # (kh, kw, In, Out)
        self.b = _frozen(b)   # (Out,)


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(x: Tensor, w: Tensor, b: Tensor, *, stride: int = 1,
           padding: str = "VALID", dtype: torch.dtype = torch.bfloat16,
           out_dtype: torch.dtype = torch.float32) -> Tensor:
    """NHWC conv with an HWIO kernel (``layers.conv2d``): runs in
    ``dtype``, the result is cast to ``out_dtype`` and the bias added in
    ``out_dtype`` -- the bias is not fused into the conv, because JAX rounds
    the conv output before adding it. ``padding`` "SAME" pads as XLA does,
    the odd element after (asymmetric where ``stride`` > 1 needs it)."""
    kh, kw = w.shape[0], w.shape[1]
    if padding not in ("VALID", "SAME"):
        raise ValueError(f"conv2d: no padding {padding!r}")
    (top, bottom), (left, right) = ((0, 0), (0, 0)) if padding == "VALID" \
        else (_same_pads(x.shape[1], kh, stride),
              _same_pads(x.shape[2], kw, stride))
    # NHWC <-> NCHW as views: a contiguous NHWC tensor is an NCHW tensor in
    # channels_last memory, which cuDNN convolves without a copy
    xc = x.to(dtype).permute(0, 3, 1, 2)
    wc = w.to(dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    if (top, left) == (bottom, right):
        y = F.conv2d(xc, wc, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), wc,
                     stride=stride)
    return y.permute(0, 2, 3, 1).to(out_dtype) + b.to(out_dtype)


class _MaxPoolTies(torch.autograd.Function):
    """Non-overlapping max pool whose backward splits the cotangent equally
    among tied maxima, as JAX's ``reduce_max`` JVP does (``F.max_pool2d``
    routes all of it to one index). Ties are common in bf16 after ReLU."""

    @staticmethod
    def forward(ctx, x: Tensor, window: int) -> Tensor:
        N, H, W, C = x.shape
        Hc, Wc = (H // window) * window, (W // window) * window
        y = F.max_pool2d(x.permute(0, 3, 1, 2), window, window)
        y = y.permute(0, 2, 3, 1)
        ctx.save_for_backward(x, y)
        ctx.window = window
        ctx.crop = (Hc, Wc)
        return y

    @staticmethod
    def backward(ctx, gy: Tensor):
        x, y = ctx.saved_tensors
        k = ctx.window
        Hc, Wc = ctx.crop
        N, _, _, C = x.shape
        xr = x[:, :Hc, :Wc].reshape(N, Hc // k, k, Wc // k, k, C)
        hit = (xr == y[:, :, None, :, None]).to(gy.dtype)
        share = gy / hit.sum(dim=(2, 4))
        gx = torch.zeros_like(x, dtype=gy.dtype)
        gx[:, :Hc, :Wc] = (hit * share[:, :, None, :, None]).reshape(
            N, Hc, Wc, C)
        return gx, None


def maxpool2d(x: Tensor, window: int,
              stride: Optional[int] = None) -> Tensor:
    """NHWC max pool over ``window`` x ``window`` windows, VALID: a window
    that would cross the edge is dropped. With ``stride`` = ``window`` (the
    default) the JAX crop + reshape-max, with JAX's gradient on ties;
    another stride (overlapping windows when smaller) is JAX's
    ``reduce_window``."""
    stride = stride or window
    if stride == window:
        return _MaxPoolTies.apply(x, window)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


# ------------------------------------------------------------------ batchnorm

_BN_MOMENTUM = 0.1


def _f32_up(x: Tensor) -> Tensor:
    """``x`` in float32, or in float64 when it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def affine(x: Tensor, a: Tensor, b: Tensor, relu: bool = False) -> Tensor:
    """``x * a + b`` per channel (the last axis), then a ReLU when ``relu``:
    one pass over ``x`` where the four of ``(x - mean) * rstd * scale +
    bias`` make three temporaries of its size. Outside autograd."""
    y = torch.addcmul(b, x, a)
    return y.relu_() if relu else y


def _group_sum(t: Tensor, group) -> Tensor:
    """``t`` summed over the processes of ``group`` (in place, no autograd);
    ``t`` itself without a group."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _BatchNormAll(torch.autograd.Function):
    """Batchnorm over every position of channel-last ``x`` with batch
    statistics, optionally followed by a ReLU: returns (y, mean, biased
    var, the number of positions), y in float32 (float64 for float64
    ``x``). The backward is the batchnorm gradient from ``x`` as it came
    in and the per-channel mean and 1 / std, so a (B, T, H, W, C)
    activation is kept once, in its own dtype, where autograd through the
    same arithmetic keeps three float32 intermediates of its size.

    With a process ``group`` (data-parallel training) the statistics are
    those of every process's positions together: the sum and the count,
    then the centred sum of squares, are all-reduced before the
    normalisation, as one program over the global batch computes them.
    The backward all-reduces the two per-channel sums the input gradient
    needs; the scale and bias gradients stay this process's share (the
    step all-reduces every parameter gradient)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, relu: bool, group=None):
        xf = _f32_up(x)
        axes = tuple(range(x.dim() - 1))
        local = x.numel() // x.shape[-1]
        if group is None:
            var, mean = torch.var_mean(xf, dim=axes, correction=0)
            n = torch.tensor(float(local), dtype=xf.dtype, device=x.device)
            ctx.n = local
        else:
            sums = _group_sum(torch.cat([
                xf.sum(dim=axes),
                torch.full((1,), float(local), dtype=xf.dtype,
                           device=x.device)]), group)
            n = sums[-1]
            mean = sums[:-1] / n
            var = _group_sum(((xf - mean) ** 2).sum(dim=axes), group) / n
            ctx.n = n
        rstd = torch.rsqrt(var + eps)
        y = affine(xf, rstd * scale, bias - mean * rstd * scale, relu)
        ctx.save_for_backward(x, mean, rstd, scale, bias)
        ctx.relu = relu
        ctx.group = group
        ctx.mark_non_differentiable(mean, var, n)
        return y, mean, var, n

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar, _gn):
        x, mean, rstd, scale, bias = ctx.saved_tensors
        n = ctx.n
        axes = tuple(range(x.dim() - 1))
        xhat = (_f32_up(x) - mean) * rstd
        if ctx.relu:
            gy = torch.where(xhat * scale + bias > 0, gy, 0.0)
        gbias = gy.sum(dim=axes)
        gscale = (gy * xhat).sum(dim=axes)
        gb, gs = gbias, gscale
        if ctx.group is not None:
            gb, gs = _group_sum(torch.cat([gbias, gscale]),
                                ctx.group).chunk(2)
        gx = (gy * scale - (gb * scale) / n
              - xhat * ((gs * scale) / n)) * rstd
        return gx.to(x.dtype), gscale, gbias, None, None, None


class BatchNorm(nn.Module):
    def __init__(self, scale: Tensor, bias: Tensor, mean: Tensor, var: Tensor,
                 count: Optional[Tensor] = None):
        super().__init__()
        self.scale = _frozen(scale)
        self.bias = _frozen(bias)
        self.register_buffer("mean", mean)
        self.register_buffer("var", var)
        # updates applied to the running stats (the JAX state's "count")
        self.register_buffer("count", torch.zeros((), device=mean.device)
                             if count is None else count.reshape(()))
        # data-parallel training: the torch.distributed group whose
        # processes' batches the train statistics cover (None: this batch)
        self.process_group = None

    def _global_sum(self, t: Tensor) -> Tensor:
        """``t`` summed over ``process_group``, differentiably; ``t``
        itself without a group."""
        if self.process_group is None:
            return t
        return all_reduce_sum(t, self.process_group)

    def forward(self, x: Tensor, eps: float = 1e-5) -> Tensor:
        """Eval batchnorm on channel-last ``x``: f32 maths (f64 for f64
        ``x``), cast back to ``x.dtype`` (``layers.batchnorm(train=False)``)."""
        y = ((_f32_up(x) - self.mean) * torch.rsqrt(self.var + eps)
             * self.scale + self.bias)
        return y.to(x.dtype)

    def train_forward(self, x: Tensor, mask: Tensor, eps: float = 1e-5
                      ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Train batchnorm on channel-last ``(N, H, W, C)`` ``x`` with the
        statistics of the rows where ``mask (N,)`` is set
        (``video_encoder.cnn_features(train=True)``): normalise with the
        biased variance; the new running variance takes the unbiased one,
        n = valid rows x H x W. With a ``process_group`` the statistics are
        those of every process's valid frames (two differentiable
        all-reduces). Returns (y in ``x.dtype``, the new running state,
        detached -- the buffers are not touched)."""
        xf = x.float()
        m = mask.to(torch.float32)[:, None, None, None]
        # with a process group: every process's valid frames together
        sums = self._global_sum(torch.cat([
            (xf * m).sum(dim=(0, 1, 2)),
            (m.sum() * x.shape[1] * x.shape[2])[None]]))
        denom = torch.clamp(sums[-1], min=1.0)
        mean = sums[:-1] / denom
        var = self._global_sum(
            (((xf - mean) ** 2) * m).sum(dim=(0, 1, 2))) / denom
        with torch.no_grad():
            unbiased = var * (denom / torch.clamp(denom - 1.0, min=1.0))
            state = {"mean": (1 - _BN_MOMENTUM) * self.mean
                     + _BN_MOMENTUM * mean,
                     "var": (1 - _BN_MOMENTUM) * self.var
                     + _BN_MOMENTUM * unbiased,
                     "count": self.count + 1}
        y = (xf - mean) * torch.rsqrt(var + eps) * self.scale + self.bias
        return y.to(x.dtype), state

    def train_forward_all(self, x: Tensor, eps: float = 1e-5, *,
                          relu: bool = False
                          ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Train batchnorm on channel-last ``x`` of any rank with the
        statistics of every position (``layers.batchnorm(train=True)`` on
        ``x`` cast to float32): normalise with the biased variance; the new
        running variance takes the unbiased one, n = the number of
        positions. ``relu`` applies a ReLU to the result. Returns (y in
        float32, float64 for float64 ``x``; the new running state,
        detached). The backward keeps ``x`` as it came (e.g. a bf16 conv
        output) and the per-channel statistics, and recomputes the rest
        (:class:`_BatchNormAll`). With a ``process_group`` the positions
        are every process's."""
        y, mean, var, n = _BatchNormAll.apply(x, self.scale, self.bias, eps,
                                              relu, self.process_group)
        if self.process_group is None:
            n = float(x.numel() // x.shape[-1])
            unbias = n / max(n - 1.0, 1.0)
        else:  # every process's positions: the count stays on the device
            unbias = n / torch.clamp(n - 1.0, min=1.0)
        with torch.no_grad():
            state = {"mean": (1 - _BN_MOMENTUM) * self.mean
                     + _BN_MOMENTUM * mean,
                     "var": (1 - _BN_MOMENTUM) * self.var
                     + _BN_MOMENTUM * var * unbias,
                     "count": self.count + 1}
        return y, state

    def eval_scale_shift(self, channels: int, eps: float = 1e-5
                         ) -> Tuple[Tensor, Tensor]:
        """Eval batchnorm folded to one scale ``a`` and shift ``b`` per
        channel (``x * a + b``), derived from the parameters and buffers
        on every call. ``channels`` up to 7 more than the batchnorm's (a
        conv whose channels were padded to a multiple of 8) get scale and
        shift 0 past them, so those channels come out 0."""
        a = self.scale * torch.rsqrt(self.var + eps)
        b = self.bias - self.mean * a
        pad = channels - a.shape[0]
        if pad:
            if not 0 < pad < 8:
                raise ValueError(f"eval_scale_shift: {channels} channels "
                                 f"for a batchnorm of {a.shape[0]}")
            a, b = F.pad(a, (0, pad)), F.pad(b, (0, pad))
        return a, b

    def state(self) -> Dict[str, Tensor]:
        """The running statistics (the buffers themselves)."""
        return {"mean": self.mean, "var": self.var, "count": self.count}

    def load_state(self, state: Dict[str, Tensor]) -> None:
        """Write running statistics (from :meth:`train_forward`) into the
        buffers."""
        with torch.no_grad():
            for k in ("mean", "var", "count"):
                getattr(self, k).copy_(state[k])
