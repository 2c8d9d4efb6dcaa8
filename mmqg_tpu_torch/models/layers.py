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
The module is inference-only: parameters never require grad.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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
    def __init__(self, w: Tensor, b: Tensor):
        super().__init__()
        self.w = _frozen(w)   # (In, Out)
        self.b = _frozen(b)   # (Out,)

    def forward(self, x: Tensor, dtype: torch.dtype = torch.bfloat16) -> Tensor:
        return mm(x, self.w, dtype) + self.b


def embed(table: Tensor, ids: Tensor) -> Tensor:
    return F.embedding(ids.long(), table)


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
              dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, State]:
    """One time step through the whole stack (``layers.lstm_step``, no
    dropout). ``state`` is (h, c), each (L, B, H). Returns (top h, state)."""
    h_all, c_all = state
    hs: List[Tensor] = []
    cs: List[Tensor] = []
    inp = x
    for li, layer in enumerate(lstm.layers):
        inp, c_new = cell(layer, inp, h_all[li], c_all[li], dtype=dtype)
        hs.append(inp)
        cs.append(c_new)
    return inp, (torch.stack(hs), torch.stack(cs))


def lstm_scan(lstm: LSTM, xs: Tensor, state: State = None, *,
              dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, State]:
    """Whole sequence, layer by layer, no masking (``layers.lstm_scan``).
    Returns (outputs (B, T, H), final (h, c) each (L, B, H))."""
    B, T, _ = xs.shape
    if state is None:
        z = torch.zeros((len(lstm.layers), B, lstm.hidden_dim),
                        device=xs.device)
        state = (z, z)
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
    return seq, (torch.stack(final_h), torch.stack(final_c))


# ------------------------------------------------------------------------ conv

class Conv2d(nn.Module):
    """Conv parameters; :func:`conv2d` applies them."""

    def __init__(self, w: Tensor, b: Tensor):
        super().__init__()
        self.w = _frozen(w)   # (kh, kw, In, Out)
        self.b = _frozen(b)   # (Out,)


def conv2d(x: Tensor, w: Tensor, b: Tensor, *, padding: str = "VALID",
           dtype: torch.dtype = torch.bfloat16,
           out_dtype: torch.dtype = torch.float32) -> Tensor:
    """Stride-1 NHWC conv with an HWIO kernel (``layers.conv2d``): runs in
    ``dtype``, the result is cast to ``out_dtype`` and the bias added in
    ``out_dtype`` -- the bias is not fused into the conv, because JAX rounds
    the conv output before adding it."""
    kh = w.shape[0]
    pad = {"VALID": 0, "SAME": kh // 2}[padding]
    # NHWC <-> NCHW as views: a contiguous NHWC tensor is an NCHW tensor in
    # channels_last memory, which cuDNN convolves without a copy
    xc = x.to(dtype).permute(0, 3, 1, 2)
    wc = w.to(dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(xc, wc, padding=pad)
    return y.permute(0, 2, 3, 1).to(out_dtype) + b.to(out_dtype)


def maxpool2d(x: Tensor, window: int) -> Tensor:
    """Non-overlapping NHWC max pool that drops the ragged edge: the JAX
    crop + reshape-max, which is max_pool2d with stride = window."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, window)
    return y.permute(0, 2, 3, 1)


# ------------------------------------------------------------------ batchnorm

class BatchNorm(nn.Module):
    def __init__(self, scale: Tensor, bias: Tensor, mean: Tensor, var: Tensor):
        super().__init__()
        self.scale = _frozen(scale)
        self.bias = _frozen(bias)
        self.register_buffer("mean", mean)
        self.register_buffer("var", var)

    def forward(self, x: Tensor, eps: float = 1e-5) -> Tensor:
        """Eval batchnorm on channel-last ``x``: f32 maths, cast back to
        ``x.dtype`` (``layers.batchnorm(train=False)``)."""
        y = ((x.float() - self.mean) * torch.rsqrt(self.var + eps)
             * self.scale + self.bias)
        return y.to(x.dtype)
