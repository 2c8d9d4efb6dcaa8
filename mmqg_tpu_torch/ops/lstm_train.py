"""K4: a trainable LSTM layer -- forward with BPTT residuals, and its backward.

Counterpart of ``mmqg_tpu/ops/lstm_train_pallas.py``: :func:`lstm_layer_train`
replaces its custom-VJP ``lstm_layer_train`` and :func:`lstm_stack_train`
its ``lstm_stack_train`` (which here also takes the encoders' dropout and
the state gather at each row's length). The function is a ``torch.autograd.Function``. On a
CUDA tensor its forward and backward launch the hand-written kernels in
``csrc/lstm_train.cu`` (the forward is K1's, ``csrc/lstm.cuh``: see the
headers for the design), each by a route picked from the shape
(``_build.sweep_rows``); on a CPU tensor they run
:func:`lstm_train_fwd_plain` and :func:`lstm_train_bwd_plain`, the same
functions in plain PyTorch. Any other device raises.

Semantics are ``layers.lstm_scan`` for one layer: no mask and no latch, so a
caller gathers the state at each row's length from the returned h and c
sequences, which keeps the gather differentiable. Rounding follows the
Pallas kernels: the operands of every product (x, h, da, Wx, Wh) are
rounded to the compute dtype, and products sum in f32; gates, state and
gradients are f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops import _build

Tensor = torch.Tensor

_DTYPES = (torch.float32, torch.bfloat16)


def lstm_train_fwd_plain(wx: Tensor, wh: Tensor, b: Tensor, xs: Tensor,
                         h0: Tensor, c0: Tensor, dtype: torch.dtype):
    """Plain forward: (out (B,T,H), c_seq (B,T,H), gates (B,T,4H)
    post-activation in order i, f, g, o, hT, cT), all f32."""
    T = xs.shape[1]
    xproj = L.mm(xs, wx, dtype) + b
    h, c = h0, c0
    outs, cs, gs = [], [], []
    for t in range(T):
        pre = xproj[:, t] + L.mm(h, wh, dtype)
        i, f, g, o = pre.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs.append(h)
        cs.append(c)
        gs.append(torch.cat([i, f, g, o], dim=-1))
    return (torch.stack(outs, 1), torch.stack(cs, 1), torch.stack(gs, 1),
            h, c)


def lstm_train_bwd_plain(wx: Tensor, wh: Tensor, xs: Tensor, h0: Tensor,
                         c0: Tensor, out: Tensor, c_seq: Tensor,
                         gates: Tensor, d_out: Tensor, d_cseq: Tensor,
                         d_hT: Tensor, d_cT: Tensor, dtype: torch.dtype):
    """Plain backward (``_bwd_kernel``'s maths): a reverse-time sweep that
    carries dh and dc, then the weight products over all steps at once.
    Returns (dwx, dwh, db, dx, dh0, dc0), all f32."""
    B, T, In = xs.shape
    H = h0.shape[-1]
    dh_carry, dc = d_hT, d_cT
    das = [None] * T
    for t in range(T - 1, -1, -1):
        i, f, g, o = gates[:, t].chunk(4, dim=-1)
        c_prev = c_seq[:, t - 1] if t > 0 else c0
        tanh_c = torch.tanh(c_seq[:, t])
        dh = d_out[:, t] + dh_carry
        dcv = dc + d_cseq[:, t] + dh * o * (1.0 - tanh_c * tanh_c)
        da = torch.cat([dcv * g * i * (1.0 - i),
                        dcv * c_prev * f * (1.0 - f),
                        dcv * i * (1.0 - g * g),
                        dh * tanh_c * o * (1.0 - o)], dim=-1)
        das[t] = da
        dh_carry = L.mm(da, wh.t(), dtype)
        dc = dcv * f
    da_all = torch.stack(das, 1).reshape(B * T, 4 * H)
    h_prev = h_prev_seq(h0, out).reshape(B * T, H)
    dx = L.mm(da_all, wx.t(), dtype).reshape(B, T, In)
    dwx = L.mm(xs.reshape(B * T, In).t(), da_all, dtype)
    dwh = L.mm(h_prev.t(), da_all, dtype)
    return dwx, dwh, da_all.sum(0), dx, dh_carry, dc


def h_prev_seq(h0: Tensor, out: Tensor,
               dtype: torch.dtype = torch.float32) -> Tensor:
    """(B, T, H): the state each step starts from, ``h0`` at t = 0 and
    ``out[:, t - 1]`` after, in ``dtype`` -- the left operand of dWh
    (rounded to the compute dtype for the kernel's tensor-core product)."""
    return torch.cat([h0[:, None], out[:, :-1]], 1).to(dtype)


def _check(name: str, t: Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"lstm_layer_train: {name} on {t.device}, xs on "
                         f"{device}")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"lstm_layer_train: {name} is {tuple(t.shape)} "
                         f"{t.dtype}, the kernel takes {tuple(shape)} {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"lstm_layer_train: {name} is not contiguous")


def _kernel_args(wx, wh, xs, h0, c0, dtype):
    """Operands cast to the compute dtype and every input checked."""
    if dtype not in _DTYPES:
        raise ValueError(f"lstm_layer_train: compute dtype {dtype} not "
                         "supported")
    B, T, In = xs.shape
    H = wh.shape[0]
    if H % 8 or H > 1024 or T < 1:
        raise ValueError(f"lstm_layer_train: kernel needs H % 8 == 0, "
                         f"H <= 1024 and T >= 1 (H={H}, T={T})")
    x, wxc, whc = (t.to(dtype).contiguous() for t in (xs, wx, wh))
    dev = xs.device
    for name, t, shape, dt in (("xs", x, (B, T, In), dtype),
                               ("wx", wxc, (In, 4 * H), dtype),
                               ("wh", whc, (H, 4 * H), dtype),
                               ("h0", h0, (B, H), torch.float32),
                               ("c0", c0, (B, H), torch.float32)):
        _check(name, t, shape, dt, dev)
    return x, wxc, whc


def _fwd_kernel(wx, wh, b, xs, h0, c0, dtype, force_route=None):
    x, wxc, whc = _kernel_args(wx, wh, xs, h0, c0, dtype)
    B, T, In = xs.shape
    H = wh.shape[0]
    dev = xs.device
    _check("b", b, (4 * H,), torch.float32, dev)
    out = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    c_seq = torch.empty_like(out)
    gates = torch.empty((B, T, 4 * H), dtype=torch.float32, device=dev)
    # h in the compute dtype, ping-ponged: h_{t-1} of step t in hbuf[t % 2]
    hbuf = torch.empty((2, B, H), dtype=dtype, device=dev)
    hbuf[0].copy_(h0)
    sync = torch.empty((1,), dtype=torch.int32, device=dev)  # grid barrier
    hT = torch.empty((B, H), dtype=torch.float32, device=dev)
    cT = c0.clone()  # the kernel's c: c0 on entry, cT on exit
    lib = _build.library()
    with torch.cuda.device(dev):
        rows = _build.sweep_rows("mmqg_lstm_train_fwd_rows", B, H,
                                 dtype == torch.bfloat16,
                                 torch.cuda.current_device(), force_route)
        rc = lib.mmqg_lstm_train_fwd(
            x.data_ptr(), wxc.data_ptr(), whc.data_ptr(), b.data_ptr(),
            hbuf.data_ptr(), out.data_ptr(), c_seq.data_ptr(),
            gates.data_ptr(), sync.data_ptr(), hT.data_ptr(), cT.data_ptr(),
            B, T, In, H, int(dtype == torch.bfloat16), rows,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mmqg_lstm_train_fwd")
    with _build.COUNT_LOCK:
        lstm_layer_train.fwd_launches += 1
        lstm_layer_train.fwd_routes[_build.route_of(rows)] += 1
    return out, c_seq, gates, hT, cT


def _bwd_kernel(wx, wh, xs, h0, c0, out, c_seq, gates, d_out, d_cseq, d_hT,
                d_cT, dtype):
    x, wxc, whc = _kernel_args(wx, wh, xs, h0, c0, dtype)
    B, T, In = xs.shape
    H = wh.shape[0]
    dev = xs.device
    for name, t, shape in (("c_seq", c_seq, (B, T, H)),
                           ("gates", gates, (B, T, 4 * H)),
                           ("d_out", d_out, (B, T, H)),
                           ("d_cseq", d_cseq, (B, T, H)),
                           ("d_hT", d_hT, (B, H)), ("d_cT", d_cT, (B, H))):
        _check(name, t, shape, torch.float32, dev)
    h_prev = h_prev_seq(h0, out, dtype)
    bf16 = int(dtype == torch.bfloat16)
    da = torch.empty((B, T, 4 * H), dtype=torch.float32, device=dev)
    # the bf16 copy of da that the tensor-core GEMMs read (unused in f32)
    da_op = torch.empty((B, T, 4 * H) if bf16 else (0,), dtype=dtype,
                        device=dev)
    sync = torch.empty((1,), dtype=torch.int32, device=dev)  # grid barrier
    dc = d_cT.clone()
    dx = torch.empty((B, T, In), dtype=torch.float32, device=dev)
    dwx = torch.empty((In, 4 * H), dtype=torch.float32, device=dev)
    dwh = torch.empty((H, 4 * H), dtype=torch.float32, device=dev)
    db = torch.empty((4 * H,), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        route = bwd_route(B, H, dtype)
        rc = lib.mmqg_lstm_train_bwd(
            x.data_ptr(), h_prev.data_ptr(), c0.data_ptr(), c_seq.data_ptr(),
            gates.data_ptr(), wxc.data_ptr(), whc.data_ptr(),
            d_out.data_ptr(), d_cseq.data_ptr(), d_hT.data_ptr(),
            da.data_ptr(), da_op.data_ptr(), dc.data_ptr(), sync.data_ptr(),
            dx.data_ptr(), dwx.data_ptr(), dwh.data_ptr(), db.data_ptr(),
            dh0.data_ptr(), B, T, In, H, bf16, int(route == "persistent"),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mmqg_lstm_train_bwd")
    with _build.COUNT_LOCK:
        lstm_layer_train.bwd_routes[route] += 1
        lstm_layer_train.bwd_launches += 1
    return dwx, dwh, db, dx, dh0, dc


def bwd_route(B: int, H: int, dtype: torch.dtype) -> str:
    """The backward's route at (B, H) on the current CUDA device, by shape:
    "persistent" (one cooperative launch for all steps) when every block of
    its sweep can be resident at once, else "per_step" (one launch a step,
    e.g. at B=128 or at H=2048)."""
    return _build.route_of(_build.sweep_rows(
        "mmqg_lstm_train_bwd_persistent", B, H, dtype == torch.bfloat16,
        torch.cuda.current_device()))


def _route(device: torch.device, plain, kernel):
    if device.type == "cpu":
        return plain
    if device.type == "cuda":
        return kernel
    raise ValueError(f"lstm_layer_train: no kernel for device {device}")


class _LSTMLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wx, wh, b, xs, h0, c0, dtype, force_route):
        fwd = _route(xs.device, lstm_train_fwd_plain,
                     lambda *a: _fwd_kernel(*a, force_route=force_route))
        out, c_seq, gates, hT, cT = fwd(wx, wh, b, xs, h0, c0, dtype)
        ctx.save_for_backward(wx, wh, xs, h0, c0, out, c_seq, gates)
        ctx.dtype = dtype
        return out, c_seq, hT, cT

    @staticmethod
    def backward(ctx, d_out, d_cseq, d_hT, d_cT):
        wx, wh, xs, h0, c0, out, c_seq, gates = ctx.saved_tensors
        # outputs the loss does not reach have no cotangent
        d_out, d_cseq = (torch.zeros_like(out) if d is None
                         else d.float().contiguous()
                         for d in (d_out, d_cseq))
        d_hT, d_cT = (torch.zeros_like(h0) if d is None
                      else d.float().contiguous() for d in (d_hT, d_cT))
        bwd = _route(xs.device, lstm_train_bwd_plain, _bwd_kernel)
        dwx, dwh, db, dx, dh0, dc0 = bwd(
            wx, wh, xs, h0, c0, out, c_seq, gates, d_out, d_cseq, d_hT, d_cT,
            ctx.dtype)
        return dwx, dwh, db, dx.to(xs.dtype), dh0, dc0, None, None


def lstm_layer_train(wx: Tensor, wh: Tensor, b: Tensor, xs: Tensor,
                     h0: Tensor, c0: Tensor,
                     dtype: torch.dtype = torch.bfloat16, *,
                     force_route: Optional[str] = None
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One trainable LSTM layer over ``xs (B, T, In)`` with ``wx (In, 4H)``,
    ``wh (H, 4H)``, ``b (4H,)`` and initial state ``h0``/``c0 (B, H)``.
    Returns (out_seq (B,T,H), c_seq (B,T,H), hT (B,H), cT (B,H)), f32, with
    gradients to every input. On CUDA each forward counts one launch of the
    forward entry (``lstm_layer_train.fwd_launches``) and one of its route
    (``.fwd_routes``), each backward one of the backward entry
    (``.bwd_launches``) and one of its route (``.bwd_routes``).
    ``force_route`` replaces the forward's choice of route, as
    :func:`~mmqg_tpu_torch.ops.lstm.lstm_seq`'s does."""
    if force_route not in (None,) + _build.ROUTES:
        raise ValueError(f"lstm_layer_train: no route {force_route!r}")
    return _LSTMLayerTrain.apply(wx, wh, b, xs, h0.contiguous(),
                                 c0.contiguous(), dtype, force_route)


lstm_layer_train.fwd_launches = 0
lstm_layer_train.bwd_launches = 0
# launches by route (``_build.sweep_rows``)
lstm_layer_train.fwd_routes = dict.fromkeys(_build.ROUTES, 0)
lstm_layer_train.bwd_routes = dict.fromkeys(_build.ROUTES, 0)


def gather_at(seq: Tensor, lengths: Tensor) -> Tensor:
    """``seq[b, lengths[b] - 1]`` for every row: (B, T, H) -> (B, H)."""
    idx = (lengths.long() - 1).clamp(min=0)[:, None, None]
    return seq.gather(1, idx.expand(-1, 1, seq.shape[2]))[:, 0]


def lstm_stack_train(lstm: L.LSTM, xs: Tensor, state: L.State = None, *,
                     lengths: Optional[Tensor] = None, dropout: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Tuple[Tensor, L.State]:
    """Multi-layer trainable LSTM (``lstm_stack_train``), layer by layer
    through :func:`lstm_layer_train`. Returns (top outputs (B, T, H),
    (h, c) each (L, B, H)): the final state, or with ``lengths`` the state
    at each row's ``lengths - 1``, gathered from the h and c sequences
    (differentiable). With a ``generator`` and ``dropout`` > 0, a fresh
    (B, T, H) mask drops every layer's output but the last before it feeds
    the next layer; the state keeps the value before dropout."""
    B = xs.shape[0]
    if state is None:
        z = torch.zeros((len(lstm.layers), B, lstm.hidden_dim),
                        device=xs.device)
        state = (z, z)
    seq = xs
    hs, cs = [], []
    n = len(lstm.layers)
    for li, layer in enumerate(lstm.layers):
        seq, c_seq, hT, cT = lstm_layer_train(layer.wx, layer.wh, layer.b,
                                              seq, state[0][li],
                                              state[1][li], dtype)
        if lengths is not None:
            hT, cT = gather_at(seq, lengths), gather_at(c_seq, lengths)
        hs.append(hT)
        cs.append(cT)
        if generator is not None and dropout > 0.0 and li < n - 1:
            seq = L.dropout(seq, dropout, generator)
    return seq, (torch.stack(hs), torch.stack(cs))
