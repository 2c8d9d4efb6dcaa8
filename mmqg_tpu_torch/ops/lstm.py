"""K1: one LSTM layer over a whole sequence (the encoders' hot loop).

Counterpart of ``mmqg_tpu/ops/lstm_pallas.py``: ``lstm_seq`` replaces
``lstm_layer_pallas`` and ``lstm_stack`` replaces ``lstm_stack_pallas``.
On a CUDA tensor :func:`lstm_seq` launches the hand-written kernel in
``csrc/lstm_seq.cu`` (the LSTM forward of ``csrc/lstm.cuh``: see its header
for the design) by a route picked from the shape; on a CPU tensor it runs
:func:`lstm_seq_plain`, the same function in plain PyTorch. There is no
other path: any other device raises, and so does a cooperative launch the
device refuses.

Numerics (``layers._cell``): operands in the compute dtype, f32 products,
sums, gates and state. Output h_t is zeroed for t >= length (the Pallas
kernel's ``mask_output=True``, the only way the encoders call it); (h, c) at
length-1 are latched into separate outputs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops import _build

Tensor = torch.Tensor

_DTYPES = (torch.float32, torch.bfloat16)


def lstm_seq_plain(xs: Tensor, wx: Tensor, wh: Tensor, b: Tensor,
                   h0: Tensor, c0: Tensor, lengths: Tensor, *,
                   dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the kernel: the input projection for all
    steps at once, then a loop over time."""
    T = xs.shape[1]
    xproj = L.mm(xs, wx, dtype) + b                 # (B, T, 4H)
    whr = wh.to(dtype).float()
    lengths = lengths.to(xs.device)
    h, c, lh, lc = h0, c0, h0, c0
    outs: List[Tensor] = []
    for t in range(T):
        gates = xproj[:, t] + torch.matmul(h.to(dtype).float(), whr)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        live = (lengths > t)[:, None]
        outs.append(torch.where(live, h, 0.0))
        last = (lengths - 1 == t)[:, None]
        lh = torch.where(last, h, lh)
        lc = torch.where(last, c, lc)
    return torch.stack(outs, dim=1), lh, lc


def lstm_seq(xs: Tensor, wx: Tensor, wh: Tensor, b: Tensor, h0: Tensor,
             c0: Tensor, lengths: Tensor, *,
             dtype: torch.dtype = torch.bfloat16,
             force_route: Optional[str] = None
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Run one LSTM layer over ``xs (B, T, In)`` with weights ``wx (In, 4H)``,
    ``wh (H, 4H)``, ``b (4H,)``, initial state ``h0``/``c0 (B, H)`` and
    ``lengths (B,)``. Returns (outputs (B, T, H), h at length, c at length),
    all float32. On CUDA each call counts one launch (``lstm_seq.launches``)
    and one of its route (``lstm_seq.routes``): "persistent", one
    cooperative launch for all steps (for each chunk of rows a grid of
    resident blocks holds), where the shape allows, else "per_step".
    ``force_route`` replaces that choice (``_build.sweep_rows``):
    "per_step" runs the earlier design (a yardstick), "persistent" the
    whole batch in one cooperative launch, which raises where the device
    refuses it.
    """
    if force_route not in (None,) + _build.ROUTES:
        raise ValueError(f"lstm_seq: no route {force_route!r}")
    if xs.device.type == "cpu":
        return lstm_seq_plain(xs, wx, wh, b, h0, c0, lengths, dtype=dtype)
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_seq: no kernel for device {xs.device}")
    if dtype not in _DTYPES:
        raise ValueError(f"lstm_seq: compute dtype {dtype} not supported")
    B, T, In = xs.shape
    H = wh.shape[0]
    x, wxc, whc = xs.to(dtype), wx.to(dtype), wh.to(dtype)
    shapes = {"wx": (wxc, (In, 4 * H), dtype), "wh": (whc, (H, 4 * H), dtype),
              "b": (b, (4 * H,), torch.float32),
              "h0": (h0, (B, H), torch.float32),
              "c0": (c0, (B, H), torch.float32),
              "lengths": (lengths, (B,), torch.int32), "xs": (x, (B, T, In), dtype)}
    for name, (t, shape, dt) in shapes.items():
        if t.device != xs.device:
            raise ValueError(f"lstm_seq: {name} on {t.device}, xs on {xs.device}")
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"lstm_seq: {name} is {tuple(t.shape)} {t.dtype},"
                             f" the kernel takes {shape} {dt}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_seq: {name} is not contiguous")
    if H % 8 or T < 1:
        raise ValueError(f"lstm_seq: kernel needs H % 8 == 0 and T >= 1 "
                         f"(H={H}, T={T})")
    lib = _build.library()
    dev = xs.device
    xproj = torch.empty((B, T, 4 * H), dtype=torch.float32, device=dev)
    # h in the compute dtype, ping-ponged: h_{t-1} of step t in hbuf[t % 2]
    hbuf = torch.empty((2, B, H), dtype=dtype, device=dev)
    hbuf[0].copy_(h0)
    c = c0.clone()
    sync = torch.empty((1,), dtype=torch.int32, device=dev)  # grid barrier
    out = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    h_last, c_last = h0.clone(), c0.clone()
    with torch.cuda.device(dev):
        rows = _build.sweep_rows("mmqg_lstm_seq_rows", B, H,
                                 dtype == torch.bfloat16,
                                 torch.cuda.current_device(), force_route)
        rc = lib.mmqg_lstm_seq(
            x.data_ptr(), wxc.data_ptr(), whc.data_ptr(), b.data_ptr(),
            lengths.data_ptr(), xproj.data_ptr(), hbuf.data_ptr(),
            c.data_ptr(), sync.data_ptr(), out.data_ptr(), h_last.data_ptr(),
            c_last.data_ptr(), B, T, In, H, int(dtype == torch.bfloat16),
            rows, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mmqg_lstm_seq")
    with _build.COUNT_LOCK:
        lstm_seq.launches += 1
        lstm_seq.routes[_build.route_of(rows)] += 1
    return out, h_last, c_last


lstm_seq.launches = 0
lstm_seq.routes = dict.fromkeys(_build.ROUTES, 0)  # launches by route


def lstm_stack(lstm: L.LSTM, xs: Tensor, lengths: Tensor, *,
               dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, L.State]:
    """Multi-layer sequence LSTM from a zero state (``lstm_stack_pallas``):
    every layer's outputs are masked past the length, and the returned
    (h, c), each (L, B, H), are the states latched at each row's length."""
    z = torch.zeros((xs.shape[0], lstm.hidden_dim), device=xs.device)
    seq = xs
    hs, cs = [], []
    for layer in lstm.layers:
        seq, h, c = lstm_seq(seq, layer.wx, layer.wh, layer.b, z, z, lengths,
                             dtype=dtype)
        hs.append(h)
        cs.append(c)
    return seq, (torch.stack(hs), torch.stack(cs))
