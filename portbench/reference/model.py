"""The model's equations in plain PyTorch, float32, TF32 off.

A frozen copy of the published model (ksg14/multi-modal-qg) as the port
serves it:

  text     E[ids] -> LSTM x text_layers over the context; outputs zeroed
           past its length; (h, c) of every layer at the last token seeds
           the decoder
  video    uint8 frames / 255, (x - mean) / std -> [3x3 VALID conv, ReLU,
           eval batchnorm] x 4 with a 3x3 max pool after the 2nd and 4th
           -> NHWC flatten -> LSTM(flatten_dim -> Hv) over the frames
  audio    int16 / 32768 -> 25 ms periodic-Hann frames every 10 ms, the
           DFT magnitude at 512 points (sqrt(re^2 + im^2 + 1e-12)), the
           HTK mel matrix (64 bins, 125-7500 Hz, DC bin zeroed),
           log(mel + 0.01) -> 96-frame examples -> VGGish (six 3x3 SAME
           convs with ReLU, 2x2 pools after blocks 1, 2, 3, 4; NHWC flatten;
           fc 4096, 4096, Ha, each with ReLU); one embedding per whole
           example
  decoder  attn: q = [E[w]; h_top], three location heads
           softmax(q W_m + b_m) masked past each memory's length, their
           contexts, x = [E[w]; ctx_text; ctx_audio; ctx_video];
           non_attn: x = [E[w]; masked mean audio; masked mean video];
           an LSTM step over dec_layers, logits = h_top W + b

``precision="fp8"`` is the control: every operand of every product (the
matmuls, the convs, the attention's scores and contexts) rounded to
float8 e4m3 with one scale per tensor (its max at 448), products summed
in float32; under autograd the backward's products round their operands
(the incoming gradient, the saved inputs and weights) the same way.

``grad=True`` makes the parameters leaves that autograd differentiates
(``train.py``), and ``train=True`` runs the video batchnorm on the
batch's statistics (biased variance over the valid frames) as training
does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
NEG = -1e30
START, END, PAD = 1, 2, 0


def exact_f32() -> None:
    """Float32 products stay float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mel_matrix(bins: int, n_freq: int, rate: int, lo_hz: float,
               hi_hz: float) -> np.ndarray:
    """(n_freq, bins) HTK triangular filters on the linear frequency axis
    0..rate/2, edges evenly spaced in mel between ``lo_hz`` and
    ``hi_hz``; the DC row is zero."""
    mel = lambda hz: 1127.0 * np.log1p(np.asarray(hz, np.float64) / 700.0)
    f = mel(np.linspace(0.0, rate / 2.0, n_freq))
    e = np.linspace(mel(lo_hz), mel(hi_hz), bins + 2)
    m = np.zeros((n_freq, bins))
    for k in range(bins):
        up = (f - e[k]) / (e[k + 1] - e[k])
        down = (e[k + 2] - f) / (e[k + 2] - e[k + 1])
        m[:, k] = np.clip(np.minimum(up, down), 0.0, None)
    m[0] = 0.0
    return m.astype(np.float32)


def dft_basis(window: int, fft: int) -> np.ndarray:
    """(window, 2 * (fft // 2 + 1)): the periodic-Hann windowed real and
    imaginary DFT rows of a frame of ``window`` samples zero-padded to
    ``fft``."""
    n = np.arange(window)[:, None]
    k = np.arange(fft // 2 + 1)[None, :]
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(window) / window)
    ang = 2.0 * np.pi * n * k / fft
    return np.concatenate([hann[:, None] * np.cos(ang),
                           -hann[:, None] * np.sin(ang)], 1).astype(np.float32)


def fp8(x: Tensor) -> Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x.detach() / s).to(torch.float8_e4m3fn).float() * s


class _MatmulFp8(torch.autograd.Function):
    """``x @ w`` (x (..., K), w (K, N)) with fp8 operands both ways."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8(x), fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8(g)
        gx = gq @ wq.t()
        gw = xq.reshape(-1, xq.shape[-1]).t() @ gq.reshape(-1, gq.shape[-1])
        return gx, gw


class _BmmFp8(torch.autograd.Function):
    """``einsum("bl,blh->bh", a, m)`` with fp8 operands both ways."""

    @staticmethod
    def forward(ctx, a, m):
        aq, mq = fp8(a), fp8(m)
        ctx.save_for_backward(aq, mq)
        return torch.einsum("bl,blh->bh", aq, mq)

    @staticmethod
    def backward(ctx, g):
        aq, mq = ctx.saved_tensors
        gq = fp8(g)
        return (torch.einsum("bh,blh->bl", gq, mq),
                torch.einsum("bh,bl->blh", gq, aq))


class _ConvFp8(torch.autograd.Function):
    """``F.conv2d(x, w, padding=pad)`` (NCHW, OIHW) with fp8 operands both
    ways."""

    @staticmethod
    def forward(ctx, x, w, pad):
        xq, wq = fp8(x), fp8(w)
        ctx.save_for_backward(xq, wq)
        ctx.pad = pad
        return F.conv2d(xq, wq, padding=pad)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8(g)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, padding=ctx.pad)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, padding=ctx.pad)
        return gx, gw, None


class Reference:
    def __init__(self, cfg: Dict, params: Dict, state: Dict, device,
                 precision: str = "f32", grad: bool = False):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        exact_f32()
        self.cfg, self.precision = cfg, precision
        self.dev = torch.device(device)
        t = lambda a: torch.tensor(np.asarray(a, np.float32),
                                   device=self.dev)
        self.p = _tree(params, lambda a: t(a).requires_grad_(grad))
        self.s = _tree(state, t)
        if cfg["mode"] == "trimodal":
            fft = 1 << math.ceil(math.log2(cfg["stft_window"]))
            self.dft = t(dft_basis(cfg["stft_window"], fft))
            self.mel = t(mel_matrix(cfg["mel_bins"], fft // 2 + 1,
                                    cfg["sample_rate"], cfg["mel_min_hz"],
                                    cfg["mel_max_hz"]))

    # ------------------------------------------------------------ products
    def mm(self, x: Tensor, w: Tensor) -> Tensor:
        if self.precision == "fp8":
            return _MatmulFp8.apply(x, w)
        return torch.matmul(x, w)

    def bmm(self, a: Tensor, m: Tensor) -> Tensor:
        if self.precision == "fp8":
            return _BmmFp8.apply(a, m)
        return torch.einsum("bl,blh->bh", a, m)

    def conv(self, x: Tensor, w: Tensor, b: Tensor, pad: int) -> Tensor:
        """NCHW ``x``, HWIO ``w``."""
        w = w.permute(3, 2, 0, 1)
        if self.precision == "fp8":
            return _ConvFp8.apply(x, w, pad) + b[:, None, None]
        return F.conv2d(x, w, b, padding=pad)

    # -------------------------------------------------------------- LSTMs
    def lstm(self, layers: Sequence[Dict], xs: Tensor, lengths: Tensor):
        """Stack over ``xs (B, T, In)`` from a zero state; returns (top
        outputs zeroed past the lengths, [(h, c) at each row's last step]
        per layer)."""
        B, T, _ = xs.shape
        seq, finals = xs, []
        for lay in layers:
            H = lay["wh"].shape[0]
            xp = self.mm(seq, lay["wx"]) + lay["b"]
            h = c = hl = cl = torch.zeros(B, H, device=self.dev)
            outs = []
            for t in range(T):
                g = xp[:, t] + self.mm(h, lay["wh"])
                i, f, gg, o = g.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
                h = torch.sigmoid(o) * torch.tanh(c)
                outs.append(torch.where((t < lengths)[:, None], h, 0.0))
                last = (lengths - 1 == t)[:, None]
                hl, cl = torch.where(last, h, hl), torch.where(last, c, cl)
            seq = torch.stack(outs, 1)
            finals.append((hl, cl))
        return seq, finals

    # ------------------------------------------------------------ encoders
    def text(self, ids: List[np.ndarray]):
        lens = torch.tensor([len(x) for x in ids], device=self.dev)
        T = int(lens.max())
        pad = np.zeros((len(ids), T), np.int64)
        for i, x in enumerate(ids):
            pad[i, :len(x)] = x
        emb = self.p["embedding"]["table"][torch.as_tensor(pad,
                                                           device=self.dev)]
        seq, finals = self.lstm(self.p["text_enc"]["lstm"]["layers"], emb,
                                lens)
        return seq, lens, finals

    def video(self, frames: List[np.ndarray], train: bool = False):
        cfg, v, st = self.cfg, self.p["video_enc"], self.s["video_enc"]
        lens = torch.tensor([len(f) for f in frames], device=self.dev)
        x = torch.as_tensor(np.concatenate(frames), device=self.dev).float()
        mean = torch.tensor(cfg["vid_mean"], device=self.dev)
        std = torch.tensor(cfg["vid_std"], device=self.dev)
        x = ((x / 255.0 - mean) / std).permute(0, 3, 1, 2)
        for i in range(4):
            x = torch.relu(self.conv(x, v["convs"][i]["w"], v["convs"][i]["b"],
                                     0))
            bn, rs = v["bns"][i], st["bns"][i]
            if train:
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            else:
                mean, var = rs["mean"], rs["var"]
            x = ((x - mean[:, None, None])
                 / torch.sqrt(var[:, None, None] + 1e-5)
                 * bn["scale"][:, None, None] + bn["bias"][:, None, None])
            if i in (1, 3):
                x = F.max_pool2d(x, 3)
        feats = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        per = torch.split(feats, lens.tolist())
        seq = torch.nn.utils.rnn.pad_sequence(list(per), batch_first=True)
        out, _ = self.lstm(v["lstm"]["layers"], seq, lens)
        return out, lens

    def logmel(self, pcm: np.ndarray, n_ex: int) -> Tensor:
        cfg = self.cfg
        win, hop, per = cfg["stft_window"], cfg["stft_hop"], cfg["mel_frames"]
        n_frames = n_ex * per
        need = (n_frames - 1) * hop + win
        x = np.zeros((max(need, len(pcm)),), np.float32)
        x[:len(pcm)] = pcm.astype(np.float32) / 32768.0
        x = torch.as_tensor(x, device=self.dev)
        frames = x.unfold(0, win, hop)[:n_frames]           # (n_frames, win)
        spec = self.mm(frames, self.dft)
        half = spec.shape[1] // 2
        mag = torch.sqrt(spec[:, :half] ** 2 + spec[:, half:] ** 2 + 1e-12)
        mel = torch.log(self.mm(mag, self.mel) + cfg["log_offset"])
        return mel.reshape(n_ex, per, cfg["mel_bins"])

    def vggish(self, mel: Tensor) -> Tensor:
        a = self.p["audio_enc"]
        x = mel[:, None]
        ci = 0
        for _, reps in ((64, 1), (128, 1), (256, 2), (512, 2)):
            for _ in range(reps):
                c = a["convs"][ci]
                x = torch.relu(self.conv(x, c["w"], c["b"], 1))
                ci += 1
            x = F.max_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for k in ("fc1", "fc2", "fc3"):
            x = torch.relu(self.mm(x, a[k]["w"]) + a[k]["b"])
        return x

    def audio(self, pcms: List[np.ndarray]):
        cfg = self.cfg
        win, hop, per = cfg["stft_window"], cfg["stft_hop"], cfg["mel_frames"]
        counts = [min(max(0, (len(p) - win) // hop + 1) // per,
                      cfg["av_max_length"]) for p in pcms]
        lens = [max(1, n) for n in counts]
        embs = []
        for p, n in zip(pcms, lens):
            embs.append(self.vggish(self.logmel(p, n)))
        seq = torch.nn.utils.rnn.pad_sequence(embs, batch_first=True)
        return seq, torch.tensor(lens, device=self.dev)

    # ------------------------------------------------------------- decoder
    def logits(self, ids: List[np.ndarray], frames: Optional[List],
               pcms: Optional[List], tokens: List[List[int]],
               train: bool = False) -> List[Tensor]:
        """Teacher-forced logits of each request at each served position:
        ``tokens[i]`` are the tokens request i was served; returns per
        request (len(tokens[i]), V) float32, the logits after the prefix
        of served tokens before each position."""
        cfg = self.cfg
        La, Lc = cfg["av_max_length"], cfg["context_max_length"]
        B = len(ids)
        enc_t, len_t, finals = self.text(ids)
        H = enc_t.shape[2]
        zeros = lambda n: torch.zeros(B, La, n, device=self.dev)
        ones = torch.ones(B, dtype=torch.long, device=self.dev)
        enc_v, len_v = zeros(cfg["video_hidden_dim"]), ones
        enc_a, len_a = zeros(cfg["audio_emb_dim"]), ones
        if cfg["mode"] in ("text_video", "trimodal"):
            out, len_v = self.video(frames, train)
            enc_v[:, :out.shape[1]] = out
        if cfg["mode"] == "trimodal":
            out, len_a = self.audio(pcms)
            enc_a[:, :out.shape[1]] = out
        mem_t = torch.zeros(B, Lc, H, device=self.dev)
        mem_t[:, :enc_t.shape[1]] = enc_t
        dec = self.p["decoder"]
        emb_table = self.p["embedding"]["table"]
        S = max(len(t) for t in tokens)
        inp = np.full((B, S), PAD, np.int64)
        inp[:, 0] = START
        for i, t in enumerate(tokens):
            inp[i, 1:len(t)] = t[:-1]
        inp = torch.as_tensor(inp, device=self.dev)
        h = [f[0] for f in finals]
        c = [f[1] for f in finals]
        if cfg["decoder"] == "non_attn":
            av = torch.cat([_masked_mean(enc_a, len_a),
                            _masked_mean(enc_v, len_v)], -1)
        else:
            at = dec["attn"]
            w = torch.cat([at["w_text"], at["w_video"], at["w_audio"]], 1)
            b = torch.cat([at["b_text"], at["b_video"], at["b_audio"]])
        steps = []
        for s in range(S):
            e = emb_table[inp[:, s]]
            if cfg["decoder"] == "attn":
                scores = self.mm(torch.cat([e, h[-1]], -1), w) + b
                ctx = []
                for lo, hi, mem, n in ((0, Lc, mem_t, len_t),
                                       (Lc, Lc + La, enc_v, len_v),
                                       (Lc + La, Lc + 2 * La, enc_a, len_a)):
                    sc = scores[:, lo:hi]
                    live = (torch.arange(hi - lo, device=self.dev)[None]
                            < n[:, None])
                    alpha = torch.softmax(torch.where(live, sc, NEG), -1)
                    ctx.append(self.bmm(alpha, mem))
                x = torch.cat([e, ctx[0], ctx[2], ctx[1]], -1)
            else:
                x = torch.cat([e, av], -1)
            for li, lay in enumerate(dec["lstm"]["layers"]):
                g = (self.mm(x, lay["wx"]) + self.mm(h[li], lay["wh"])
                     + lay["b"])
                i, f, gg, o = g.chunk(4, -1)
                c[li] = (torch.sigmoid(f) * c[li]
                         + torch.sigmoid(i) * torch.tanh(gg))
                h[li] = torch.sigmoid(o) * torch.tanh(c[li])
                x = h[li]
            steps.append(self.mm(x, dec["out"]["w"]) + dec["out"]["b"])
        logits = torch.stack(steps, 1)
        return [logits[i, :len(t)] for i, t in enumerate(tokens)]


    def loss(self, ids, frames, pcms, targets: List[List[int]]):
        """Teacher-forced cross-entropy of each row's target tokens (the
        question and ``<end>``), in training mode: (objective, loss) with
        objective = mean over rows of each row's summed CE (what the
        gradients are of) and loss = mean over rows of its CE per target
        token."""
        zs = self.logits(ids, frames, pcms, targets, train=True)
        ce = [-torch.log_softmax(z, -1).gather(
            1, torch.tensor(t, device=self.dev)[:, None]).sum() for z, t in
              zip(zs, targets)]
        obj = torch.stack(ce).sum() / len(ce)
        per = torch.stack([c / len(t) for c, t in zip(ce, targets)])
        return obj, per.mean()


def _masked_mean(m: Tensor, n: Tensor) -> Tensor:
    live = (torch.arange(m.shape[1], device=m.device)[None] < n[:, None])
    return (m * live[..., None]).sum(1) / n.clamp(min=1)[:, None]


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, fn) for v in node]
    return fn(node)
