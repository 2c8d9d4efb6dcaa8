"""The Video Swin window attention (``ops/window_attention.py``): its plain
PyTorch path against an independent per-window explicit softmax in float64
(the (8, 7, 7) grid's relative-position index written out, the rolled
volume's regions and each clip's padded keys from coordinates), the model's
block against the formulation it replaced, the wrapper's dispatch and the
trunk's counters, on the CPU; and, on the card, the kernel
(``csrc/window_attention.cu``) against the plain path in bf16 and float32.

The cases cover unshifted and shifted blocks; windows whose keys are all
live, mixed and padding alone, with a clip whose rolled temporal shift
wraps its first live tokens into the last row; a temporal window under 8
and spatial windows under 7 (the bias from the first rows and columns of
the (8, 7, 7) index, as torchvision slices it); 4 and 32 heads. The card
case needs an NVIDIA GPU and nvcc and skips without them; it imports no
JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_window_attention.py
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmqg_tpu_torch.models import video_swin as S
from mmqg_tpu_torch.ops import window_attention as WA

torch.set_num_threads(1)
TOL = 1e-5        # float32 plain path vs the float64 softmax, of max |ref|
WINDOW = (8, 7, 7)

# (T, H, W) of the volume, shifted, heads, each clip's live temporal tokens
CASES = {
    # nt 3 x 2 x 2 windows; shifted: the 20-token clip's last row holds
    # 20..23 (padded) then 0..3 (live, wrapped); the 3-token clip's first
    # two rows hold no live token
    "t20_hw14_unshifted_h4": ((20, 14, 14), False, 4, (20, 3, 12)),
    "t20_hw14_shifted_h4": ((20, 14, 14), True, 4, (20, 3, 12)),
    # a temporal window of 6 and spatial ones of 5 x 4: N = 120 of the
    # (8, 7, 7) numbering, no shift on any axis
    "t6_h5w4_shifted_h4": ((6, 5, 4), True, 4, (6, 2)),
    "t6_h5w4_unshifted_h32": ((6, 5, 4), False, 32, (1, 6)),
    # T and H shifted, W a window of 4: the last windows along T and H
    # hold two regions each
    "t12_h9w4_shifted_h32": ((12, 9, 4), True, 32, (12, 5)),
    "t12_h9w4_unshifted_h32": ((12, 9, 4), False, 32, (12, 5)),
    # 9 tokens: shift 4 over a padded axis of 16
    "t9_hw8_shifted_h4": ((9, 8, 8), True, 4, (9, 1, 4)),
}


def _geometry(size, shifted):
    win, shift = S.window_and_shift(size, shifted)
    padded = tuple(-(-n // w) * w for n, w in zip(size, win))
    grid = tuple(n // w for n, w in zip(padded, win))
    return win, shift, padded, grid


def _inputs(case, dtype=torch.float32, device="cpu", seed=0):
    size, shifted, heads, lives = CASES[case]
    win, shift, padded, grid = _geometry(size, shifted)
    rows = S.Rows(torch.tensor(lives, device=device), size[0])
    g = torch.Generator().manual_seed(seed)
    n_win = len(lives) * math.prod(grid)
    qkv = torch.randn((n_win, math.prod(win), 3, heads, WA.HEAD),
                      generator=g)
    table = torch.randn((WA.TABLE, heads), generator=g)
    return (qkv.to(device, dtype), table.to(device), rows, grid, win, shift,
            padded, lives)


def _flat_coords(n):
    """Token n's (t, h, w) in the (8, 7, 7) window's numbering."""
    return n // (WINDOW[1] * WINDOW[2]), n // WINDOW[2] % WINDOW[1], \
        n % WINDOW[2]


def _region(p, n, w, s):
    """The region of rolled position p on an axis of padded length n."""
    if not s:
        return 0
    return 0 if p < n - w else 1 if p < n - s else 2


def _explicit(qkv, table, grid, win, shift, padded, lives):
    """Each window's softmax in float64, written out: (windows, N,
    heads * 32); windows with no live key zero."""
    q_all = qkv.double()
    n_win, N, _, heads, D = q_all.shape
    nt, nh, nw = grid
    out = torch.zeros((n_win, N, heads * D), dtype=torch.float64)
    flat = torch.tensor([_flat_coords(n) for n in range(N)])
    d = flat[:, None, :] - flat[None, :, :]
    rel = ((d[..., 0] + 7) * 13 + d[..., 1] + 6) * 13 + d[..., 2] + 6
    coords = [np.unravel_index(n, win) for n in range(N)]
    for w in range(n_win):
        b, rest = divmod(w, nt * nh * nw)
        at = (rest // (nh * nw), rest // nw % nh, rest % nw)
        reg = torch.tensor([[_region(at[a] * win[a] + c[a], padded[a],
                                     win[a], shift[a]) for a in range(3)]
                            for c in coords])
        live = torch.tensor([
            bool((at[0] * win[0] + c[0] + shift[0]) % padded[0] < lives[b])
            for c in coords])
        if not live.any():
            continue
        apart = (reg[:, None, :] != reg[None, :, :]).any(-1)
        for h in range(heads):
            q, k, v = (q_all[w, :, s, h] for s in range(3))
            scores = (q @ k.t() / math.sqrt(D) + table.double()[rel, h]
                      - 100.0 * apart)
            scores[:, ~live] = -math.inf
            out[w, :, h * D:(h + 1) * D] = torch.softmax(scores, -1) @ v
    return out


def _rel_err(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_path_matches_an_explicit_softmax(case):
    qkv, table, rows, grid, win, shift, padded, lives = _inputs(case)
    got = WA.window_attention_plain(qkv, table, rows, grid, win, shift)
    want = _explicit(qkv, table, grid, win, shift, padded, lives)
    assert got.shape == want.shape
    assert _rel_err(got, want) <= TOL
    # the windows of padding alone, and only they, are exact zeros
    dead = want.view(want.shape[0], -1).abs().amax(1) == 0
    assert torch.equal(got.view(got.shape[0], -1).abs().amax(1) == 0, dead)


def _replaced_attention(block, x, rows, dtype):
    """The block's attention as the models module computed it before the
    kernel: every window with the bias (and the shift's regions), the
    mixed rows again with their padded keys masked, the windows of padding
    alone unmasked."""
    B, T, H, W, C = x.shape
    h = block.heads
    win, shift, padded, (nt, nh, nw) = _geometry((T, H, W), block.shifted)
    hw = nh * nw
    N = math.prod(win)
    into, back = S._window_order((T, H, W), win, shift, x.device)
    src = torch.zeros((B, T * H * W + 1, C), dtype=dtype)
    src[:, :-1] = x.view(B, -1, C)
    xw = src.index_select(1, into).view(B * nt * hw, N, C)
    q, k, v = block.qkv(xw, dtype).view(-1, N, 3, h, C // h).permute(
        2, 0, 3, 1, 4)
    idx = S.relative_position_index()[:N, :N].reshape(-1)
    mask = block.rel_bias.t().to(dtype)[:, idx].view(h, N, N).expand(
        B, nt, hw, h, N, N)
    if any(shift):
        region = S._region_mask(padded, win, shift, dtype, x.device)
        mask = mask + region.view(nt, hw, 1, N, N)
    mask = mask.reshape(-1, h, N, N)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         scale=(C // h) ** -0.5)
    out = out.transpose(1, 2).reshape(-1, N, C)
    r = rows.mixed[shift[0]]
    sel = (r[:, None] * hw + torch.arange(hw)).reshape(-1)
    masked = mask.view(B * nt, hw, h, N, N)[r] + rows.key_neg(
        r, win, shift, dtype)[:, None, None, None, :]
    o = F.scaled_dot_product_attention(
        q[sel], k[sel], v[sel], attn_mask=masked.view(-1, h, N, N),
        scale=(C // h) ** -0.5)
    out[sel] = o.transpose(1, 2).reshape(-1, N, C)
    y = block.proj(out, dtype).view(B, -1, C)
    return y.index_select(1, back).view(B, T, H, W, C)


@pytest.fixture(scope="module")
def narrow_blocks():
    """Stage 1's two blocks of a narrow tree (C 64, 2 heads)."""
    params, _ = S.init_numpy(np.random.RandomState(3), embed_dim=64,
                             depths=(2, 2, 2, 2), heads=(2, 4, 8, 16))
    for blk in params["stages"][0]:     # a bias that moves the scores
        blk["rel_bias"] = blk["rel_bias"] * 50
    return S.build(params, torch.tensor).stages[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
@pytest.mark.parametrize("shifted", [False, True],
                         ids=["unshifted", "shifted"])
def test_block_keeps_the_live_outputs_it_had(narrow_blocks, shifted, dtype):
    """The block's attention equals the replaced formulation at every
    live token (bit for bit: the same operations there); only tokens at
    or past a clip's length may differ."""
    block = narrow_blocks[int(shifted)]
    assert block.shifted == shifted
    g = torch.Generator().manual_seed(5)
    x = torch.randn((3, 12, 9, 10, 64), generator=g)
    live = torch.tensor([12, 2, 7])
    rows = S.Rows(live, 12)
    with torch.no_grad():
        got = block.attention(x, rows, dtype)
        want = _replaced_attention(block, x, rows, dtype)
    keep = torch.arange(12)[None, :] < live[:, None]
    assert torch.equal(got[keep], want[keep])
    assert not torch.equal(got[~keep], want[~keep])


def test_cpu_tensors_take_the_plain_path():
    qkv, table, rows, grid, win, shift, _, _ = _inputs("t20_hw14_shifted_h4")
    before = WA.window_attention.launches
    got = WA.window_attention(qkv, table, rows, grid, win, shift)
    assert WA.window_attention.launches == before == 0
    assert torch.equal(got, WA.window_attention_plain(qkv, table, rows, grid,
                                                      win, shift))


def test_no_kernel_for_another_device():
    qkv, table, rows, grid, win, shift, _, _ = _inputs("t9_hw8_shifted_h4")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        WA.window_attention(qkv.to("meta"), table, rows, grid, win, shift)


def test_skipped_counts_the_windows_of_padding_alone():
    """A narrow trunk over two clips of 20 and 5 frames at 64 px (10 and
    3 temporal tokens): each block's skipped windows are its windows less
    its live ones, some in every block, as many as the rows say."""
    params, _ = S.init_numpy(np.random.RandomState(4), embed_dim=32,
                             depths=(2, 2, 2, 2), heads=(1, 2, 4, 8))
    model = S.build(params, torch.tensor)
    clips = torch.randn((2, 20, 64, 64, 3),
                        generator=torch.Generator().manual_seed(6))
    live = S.temporal_out_len(torch.tensor([20, 5]))
    before = dict(S.windows)
    with torch.no_grad():
        model.temporal(clips, live, dtype=torch.float32)
    moved = {k: S.windows[k] - before[k] for k in before}
    assert moved["attn_calls"] == 8 and moved["trunks"] == 1
    assert moved["skipped"] == moved["windows"] - moved["live_windows"] > 0
    rows = S.Rows(live, 10)
    # 10 tokens: rows of 8 over 16; the 3-token clip has no live token in
    # its second row unshifted, nor in its first shifted (4..11)
    assert rows.live_rows == {0: 3, 4: 3}
    assert [r.tolist() for r in rows.dead.values()] == [[3], [2]]


# ------------------------------------------------------------------ the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from mmqg_tpu_torch.ops import _build
    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _live_queries(rows, grid, win, shift):
    """(windows, N): True at each window token whose rolled temporal
    position lies before its clip's live length."""
    nt, nh, nw = grid
    t = (torch.arange(nt)[:, None] * win[0] + torch.arange(win[0])
         + shift[0]) % (nt * win[0])
    live = t[None].to(rows.live.device) < rows.live[:, None, None]
    return live[:, :, None].expand(-1, -1, nh * nw, -1).repeat_interleave(
        win[1] * win[2], -1).reshape(-1, math.prod(win))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_the_plain_path_on_the_card(dev, case, dtype):
    """One launch; the windows of padding alone exactly zero; at the live
    tokens within two bf16 steps of the plain path (bf16: the
    probabilities are rounded for P.V in both, in other orders) or float32
    rounding. Padded tokens' outputs are read by no live token, and
    cuDNN's bf16 attention leaves them inexact where every live key of
    theirs lies in another region (-100)."""
    qkv, table, rows, grid, win, shift, _, _ = _inputs(case, dtype, dev)
    before = WA.window_attention.launches
    with torch.no_grad():
        got = WA.window_attention(qkv, table, rows, grid, win, shift)
        want = WA.window_attention_plain(qkv, table, rows, grid, win, shift)
    torch.cuda.synchronize()
    assert WA.window_attention.launches == before + 1
    dead = want.view(want.shape[0], -1).abs().amax(1) == 0
    assert torch.equal(got.view(got.shape[0], -1).abs().amax(1) == 0, dead)
    live = _live_queries(rows, grid, win, shift)
    tol = 2 ** -6 if dtype == torch.bfloat16 else 1e-5
    assert _rel_err(got[live].float(), want[live].double()) <= tol
