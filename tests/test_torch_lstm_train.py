"""K4 of the PyTorch port (``ops/lstm_train.py``) vs the JAX package: the
plain forward and the autograd Function's plain backward against the Pallas
``lstm_layer_train`` in interpret mode (forward and ``jax.vjp``), against
``jax.grad`` through ``layers.lstm_scan``, and against torch autograd
through a Python-loop LSTM.

f32 throughout: the forward within atol 1e-5, every gradient within 1e-4
relative (max |d| over max |reference| per array)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmqg_tpu.ops.lstm_train_pallas as K
from mmqg_tpu.models import layers as JL
from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops.lstm_train import (lstm_layer_train,
                                           lstm_stack_train,
                                           lstm_train_fwd_plain)

torch.set_num_threads(1)
FWD_ATOL, GRAD_RTOL = 1e-5, 1e-4

# (B, T, In, H, nonzero initial state)
CASES = [(2, 5, 4, 8, False), (3, 7, 6, 8, True), (2, 1, 8, 8, True),
         (4, 6, 16, 8, False)]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(K, "_INTERPRET", True)


def _inputs(B, T, In, H, state, seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32
    arrs = {"wx": (rng.randn(In, 4 * H) / np.sqrt(In)).astype(f),
            "wh": (rng.randn(H, 4 * H) / np.sqrt(H)).astype(f),
            "b": rng.randn(4 * H).astype(f),
            "xs": rng.randn(B, T, In).astype(f),
            "h0": (rng.randn(B, H) * state).astype(f),
            "c0": (rng.randn(B, H) * state).astype(f)}
    cots = (rng.randn(B, T, H).astype(f), rng.randn(B, T, H).astype(f),
            rng.randn(B, H).astype(f), rng.randn(B, H).astype(f))
    return arrs, cots


def _torch(arrs):
    return {k: torch.tensor(v, requires_grad=True) for k, v in arrs.items()}


def _port_vjp(arrs, cots):
    t = _torch(arrs)
    outs = lstm_layer_train(t["wx"], t["wh"], t["b"], t["xs"], t["h0"],
                            t["c0"], torch.float32)
    torch.autograd.backward(outs, [torch.tensor(c) for c in cots])
    return outs, {k: v.grad.numpy() for k, v in t.items()}


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("B,T,In,H,state", CASES)
def test_forward_and_vjp_match_pallas_interpret(B, T, In, H, state):
    arrs, cots = _inputs(B, T, In, H, state)
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    ref, vjp = jax.vjp(
        lambda wx, wh, b, xs, h0, c0: K.lstm_layer_train(
            wx, wh, b, xs, h0, c0, "float32"),
        j["wx"], j["wh"], j["b"], j["xs"], j["h0"], j["c0"])
    outs, grads = _port_vjp(arrs, cots)
    for g, r in zip(outs, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=FWD_ATOL)
    jg = vjp(tuple(jnp.asarray(c) for c in cots))
    for name, r in zip(("wx", "wh", "b", "xs", "h0", "c0"), jg):
        assert _rel(grads[name], np.asarray(r)) <= GRAD_RTOL, name


@pytest.mark.parametrize("B,T,In,H,state", CASES)
def test_grads_match_jax_grad_of_lstm_scan(B, T, In, H, state):
    arrs, _ = _inputs(B, T, In, H, state, seed=1)
    w_out = np.random.RandomState(9).randn(H, 3).astype(np.float32)

    def jloss(wx, wh, b, xs, h0, c0):
        p = {"layers": [{"wx": wx, "wh": wh, "b": b}]}
        out, (hT, cT) = JL.lstm_scan(p, xs, (h0[None], c0[None]),
                                     dtype=jnp.float32)
        return ((out @ w_out) ** 2).sum() + (hT[0] * cT[0]).sum()

    j = [jnp.asarray(arrs[k]) for k in ("wx", "wh", "b", "xs", "h0", "c0")]
    jg = jax.grad(jloss, argnums=tuple(range(6)))(*j)
    t = _torch(arrs)
    out, _, hT, cT = lstm_layer_train(t["wx"], t["wh"], t["b"], t["xs"],
                                      t["h0"], t["c0"], torch.float32)
    loss = ((out @ torch.tensor(w_out)) ** 2).sum() + (hT * cT).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss(*j)), rtol=1e-5)
    for name, r in zip(("wx", "wh", "b", "xs", "h0", "c0"), jg):
        assert _rel(t[name].grad.numpy(), np.asarray(r)) <= GRAD_RTOL, name


@pytest.mark.parametrize("B,T,In,H,state", CASES)
def test_grads_match_torch_autograd_of_python_loop(B, T, In, H, state):
    arrs, cots = _inputs(B, T, In, H, state, seed=2)
    _, grads = _port_vjp(arrs, cots)
    t = _torch(arrs)
    layer = L.LSTMLayer(t["wx"], t["wh"], t["b"]).requires_grad_(True)
    h, c = t["h0"], t["c0"]
    hs, cs = [], []
    for step in range(T):
        h, c = L.cell(layer, t["xs"][:, step], h, c, dtype=torch.float32)
        hs.append(h)
        cs.append(c)
    outs = (torch.stack(hs, 1), torch.stack(cs, 1), h, c)
    torch.autograd.backward(outs, [torch.tensor(x) for x in cots])
    ref = {"wx": layer.wx.grad, "wh": layer.wh.grad, "b": layer.b.grad,
           "xs": t["xs"].grad, "h0": t["h0"].grad, "c0": t["c0"].grad}
    for name, r in ref.items():
        assert _rel(grads[name], r.numpy()) <= GRAD_RTOL, name


def test_stack_matches_pallas_stack_grads():
    B, T, In, H, NL = 2, 4, 6, 8, 2
    rng = np.random.RandomState(3)
    layers = [{"wx": (rng.randn(In if li == 0 else H, 4 * H) * 0.3
                      ).astype(np.float32),
               "wh": (rng.randn(H, 4 * H) * 0.3).astype(np.float32),
               "b": rng.randn(4 * H).astype(np.float32)} for li in range(NL)]
    xs = rng.randn(B, T, In).astype(np.float32)

    def jloss(p):
        out, (hT, cT) = K.lstm_stack_train(p, jnp.asarray(xs),
                                           dtype_name="float32")
        return (out ** 2).sum() + (hT ** 2).sum() + cT.sum()

    jg = jax.grad(jloss)({"layers": [{k: jnp.asarray(v) for k, v in l.items()}
                                     for l in layers]})
    lstm = L.LSTM([L.LSTMLayer(*(torch.tensor(l[k])
                                 for k in ("wx", "wh", "b")))
                   for l in layers]).requires_grad_(True)
    out, (hT, cT) = lstm_stack_train(lstm, torch.tensor(xs),
                                     dtype=torch.float32)
    ((out ** 2).sum() + (hT ** 2).sum() + cT.sum()).backward()
    for li in range(NL):
        for k in ("wx", "wh", "b"):
            got = getattr(lstm.layers[li], k).grad.numpy()
            ref = np.asarray(jg["layers"][li][k])
            assert _rel(got, ref) <= GRAD_RTOL, f"layer{li}/{k}"


def test_stack_state_at_lengths_matches_pallas_stack_per_row():
    """With ``lengths`` the state is gathered at each row's length - 1 (the
    text encoder's latch): row b's state and its gradient are those of the
    Pallas stack run on that row cut to its length."""
    B, T, In, H, NL = 3, 5, 6, 8, 2
    rng = np.random.RandomState(5)
    layers = [{"wx": (rng.randn(In if li == 0 else H, 4 * H) * 0.3
                      ).astype(np.float32),
               "wh": (rng.randn(H, 4 * H) * 0.3).astype(np.float32),
               "b": rng.randn(4 * H).astype(np.float32)} for li in range(NL)]
    xs = rng.randn(B, T, In).astype(np.float32)
    lens = np.array([5, 2, 1], np.int32)

    def jloss(p):
        total = 0.0
        for r in range(B):
            _, (hT, cT) = K.lstm_stack_train(
                p, jnp.asarray(xs[r:r + 1, :lens[r]]), dtype_name="float32")
            total = total + (hT ** 2).sum() + cT.sum()
        return total

    jp = {"layers": [{k: jnp.asarray(v) for k, v in l.items()}
                     for l in layers]}
    j_states = [K.lstm_stack_train(jp, jnp.asarray(xs[r:r + 1, :lens[r]]),
                                   dtype_name="float32")[1]
                for r in range(B)]
    jg = jax.grad(jloss)(jp)
    lstm = L.LSTM([L.LSTMLayer(*(torch.tensor(l[k])
                                 for k in ("wx", "wh", "b")))
                   for l in layers]).requires_grad_(True)
    _, (hT, cT) = lstm_stack_train(lstm, torch.tensor(xs),
                                   lengths=torch.tensor(lens),
                                   dtype=torch.float32)
    for r, (jh, jc) in enumerate(j_states):
        np.testing.assert_allclose(hT[:, r].detach().numpy(),
                                   np.asarray(jh)[:, 0], atol=FWD_ATOL)
        np.testing.assert_allclose(cT[:, r].detach().numpy(),
                                   np.asarray(jc)[:, 0], atol=FWD_ATOL)
    ((hT ** 2).sum() + cT.sum()).backward()
    for li in range(NL):
        for k in ("wx", "wh", "b"):
            got = getattr(lstm.layers[li], k).grad.numpy()
            ref = np.asarray(jg["layers"][li][k])
            assert _rel(got, ref) <= GRAD_RTOL, f"layer{li}/{k}"


def test_bf16_plain_rounds_operands_like_pallas():
    """bf16: the same rounded operands and f32 sums as the Pallas forward."""
    arrs, _ = _inputs(3, 6, 8, 8, True, seed=4)
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    ref = K.lstm_layer_train(j["wx"], j["wh"], j["b"], j["xs"], j["h0"],
                             j["c0"], "bfloat16")
    t = {k: torch.tensor(v) for k, v in arrs.items()}
    got = lstm_train_fwd_plain(t["wx"], t["wh"], t["b"], t["xs"], t["h0"],
                               t["c0"], torch.bfloat16)
    for g, r in zip((got[0], got[1], got[3], got[4]), ref):
        # one summation-order flip moves h by a bf16 ulp before the next Wh
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-2)


def test_cpu_runs_plain_and_other_devices_raise():
    arrs, _ = _inputs(2, 3, 4, 8, False)
    t = {k: torch.tensor(v) for k, v in arrs.items()}
    before = (lstm_layer_train.fwd_launches, lstm_layer_train.bwd_launches)
    lstm_layer_train(t["wx"], t["wh"], t["b"], t["xs"], t["h0"], t["c0"])
    assert (lstm_layer_train.fwd_launches,
            lstm_layer_train.bwd_launches) == before
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="no kernel for device"):
        lstm_layer_train(meta["wx"], meta["wh"], meta["b"], meta["xs"],
                         meta["h0"], meta["c0"])
