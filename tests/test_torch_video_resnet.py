"""The port's R(2+1)D-18 video encoder (``mmqg_tpu_torch/models/
video_resnet.py``) vs the JAX package's, and the torchvision-layout
importer (``mmqg_tpu_torch/compat/from_torchvision.py``).

Same numpy weights (torch-default conv init, random batchnorm statistics)
and clips of 17 frames at 32 x 32 px through both, f32 on the CPU:

* eval: ``apply`` and ``apply_temporal``, with and without the ``fc``
  head, within 1e-5 (of max(1, |reference|));
* train, layer by layer: the stem and every block fed the JAX package's
  input to it, outputs within 1e-5 of max(1, |reference|) and the new
  batchnorm states within 1e-6;
* train, the whole trunk: batchnorm over every position normalises
  stage 4 over 2 x 3 x 2 x 2 = 24 positions a channel, which amplifies f32
  rounding, so the two packages' f32 trunks differ by 8.0e-5 of the
  output's max. Both are held to the port run in float64 instead: the
  port's f32 trunk is 2.5e-5 from it, the JAX package's 6.8e-5 (its own
  f32 rounding); the band is 1e-4 of the max, and 5e-6 for the states
  (port 8.7e-7, JAX 2.2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mmqg_tpu.models import layers as JL
from mmqg_tpu.models import video_resnet as JR
from mmqg_tpu_torch.compat.from_torchvision import (
    import_video_resnet, load_pretrained_video_resnet)
from mmqg_tpu_torch.models import video_resnet as R
from mmqg_tpu_torch.optim import tree_leaves
from tests.torch_port_fixtures import jax_resnet_f64, random_stats

torch.set_num_threads(1)
EVAL_TOL, STATE_TOL = 1e-5, 1e-6
TRUNK_BAND, TRUNK_STATE_BAND = 1e-4, 5e-6
F32_GRAD_BAND = 0.5


def build(params, state, dtype=np.float32):
    return R.build(params, state,
                   lambda a: torch.tensor(np.asarray(a, dtype)))


@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(0)
    out = {}
    for head in (None, 24):
        params, state = R.init_numpy(rng, embed_dim=head)
        out[head] = (params, random_stats(state, rng))
    clips = rng.rand(2, 17, 32, 32, 3).astype(np.float32)
    return out, clips


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, ref, tol, what):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(got) - ref).max()) / scale
    assert err <= tol, (what, err)


@pytest.mark.parametrize("head", [None, 24], ids=["trunk512", "fc24"])
def test_eval_matches_jax(nets, head):
    (params, state), clips = nets[0][head], nets[1]
    m = build(params, state)
    x = torch.from_numpy(clips)
    ref, ref_state = JR.apply(_jax(params), _jax(state), jnp.asarray(clips),
                              dtype=jnp.float32)
    got, got_state = m(x, dtype=torch.float32)
    assert got.shape == (2, 512 if head is None else head)
    _close(got.numpy(), ref, EVAL_TOL, "apply")
    ref_t, _ = JR.apply_temporal(_jax(params), _jax(state),
                                 jnp.asarray(clips), dtype=jnp.float32)
    got_t, _ = m.temporal(x, dtype=torch.float32)
    assert got_t.shape == (2, R.temporal_out_len(17), 512 if head is None
                           else head)
    _close(got_t.numpy(), ref_t, EVAL_TOL, "apply_temporal")
    # eval returns the running statistics as they are
    for a, b in zip(jax.tree.leaves(ref_state), tree_leaves(got_state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_train_layer_by_layer_matches_jax(nets):
    """The stem and each block in train mode, fed the JAX package's input
    to it: outputs and new batchnorm states."""
    (params, state), clips = nets[0][None], nets[1]
    m = build(params, state)
    P, S = _jax(params), _jax(state)
    x = jnp.asarray(clips)
    y = JR._conv3d(P["stem_s"], x, (1, 2, 2), dtype=jnp.float32)
    y, s1 = JL.batchnorm(P["stem_bn"], S["stem_bn"], y, train=True)
    y = JR._conv3d(P["stem_t"], jax.nn.relu(y), (1, 1, 1), dtype=jnp.float32)
    y, s2 = JL.batchnorm(P["stem_bn2"], S["stem_bn2"], y, train=True)
    y = jax.nn.relu(y)
    g = m.stem_s(torch.from_numpy(clips), (1, 2, 2), torch.float32)
    g, t1 = m.stem_bn.train_forward_all(g)
    g = m.stem_t(torch.relu(g), (1, 1, 1), torch.float32)
    g, t2 = m.stem_bn2.train_forward_all(g)
    _close(torch.relu(g).numpy(), y, EVAL_TOL, "stem")
    for a, b in zip(jax.tree.leaves([s1, s2]), tree_leaves([t1, t2])):
        _close(b.numpy(), a, STATE_TOL, "stem state")
    x = y
    for si, blocks in enumerate(m.stages):
        for bi, block in enumerate(blocks):
            stride = (2, 2, 2) if (bi == 0 and si > 0) else (1, 1, 1)
            y, ys = JR._block(P["stages"][si][bi], S["stages"][si][bi], x,
                              stride, train=True, dtype=jnp.float32)
            g, gs = block(torch.tensor(np.asarray(x)), stride, train=True,
                          dtype=torch.float32)
            _close(g.numpy(), y, EVAL_TOL, f"block {si}.{bi}")
            leaves = jax.tree.leaves(ys)
            assert len(leaves) == len(tree_leaves(gs))
            for a, b in zip(leaves, tree_leaves(gs)):
                _close(b.numpy(), a, STATE_TOL, f"block {si}.{bi} state")
            x = y


def test_train_trunk_against_float64(nets):
    """The whole trunk in train mode: both packages' f32 results against
    the port's float64 run (see the module docstring for the band)."""
    (params, state), clips = nets[0][None], nets[1]
    ref, ref_state = JR.apply_temporal(_jax(params), _jax(state),
                                       jnp.asarray(clips), train=True,
                                       dtype=jnp.float32)
    got, got_state = build(params, state).temporal(
        torch.from_numpy(clips), train=True, dtype=torch.float32)
    exact, exact_state = build(params, state, np.float64).temporal(
        torch.from_numpy(clips).double(), train=True, dtype=torch.float64)
    exact = exact.numpy()
    scale = float(np.abs(exact).max())
    for name, out in (("port", got.numpy()), ("jax", np.asarray(ref))):
        err = float(np.abs(out - exact).max()) / scale
        assert err <= TRUNK_BAND, (name, err)
    exact_leaves = [t.numpy() for t in tree_leaves(exact_state)]
    for name, leaves in (("port", [t.numpy() for t in
                                   tree_leaves(got_state)]),
                         ("jax", [np.asarray(a) for a in
                                  jax.tree.leaves(ref_state)])):
        assert len(leaves) == len(exact_leaves)
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(leaves, exact_leaves))
        assert err <= TRUNK_STATE_BAND, (name, err)


@pytest.mark.parametrize("T", [1, 7, 8, 9, 101])
def test_temporal_out_len_is_the_trunks_length(T):
    """ceil(T / 8), from both packages' formula, is what the port's trunk
    (cuDNN convs padded k // 2, stride 2 in time three times) gives."""
    assert R.temporal_out_len(T) == JR.temporal_out_len(T) == -(-T // 8)
    assert torch.equal(R.temporal_out_len(torch.tensor([T])),
                       torch.tensor([-(-T // 8)]))
    params, state = R.init_numpy(np.random.RandomState(1))
    m = build(params, state)
    feats, _ = m.temporal(torch.zeros((1, T, 8, 8, 3)), dtype=torch.float32)
    assert feats.shape == (1, -(-T // 8), 512)


def test_train_state_counts_and_buffers(nets):
    """Train mode returns the new states (count + 1) in the JAX state's
    tree and leaves the buffers as they were."""
    (params, state), clips = nets[0][None], nets[1]
    m = build(params, state)
    before = [t.clone() for t in tree_leaves(
        {"x": [bn.state() for bn in tree_leaves(m.bn_tree())]})]
    _, new = m(torch.from_numpy(clips[:, :9, :16, :16]), train=True,
               dtype=torch.float32)
    after = tree_leaves({"x": [bn.state() for bn in tree_leaves(m.bn_tree())]})
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, state)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, _np(new)))
    assert all(float(n["count"]) == 1.0 for n in _bn_states(new))


def _np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


def _bn_states(tree):
    if isinstance(tree, dict) and "count" in tree:
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _bn_states(tree[k])]
    if isinstance(tree, list):
        return [s for v in tree for s in _bn_states(v)]
    return []


# ------------------------------------------------ torchvision's layout

def _torch_r2plus1d_18(num_classes=400):
    """A live torch r2plus1d_18 with torchvision's module nesting and
    state_dict keys (torchvision's models/video/resnet.py, restated from
    the published architecture: torchvision is not a dependency)."""
    def midplanes(cin, cout):
        return (cin * cout * 3 * 3 * 3) // (cin * 3 * 3 + 3 * cout)

    def conv2plus1d(cin, cout, mid, stride=1):
        return nn.Sequential(
            nn.Conv3d(cin, mid, (1, 3, 3), stride=(1, stride, stride),
                      padding=(0, 1, 1), bias=False),
            nn.BatchNorm3d(mid), nn.ReLU(True),
            nn.Conv3d(mid, cout, (3, 1, 1), stride=(stride, 1, 1),
                      padding=(1, 0, 0), bias=False))

    class Block(nn.Module):
        def __init__(self, cin, cout, stride=1):
            super().__init__()
            self.conv1 = nn.Sequential(
                conv2plus1d(cin, cout, midplanes(cin, cout), stride),
                nn.BatchNorm3d(cout), nn.ReLU(True))
            self.conv2 = nn.Sequential(
                conv2plus1d(cout, cout, midplanes(cout, cout)),
                nn.BatchNorm3d(cout))
            self.downsample = None
            if stride != 1 or cin != cout:
                self.downsample = nn.Sequential(
                    nn.Conv3d(cin, cout, 1, stride=stride, bias=False),
                    nn.BatchNorm3d(cout))
            self.relu = nn.ReLU(True)

        def forward(self, x):
            out = self.conv2(self.conv1(x))
            identity = self.downsample(x) if self.downsample else x
            return self.relu(out + identity)

    class R2Plus1D18(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv3d(3, 45, (1, 7, 7), stride=(1, 2, 2),
                          padding=(0, 3, 3), bias=False),
                nn.BatchNorm3d(45), nn.ReLU(True),
                nn.Conv3d(45, 64, (3, 1, 1), padding=(1, 0, 0), bias=False),
                nn.BatchNorm3d(64), nn.ReLU(True))
            self.layer1 = nn.Sequential(Block(64, 64), Block(64, 64))
            self.layer2 = nn.Sequential(Block(64, 128, 2), Block(128, 128))
            self.layer3 = nn.Sequential(Block(128, 256, 2), Block(256, 256))
            self.layer4 = nn.Sequential(Block(256, 512, 2), Block(512, 512))
            self.fc = nn.Linear(512, num_classes)

        def forward(self, x):                  # (N, 3, T, H, W)
            x = self.stem(x)
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
            return self.fc(x.mean(dim=(2, 3, 4)))

    torch.manual_seed(0)
    m = R2Plus1D18().eval()
    with torch.no_grad():                      # non-trivial running stats
        for mod in m.modules():
            if isinstance(mod, nn.BatchNorm3d):
                mod.running_mean.uniform_(-0.1, 0.1)
                mod.running_var.uniform_(0.9, 1.1)
    return m


def test_torchvision_import_reproduces_the_torch_forward():
    """A torchvision-layout state_dict imported and run by the port gives
    the torch module's output (fc head kept) and its pooled features (head
    dropped); the trees equal the JAX package's importer's."""
    from mmqg_tpu.compat.torch_import import \
        import_video_resnet as jax_import

    m = _torch_r2plus1d_18()
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    params, state = import_video_resnet(sd, embed_dim=400)
    ref_p, ref_s = jax_import(sd, embed_dim=400)
    for a, b in zip(jax.tree.leaves(ref_p), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    for a, b in zip(jax.tree.leaves(ref_s), tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    clips = np.random.RandomState(3).rand(2, 4, 32, 32, 3).astype(np.float32)
    got, _ = build(params, state)(torch.from_numpy(clips),
                                  dtype=torch.float32)
    with torch.no_grad():
        ref = m(torch.tensor(clips).permute(0, 4, 1, 2, 3)).numpy()
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4)
    params, state = import_video_resnet(sd)
    feats, _ = build(params, state)(torch.from_numpy(clips),
                                    dtype=torch.float32)
    assert feats.shape == (2, 512) and "fc" not in params


def test_load_pretrained_checks_the_head():
    """Into a whole model's trees: video_enc replaced, the rest the same
    objects; a head of another width, or none, raises ValueError."""
    m = _torch_r2plus1d_18(num_classes=24)
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    rng = np.random.RandomState(2)
    vp, vs = R.init_numpy(rng, embed_dim=24)
    params = {"video_enc": vp, "text_enc": {"lstm": {}}, "decoder": {}}
    state = {"video_enc": vs}
    new_p, new_s = load_pretrained_video_resnet(params, state, sd)
    want_p, want_s = import_video_resnet(sd, embed_dim=24)
    for a, b in zip(tree_leaves(new_p["video_enc"]), tree_leaves(want_p)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(new_s["video_enc"]), tree_leaves(want_s)):
        np.testing.assert_array_equal(a, b)
    assert new_p["text_enc"] is params["text_enc"]
    assert new_p["decoder"] is params["decoder"]
    sd400 = {k: v.numpy() for k, v in _torch_r2plus1d_18().state_dict()
             .items()}
    with pytest.raises(ValueError, match="24-wide"):
        load_pretrained_video_resnet(params, state, sd400)
    with pytest.raises(ValueError, match="no fc"):
        load_pretrained_video_resnet(
            params, state, {k: v for k, v in sd400.items()
                            if not k.startswith("fc.")})
    # a 512-wide model imports the trunk alone
    vp512, vs512 = R.init_numpy(rng)
    p512, _ = load_pretrained_video_resnet({"video_enc": vp512},
                                           {"video_enc": vs512}, sd400)
    assert "fc" not in p512["video_enc"]


def _grads_port(params, state, clips, ct, npdt, dtype):
    m = build(params, state, npdt)
    m.requires_grad_(True)
    y, _ = m.temporal(torch.from_numpy(clips).to(dtype), train=True,
                      dtype=dtype)
    (y * torch.from_numpy(ct).to(dtype)).sum().backward()
    return [p.grad.double().numpy() for p in tree_leaves(m.param_tree())]


def _grads_jax(params, state, clips, ct, dtype):
    def f(p):
        y, _ = JR.apply_temporal(p, jax.tree.map(lambda a: jnp.asarray(
            a, dtype), state), jnp.asarray(clips, dtype), train=True,
            dtype=dtype)
        return (y * jnp.asarray(ct, dtype)).sum()
    g = jax.jit(jax.grad(f))(jax.tree.map(lambda a: jnp.asarray(a, dtype),
                                          params))
    return [np.asarray(a, np.float64) for a in jax.tree.leaves(g)]


def test_train_gradients_match_jax_in_float64(nets):
    """The trunk's train-mode gradients (of features . a random
    cotangent), with the fc head: in float64 the two packages agree within
    1e-6 of each leaf's max. In f32 both sit up to ~0.3 of a leaf's max
    from the float64 result at this size (17 frames of 32 px, batch 2):
    batchnorm's backward over stage 4's 24 positions a channel cancels
    nearly equal terms. The f32 gradients are held to a band of 0.5, an
    O(1) backstop; the float64 agreement is the parity check."""
    (params, state), clips = nets[0][24], nets[1]
    ct = np.random.RandomState(7).randn(2, 3, 24).astype(np.float32)
    exact = _grads_port(params, state, clips, ct, np.float64, torch.float64)
    with jax_resnet_f64():
        ref64 = _grads_jax(params, state, clips, ct, jnp.float64)
    assert len(exact) == len(ref64) == len(tree_leaves(params))
    for a, b in zip(exact, ref64):
        assert float(np.abs(a - b).max()) <= 1e-6 * float(np.abs(b).max())
    for got in (_grads_port(params, state, clips, ct, np.float32,
                            torch.float32),
                _grads_jax(params, state, clips, ct, jnp.float32)):
        for a, b in zip(got, exact):
            assert float(np.abs(a - b).max()) <= F32_GRAD_BAND * float(
                np.abs(b).max())
