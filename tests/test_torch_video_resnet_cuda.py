"""R(2+1)D-18's inference trunk on the card (``mmqg_tpu_torch/models/
video_resnet.py``): at torchvision's widths every conv runs on cuDNN's
bf16 tensor-core kernels, with no f32 fallback and no layout transform
around one, and the trunk gives the result of its convs at the published
widths; between the convs run 34 launches of the batchnorm epilogue
kernel and none of PyTorch's eval chain, and the trunk's output is that
chain's bit for bit, in bf16 and in float32; the kernel refuses to run
under autograd. Every test needs an NVIDIA GPU and skips without one.
The file imports no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_video_resnet_cuda.py
"""

import numpy as np
import pytest
import torch

from mmqg_tpu_torch.models import video_resnet as R
from mmqg_tpu_torch.ops import bn_epilogue as E

pytestmark = pytest.mark.cuda

# 112 px frames: stage 1 at 56 x 56, where cuDNN runs the (3, 1, 1) convs
# to 64 channels as 3-D convs on its f32 kernel
CLIPS = (8, 32, 112, 112, 3)
# two bf16 steps of the output's max (the CPU tests' band)
BF16_TOL = 2.0 ** -7
FALLBACK = ("f32f32_f32f32", "nhwcToNchwKernel", "nchwToNhwcKernel")


@pytest.fixture(scope="module")
def trunk():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    params, state = R.init_numpy(np.random.RandomState(0))
    model = R.build(params, state, lambda a: torch.tensor(a, device="cuda"))
    clips = torch.rand(CLIPS, generator=torch.Generator().manual_seed(1)
                       ).cuda()
    return model, clips


def test_a_bf16_inference_trunk_launches_no_f32_conv(trunk):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, clips = trunk
    with torch.no_grad():
        model.temporal(clips)              # cuDNN's plans, the weights
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.temporal(clips)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    convs = [n for n in names if "fprop" in n or "convolve" in n]
    assert len(convs) >= 37, names
    assert all("bf16" in n or "bfloat16" in n for n in convs), convs
    assert not [n for n in names if any(f in n for f in FALLBACK)]


def test_the_inference_trunk_gives_the_unpadded_result(trunk,
                                                      monkeypatch):
    """Against the same trunk with every conv at its published widths
    (padding to a multiple of 1 pads nothing), its epilogues in PyTorch's
    operations (the kernel takes channels in multiples of 8)."""
    model, clips = trunk
    with torch.no_grad():
        got, _ = model.temporal(clips)
        monkeypatch.setattr(R, "_up8", lambda c: c)
        monkeypatch.setattr(E, "bn_epilogue", E.bn_epilogue_plain)
        want, _ = model.temporal(clips)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= BF16_TOL, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "float32"])
def test_the_fused_trunk_is_the_eval_chain_bit_for_bit(trunk, monkeypatch,
                                                       dtype):
    """Against the same trunk with the epilogue op's plain path, PyTorch's
    operations, on the same card tensors."""
    model, clips = trunk
    op = E.bn_epilogue
    monkeypatch.setattr(op, "launches", 0)
    with torch.no_grad():
        got, _ = model.temporal(clips, dtype=dtype)
        assert op.launches == 34
        monkeypatch.setattr(E, "bn_epilogue", E.bn_epilogue_plain)
        want, _ = model.temporal(clips, dtype=dtype)
    assert op.launches == 34
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_an_inference_trunk_under_autograd_raises(trunk):
    """The kernel has no backward: parameters that need a gradient, with
    autograd on, stop the trunk at its first epilogue."""
    model, clips = trunk
    model.requires_grad_(True)
    try:
        with pytest.raises(ValueError, match="no backward"):
            model.temporal(clips)
    finally:
        model.requires_grad_(False)


# PyTorch's eval chain, none of which may touch an activation between the
# trunk's first conv and its pooling
# (a cast is ``aten::_to_copy``; ``aten::to`` of a tensor already in the
# dtype copies nothing)
CHAIN = ("aten::addcmul", "aten::relu", "aten::relu_", "aten::clamp_min",
         "aten::clamp_min_", "aten::add", "aten::add_", "aten::_to_copy",
         "aten::copy_")


def _profile(model, clips):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        model.temporal(clips)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            model.temporal(clips)
            torch.cuda.synchronize()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    kernels = [e.name for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    first_conv = next(e.time_range.start for e in ops
                      if e.name in ("aten::conv2d", "aten::conv3d"))
    # an activation: (B, T, H, W, C); weights and scales have other leads
    chain = [(e.name, s) for e in ops if e.name in CHAIN
             and e.time_range.start > first_conv
             for s in e.input_shapes
             if len(s) == 5 and s[0] == clips.shape[0]]
    return kernels, chain


def test_a_profiled_trunk_launches_34_epilogues_and_no_eval_chain(
        trunk, monkeypatch):
    model, clips = trunk
    kernels, chain = _profile(model, clips)
    assert sum("bn_epilogue_kernel" in n for n in kernels) == 34, kernels
    assert chain == []
    # the check sees the chain where it runs
    monkeypatch.setattr(E, "bn_epilogue", E.bn_epilogue_plain)
    kernels, chain = _profile(model, clips)
    assert not any("bn_epilogue_kernel" in n for n in kernels)
    assert {name for name, _ in chain} >= {"aten::addcmul", "aten::add",
                                           "aten::_to_copy"}
