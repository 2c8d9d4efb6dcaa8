"""R(2+1)D-18's inference trunk on the card (``mmqg_tpu_torch/models/
video_resnet.py``): at torchvision's widths every conv runs on cuDNN's
bf16 tensor-core kernels, with no f32 fallback and no layout transform
around one, and the trunk gives the result of its convs at the published
widths. Every test needs an NVIDIA GPU and skips without one. The file
imports no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_video_resnet_cuda.py
"""

import numpy as np
import pytest
import torch

from mmqg_tpu_torch.models import video_resnet as R

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
    (padding to a multiple of 1 pads nothing)."""
    model, clips = trunk
    with torch.no_grad():
        got, _ = model.temporal(clips)
        monkeypatch.setattr(R, "_up8", lambda c: c)
        want, _ = model.temporal(clips)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= BF16_TOL, err
