"""The batchnorm epilogue's plain path (``mmqg_tpu_torch/ops/
bn_epilogue.py``) against the eval chain it replaces in R(2+1)D-18's
inference trunk -- the conv output cast up, ``layers.affine`` with
``BatchNorm.eval_scale_shift``'s scale and shift, the shortcut add, the
ReLU, the next conv's cast -- bit for bit in float32, bfloat16 and float64,
and ``bn_epilogue`` on CPU tensors running that plain path. The kernel
itself is checked on the card (``test_torch_bn_epilogue_cuda.py``)."""

import pytest
import torch

from mmqg_tpu_torch.models import layers as L
from mmqg_tpu_torch.ops import bn_epilogue as E

torch.set_num_threads(1)

# (B, T, H, W): a small conv output
SHAPE = (2, 3, 5, 7)


def _bn(C: int, g: torch.Generator) -> L.BatchNorm:
    return L.BatchNorm(torch.randn(C, generator=g), torch.randn(C, generator=g),
                       torch.randn(C, generator=g),
                       torch.rand(C, generator=g) + 0.5)


def _conv_output(C: int, published: int, dtype, g) -> torch.Tensor:
    """A conv output in ``dtype``, 0 past the ``published`` channels (a
    conv padded to a multiple of 8)."""
    x = torch.randn(*SHAPE, C, generator=g, dtype=torch.float64)
    x[..., published:] = 0
    return x.to(dtype)


def _eval(bn: L.BatchNorm, x: torch.Tensor, relu: bool = False
          ) -> torch.Tensor:
    """Eval batchnorm of ``x`` in float32 (float64 for float64 ``x``) as
    the trunk ran it before the epilogue op."""
    return L.affine(L._f32_up(x), *bn.eval_scale_shift(x.shape[-1]), relu)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, so -0.0 and 0.0 differ."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()])


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("residual", ["none", "identity", "down"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64],
                         ids=["float32", "bfloat16", "float64"])
def test_the_plain_epilogue_is_the_eval_chain(dtype, residual, relu):
    g = torch.Generator().manual_seed(7)
    # the stem's 45 channels padded to 48; a block's 64
    C, published = (48, 45) if residual == "none" else (64, 64)
    bn = _bn(published, g)
    x = _conv_output(C, published, dtype, g)
    full = torch.promote_types(dtype, torch.float32)
    kw = {}
    if residual == "none":
        want = _eval(bn, x, relu)
    else:
        if residual == "identity":
            sc = torch.randn(*SHAPE, C, generator=g, dtype=full)
            kw = {"residual": sc}
        else:
            down_bn = _bn(C, g)
            d = _conv_output(C, C, dtype, g)
            sc = _eval(down_bn, d)
            kw = {"residual": d, "res_a": down_bn.eval_scale_shift(C)[0],
                  "res_b": down_bn.eval_scale_shift(C)[1]}
        want = _eval(bn, x) + sc
        if relu:
            want = torch.relu(want)
    a, b = bn.eval_scale_shift(C)
    for op in (E.bn_epilogue_plain, E.bn_epilogue):
        low, kept = op(x, a, b, relu=relu, cast=dtype, keep=True, **kw)
        assert low.dtype == dtype and kept.dtype == full
        assert torch.equal(_bits(kept), _bits(want))
        assert torch.equal(_bits(low), _bits(want.to(dtype)))
        assert not kept[..., published:].any()
        only_low = op(x, a, b, relu=relu, cast=dtype, keep=False, **kw)
        assert only_low[1] is None
        assert torch.equal(_bits(only_low[0]), _bits(low))
        assert op(x, a, b, relu=relu, keep=True, **kw)[0] is None


def test_a_device_with_no_kernel_is_refused():
    x = torch.empty(*SHAPE, 8, dtype=torch.bfloat16, device="meta")
    a = torch.empty(8, device="meta")
    before = E.bn_epilogue.launches
    with pytest.raises(ValueError, match="no kernel for device"):
        E.bn_epilogue(x, a, a, cast=torch.bfloat16)
    assert E.bn_epilogue.launches == before
