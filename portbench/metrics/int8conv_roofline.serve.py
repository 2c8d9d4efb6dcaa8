"""int8conv_roofline.serve: the int8 VGGish tower's kernels
(``ops/vggish.py``, ``csrc/vggish_conv.cu``: conv2..conv6 and the
quantizes feeding them) against their roofline: the launches' bound time
(operations at the 1979 TOP/s int8 peak or bytes at 3.35 TB/s) over their
device time, per cent. The tower runs on every packed row's audio-bucket
examples."""

from portbench import arith
from portbench.readers import roofline_pct

KERNELS = (r"\bvggish_conv_s8_kernel", r"\bvggish_conv_int8_kernel",
           r"\bquantize_kernel", r"\bamax_kernel")


def launches(cfg, call):
    if cfg["mode"] != "trimodal":
        return []
    return arith.vggish_int8_launches(call["rows"] * call["acap"],
                                      cfg["mel_frames"], cfg["mel_bins"])


def read(ctx):
    return roofline_pct(ctx, KERNELS, launches, "int8")
