"""On the card, at each cell's own size: the program's own run passes
every limit the cell's numbers have, and the control (the fp8 reference
put in the program's place) fails at least one. Run on the card with

    python3 -m pytest -q -m cuda portbench/tests/test_portbench_control_cuda.py
"""

import json

import pytest
import torch

from portbench import control
from portbench.tests.conftest import PKG

CELLS = ["trimodal_attn.serve_bulk", "trimodal_attn.train",
         "text_video_nonattn.serve_bulk"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU "
                    "mode")
    limits = json.loads((PKG / "workloads" / f"{cell}.json").read_text())[
        "limits"]
    r = control.readings(cell, 2**31 + 101, 3.0, True)
    assert all(r[k] <= v for k, v in limits.items())
    assert any(r[f"control_{k}"] > v for k, v in limits.items()
               if f"control_{k}" in r)
