"""The benchmark's R(2+1)D-18 cell on the CPU: the harness finds its files
by name, ``arith_r2plus1d`` counts the trunk's work as a hand count does,
the traffic driver's judge sums its clip-length groups as one reading, and a
whole run at a tiny size (every trunk width kept) is correct and reads
the cell's program metrics."""

import json
import shutil

import pytest
import torch

from portbench import arith_r2plus1d as A
from portbench import run as R
from portbench.tests.conftest import TINY, TINY_MIX, tiny_copy

torch.set_num_threads(1)
CELL = "trimodal_attn_r2plus1d.serve_bulk"
READERS = ("r2plus1d_mfu.serve", "r2plus1d_roofline.serve",
           "r2plus1d_unaligned_convs.serve", "r2plus1d_cast_mb.serve",
           "video_trunk_enqueue_ms.serve")


def test_the_catalog_finds_the_cell_and_its_files():
    cat = R.catalog()
    assert CELL in cat["workloads"]
    assert "trimodal_attn_r2plus1d" in cat["configs"]
    assert "bulk_b32_r2plus1d" in cat["mixes"]
    assert "serve_bulk_r2plus1d" in cat["traffic"]
    assert set(READERS) <= set(cat["metrics"])
    bench = json.loads((R.HERE.parent / "BENCHMARK.json").read_text())
    want = {m["name"] for m in R.metric_names(
        bench, CELL, "per_layer", {"questions_per_s"})}
    assert want == set(READERS)
    mix = json.loads((R.HERE / "mixes" / "bulk_b32_r2plus1d.json")
                     .read_text())
    base = json.loads((R.HERE / "mixes" / "bulk_b32.json").read_text())
    assert {k: v for k, v in mix.items() if k not in ("kind", "about")} == \
        {k: v for k, v in base.items() if k not in ("kind", "about")}


# the trunk over 8 frames of 16 x 16, by hand: (T, H, W) out, Cin, Cout,
# kernel taps, per stage (spatial, temporal, spatial, temporal[, down])
HAND = ([((8, 8, 8), 3, 45, 49), ((8, 8, 8), 45, 64, 3)]
        + [((8, 8, 8), 64, 144, 9), ((8, 8, 8), 144, 64, 3)] * 4
        + [((8, 4, 4), 64, 230, 9), ((4, 4, 4), 230, 128, 3),
           ((4, 4, 4), 128, 230, 9), ((4, 4, 4), 230, 128, 3),
           ((4, 4, 4), 64, 128, 1)]
        + [((4, 4, 4), 128, 288, 9), ((4, 4, 4), 288, 128, 3)] * 2
        + [((4, 2, 2), 128, 460, 9), ((2, 2, 2), 460, 256, 3),
           ((2, 2, 2), 256, 460, 9), ((2, 2, 2), 460, 256, 3),
           ((2, 2, 2), 128, 256, 1)]
        + [((2, 2, 2), 256, 576, 9), ((2, 2, 2), 576, 256, 3)] * 2
        + [((2, 1, 1), 256, 921, 9), ((1, 1, 1), 921, 512, 3),
           ((1, 1, 1), 512, 921, 9), ((1, 1, 1), 921, 512, 3),
           ((1, 1, 1), 256, 512, 1)]
        + [((1, 1, 1), 512, 1152, 9), ((1, 1, 1), 1152, 512, 3)] * 2)


def test_arith_counts_the_trunk_as_a_hand_count():
    convs = list(A.trunk_convs(8, 16))
    assert [(c["out"], c["cin"], c["cout"],
             c["k"][0] * c["k"][1] * c["k"][2]) for c in convs] == HAND
    macs = sum(t * h * w * ci * co * k for (t, h, w), ci, co, k in HAND)
    assert A.trunk_flops(8, 16) == 2.0 * macs
    # the published clip: 257.6 G multiply-adds over 101 frames at 112
    assert sum(A.conv_macs(c) for c in A.trunk_convs(101)) == 257605650624
    launches = list(A.trunk_launches(2, 8, 16))
    assert len(launches) == 37
    assert sum(x["ops"] for x in launches) == 2 * A.trunk_flops(8, 16)
    stem = launches[0]
    assert stem["bytes"] == 2 * (2 * 8 * 16 * 16 * 3 + 49 * 3 * 45
                                 + 2 * 8 * 8 * 8 * 45)


def test_request_flops_attends_over_the_memory_steps():
    """17 and 24 frames make 3 memory steps each: beyond the trunk, a
    request costs the same."""
    cfg = json.loads((R.HERE / "configs" / "trimodal_attn_r2plus1d.json")
                     .read_text())
    f = {n: A.request_flops(cfg, 100, n, 5, 21) - A.trunk_flops(n)
         for n in (17, 24, 25)}
    assert f[17] == f[24] < f[25]


def test_the_judge_sums_its_groups_as_one_reading():
    drv = R.load_module(R.HERE / "traffic" / "serve_bulk_r2plus1d.py")
    nothing = drv.judge.NOTHING
    parts = [{"logit_gap": 0.5, "logit_gap_mean": 0.06,
              "logit_gap_per_tie": 0.3, "tokens": 10, "near_ties": 2,
              "unservable": 0, "control_logit_gap": 2.0,
              "control_logit_gap_mean": 0.2,
              "control_logit_gap_per_tie": 1.0},
             {"logit_gap": 0.1, "logit_gap_mean": 0.02,
              "logit_gap_per_tie": 0.1, "tokens": 5, "near_ties": 0,
              "unservable": 1, "control_logit_gap": 0.5,
              "control_logit_gap_mean": 0.1,
              "control_logit_gap_per_tie": 0.5},
             {"logit_gap": nothing, "logit_gap_mean": nothing,
              "logit_gap_per_tie": nothing, "tokens": 0, "near_ties": 0,
              "unservable": 2}]
    out = drv.merged(parts)
    assert out["tokens"] == 15 and out["near_ties"] == 2
    assert out["unservable"] == 3
    assert out["logit_gap"] == 0.5
    assert out["logit_gap_per_tie"] == pytest.approx((0.6 + 0.1) / 2)
    assert out["logit_gap_mean"] == pytest.approx(0.7 / 15)
    assert out["control_logit_gap"] == 2.0
    assert out["control_logit_gap_per_tie"] == pytest.approx(2.5 / 2)
    assert drv.merged(parts[2:])["logit_gap_per_tie"] == nothing


def test_the_reading_compared_is_the_loss_over_the_fp8_references():
    """``logit_gap_vs_fp8``: the served tokens' summed gaps over the fp8
    reference's at the same positions (the per-tie sums share their near
    ties); the control reads 1; nothing to calibrate or judge fails."""
    drv = R.load_module(R.HERE / "traffic" / "serve_bulk_r2plus1d.py")
    nothing = drv.judge.NOTHING
    r = {"logit_gap_per_tie": 0.01, "control_logit_gap_per_tie": 0.2}
    assert drv.vs_fp8(r) == pytest.approx(0.05)
    assert drv.vs_fp8(r, "control_") == 1.0
    assert drv.vs_fp8(dict(r, control_logit_gap_per_tie=0.0)) == nothing
    assert drv.vs_fp8({"logit_gap_per_tie": 0.0,
                       "control_logit_gap_per_tie": 0.0}) == 0.0
    assert drv.vs_fp8({"logit_gap_per_tie": nothing}) == nothing
    assert drv.vs_fp8({"logit_gap_per_tie": 0.01}) == nothing
    limits = json.loads((R.HERE / "workloads" / f"{CELL}.json")
                        .read_text())["limits"]
    assert limits["logit_gap_vs_fp8"] < drv.vs_fp8(r, "control_")


def test_a_tiny_run_is_correct_and_reads_the_program(tmp_path, monkeypatch):
    from mmqg_tpu_torch.models import video_resnet

    # The counters are the process's; a benchmark run is a process of its
    # own, so start them at zero as it does, whatever trunks ran before.
    monkeypatch.setattr(video_resnet, "convs",
                        {"trunks": 0, "aligned": 0, "unaligned": 0,
                         "padded": 0})
    monkeypatch.setattr(video_resnet, "weight_casts",
                        {"calls": 0, "bytes": 0})
    root = tiny_copy(tmp_path / "portbench")
    cfg_path = root / "configs" / "trimodal_attn_r2plus1d.json"
    cfg = json.loads(cfg_path.read_text())
    assert all(cfg[k] == v for k, v in TINY.items())
    cfg["video_hidden_dim"] = 512         # the trunk's width, no head
    cfg_path.write_text(json.dumps(cfg))
    mix_path = root / "mixes" / "bulk_b32_r2plus1d.json"
    mix_path.write_text(json.dumps(dict(json.loads(mix_path.read_text()),
                                        **TINY_MIX["bulk_b32"])))
    out = R.run_cell(CELL, 2**33 + 17, 0.3, True, device="cpu", root=root,
                     bench_path=R.HERE.parent / "BENCHMARK.json")
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == {"logit_gap_vs_fp8", "unservable"}
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert got["r2plus1d_unaligned_convs.serve"] == 0
    assert 0 < got["r2plus1d_mfu.serve"] and 0 < got[
        "video_trunk_enqueue_ms.serve"]
    assert "r2plus1d_roofline.serve" not in got    # no device kernels here
    shutil.rmtree(root)
