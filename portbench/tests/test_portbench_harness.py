"""The harness: the whole-name import check, a cell and a metric added by
files alone, ``BENCHMARK.json`` against the files it names, and a
planted fault that the judge must catch."""

import json
import re
import subprocess
import sys

import pytest
import torch

from portbench import run as R
from portbench.tests.conftest import PKG, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert R.forbidden_modules() == []
    fake = type(sys)("fake")
    monkeypatch.setitem(sys.modules, "mmqg_tpu_torch_extra", fake)
    monkeypatch.setitem(sys.modules, "jaxlibrary", fake)
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", fake)
    monkeypatch.setitem(sys.modules, "mmqg_tpu.pipeline", fake)
    assert R.forbidden_modules() == ["jax", "mmqg_tpu"]


def test_the_harness_loads_nothing_of_jax():
    code = ("import sys; from pathlib import Path; "
            "from portbench import run as R, judge, control; "
            "import mmqg_tpu_torch.pipeline, mmqg_tpu_torch.train; "
            "[R.load_module(p) for d in ('traffic', 'metrics') "
            " for p in sorted((R.HERE / d).glob('*.py'))]; "
            "print(R.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_result_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run
    fails and prints no result line."""
    import shutil
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run",
                          "--workload", "trimodal_attn.serve_bulk", "--seed",
                          "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, text=True, capture_output=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_json_matches_its_files(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    cat = R.catalog()
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["name"] in cat["configs"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["name"] in cat["workloads"]
        f = json.loads((PKG / "workloads" / f"{w['name']}.json").read_text())
        assert {k: f[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert w["traffic"] in cat["mixes"]
        e2e = R.metric_names(bench, w["name"], "end_to_end", set())
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert R.metric_names(bench, w["name"], "per_layer", names)
    for m in bench["end_to_end"]:
        assert NAME.match(m["name"]) and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] in cat["metrics"]
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        if m["unit"] == "%":
            assert ("roofline" in m["name"] or "mfu" in m["name"]
                    or "idle" in m["name"])


def test_a_cell_and_a_metric_are_added_by_files_alone(tiny_root, bench,
                                                      tmp_path):
    (tiny_root / "mixes" / "bulk_tiny.json").write_text(json.dumps(dict(
        json.loads((tiny_root / "mixes" / "bulk_b32.json").read_text()),
        batches=1)))
    (tiny_root / "workloads" / "trimodal_attn.bulk_tiny.json").write_text(
        json.dumps({"config": "trimodal_attn", "traffic": "bulk_tiny",
                    "chips": 1, "why": "a test cell", "limits": {
                        "logit_gap": 1.0, "unservable": 0}}))
    (tiny_root / "metrics" / "rows.test.py").write_text(
        "def read(ctx):\n"
        "    calls = ctx.get('calls')\n"
        "    return float(sum(c['rows'] for c in calls)) if calls else None\n")
    b = json.loads(json.dumps(bench))
    cell = "trimodal_attn.bulk_tiny"
    b["workloads"].append({"name": cell, "config": "trimodal_attn",
                           "traffic": "bulk_tiny", "chips": 1,
                           "why": "a test cell"})
    b["end_to_end"][0]["workloads"].append(cell)
    b["per_layer"].append({"name": "rows.test", "unit": "rows",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "questions_per_s",
                           "workloads": [cell]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(b))
    cat = R.catalog(tiny_root)
    assert cell in cat["workloads"] and "rows.test" in cat["metrics"]
    out = R.run_cell(cell, 5, 0.5, True, device="cpu", root=tiny_root,
                     bench_path=path)
    assert out["correct"] is True
    assert out["metrics"]["rows.test"]["value"] == 4.0
    out = R.run_cell(cell, 5, 0.5, False, device="cpu", root=tiny_root,
                     bench_path=path)
    assert set(out["metrics"]) == {"questions_per_s", "setup_s"}


@pytest.mark.parametrize("cell", ["trimodal_attn.serve_bulk",
                                  "text_video_nonattn.serve_bulk"])
def test_sound_runs_are_correct(cell, tiny_root, bench, tmp_path):
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    out = R.run_cell(cell, 2**31 + 9, 0.5, False, device="cpu",
                     root=tiny_root, bench_path=path)
    assert out["correct"] is True, out["checks"]
    gaps = [c["value"] for k, c in out["checks"].items()
            if k.startswith("logit_gap")]
    assert gaps and max(gaps) < 0.05


@pytest.mark.parametrize("cell", ["trimodal_attn.serve_bulk",
                                  "text_video_nonattn.serve_bulk"])
def test_an_altered_token_is_not_correct(cell, tiny_root, bench, tmp_path,
                                         monkeypatch):
    from mmqg_tpu_torch import decode as DEC
    orig = DEC._select_token
    calls = {"n": 0}

    def select(strategy, logits, noise, k, p=0.9):
        # every third step, the model's last choice in place of its first
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            return torch.argmin(logits, dim=-1)
        return orig(strategy, logits, noise, k, p)
    monkeypatch.setattr(DEC, "_select_token", select)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    out = R.run_cell(cell, 2**31 + 9, 0.5, False, device="cpu",
                     root=tiny_root, bench_path=path)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for k, c in out["checks"].items()
               if k.startswith("logit_gap"))


def _tiny_train_mix(tiny_root):
    p = tiny_root / "mixes" / "train_b32.json"
    mix = json.loads(p.read_text())
    mix.update(batch=4, batches=3, words=[3, 20], question_words=[1, 4],
               frames=[2, 12], audio_s=[1, 2])
    p.write_text(json.dumps(mix))


def test_a_sound_training_run_is_correct(tiny_root, bench, tmp_path):
    _tiny_train_mix(tiny_root)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    out = R.run_cell("trimodal_attn.train", 2**31 + 3, 0.5, False,
                     device="cpu", root=tiny_root, bench_path=path)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_training_fault_is_not_correct(fault, tiny_root, bench, tmp_path,
                                         monkeypatch):
    """A step that leaves the state as it was, or one that leaves half of
    the batch out and takes the mean over the rest, reads not correct."""
    from mmqg_tpu_torch import train as TR
    from mmqg_tpu_torch.models import qg_model

    if fault == "state_unchanged":
        monkeypatch.setattr(TR, "apply_updates", lambda params, updates: None)
    else:
        loss_fn = qg_model.loss_fn

        def half(model, mc, batch, **kw):
            valid = batch["valid"].clone()
            valid[valid.shape[0] // 2:] = False
            return loss_fn(model, mc, dict(batch, valid=valid), **kw)
        monkeypatch.setattr(qg_model, "loss_fn", half)
    _tiny_train_mix(tiny_root)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    out = R.run_cell("trimodal_attn.train", 2**31 + 3, 0.5, False,
                     device="cpu", root=tiny_root, bench_path=path)
    assert out["correct"] is False, out["checks"]


def test_logit_gap_per_near_tie():
    from portbench import judge

    gaps = [torch.tensor([0.0, 0.1, 0.0]), torch.tensor([0.2])]
    s = judge._summary(gaps, 3)
    assert s["logit_gap"] == pytest.approx(0.2)
    assert s["logit_gap_mean"] == pytest.approx(0.075)
    assert s["logit_gap_per_tie"] == pytest.approx(0.1)
    # no near tie: the sum over one
    assert judge._summary(gaps, 0)["logit_gap_per_tie"] == pytest.approx(0.3)
    assert judge._summary([], 4) == {}
