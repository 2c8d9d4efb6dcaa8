"""``mmqg_tpu_torch.evaluate`` vs ``mmqg_tpu.evaluate`` on the tiny corpus,
from one checkpoint written by the JAX package: both CLIs, at their default
(bf16) compute, write the same predictions JSON and print the same BLEU for
``-s beam`` and ``-s sampling`` (exact equality: the same tokens)."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmqg_tpu import checkpoint as JC
from mmqg_tpu import evaluate as JE
from mmqg_tpu import train as JT
from mmqg_tpu_torch import evaluate as E
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.data.dataset import QGDataset
from mmqg_tpu_torch.models import qg_model as TQ
from tests.torch_port_fixtures import peaked, tiny_model

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def setup(tiny_config, tiny_corpus, tmp_path_factory):
    """A config whose outputs go to a fresh directory, and a JAX-written
    ``best`` checkpoint of a tiny model with a peaked decoder."""
    out = tmp_path_factory.mktemp("evaluate")
    cfg = tiny_config.replace(output_path=out / "results")
    cfg.ensure_dirs()
    path = out / "config.json"
    cfg.save(path)
    ds = QGDataset(cfg, cfg.test_file)
    mc, params, state = tiny_model(cfg, n_vocab=len(ds.vocab), seed=8)
    params = peaked(params, end_twin=5)
    ts = {"params": params, "model_state": state,
          "opt_state": JT.make_optimizer(cfg).init(params),
          "step": np.zeros((), np.int32)}
    JC.save_checkpoint(cfg.checkpoint_dir, "best",
                       jax.tree.map(np.asarray, ts))
    return cfg, path, mc, params, state


@pytest.mark.parametrize("strategy", ["beam", "sampling"])
def test_cli_writes_the_jax_predictions_and_bleu(setup, strategy, capsys):
    cfg, path, *_ = setup
    out = cfg.output_path / f"best_predictions_{strategy}.json"
    ref_bleu = JE.main(["-c", str(path), "-s", strategy, "--best"])
    ref_printed = capsys.readouterr().out
    ref = json.loads(out.read_text())
    out.unlink()
    bleu = E.main(["-c", str(path), "-s", strategy, "--best",
                   "--device", "cpu"])
    assert capsys.readouterr().out == ref_printed
    got = json.loads(out.read_text())
    assert got == ref
    assert bleu == ref_bleu and all(np.isfinite(v) for v in bleu.values())
    assert len(got) > 0 and set(got[0]) == {"question_id", "gt_question",
                                            "pred_question"}
    assert any(p["pred_question"] for p in got)


def test_module_runs_as_a_script(setup):
    cfg, path, *_ = setup
    proc = subprocess.run(
        [sys.executable, "-m", "mmqg_tpu_torch.evaluate", "-c", str(path),
         "-s", "topk", "--top-k", "3", "--best", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "best_predictions_topk.json" in proc.stdout
    assert "Val_bleu - " in proc.stdout
    assert (cfg.output_path / "best_predictions_topk.json").exists()


def test_evaluate_takes_any_batches_object_and_splits_per_batch(setup):
    """evaluate() on an object with batches() and index_to_word: the
    per-batch stream splits the key before every batch, so two passes over
    the same batches give the same predictions, and the second batch draws
    with another key than the first."""
    cfg, _, mc, params, state = setup
    ds = QGDataset(cfg, cfg.test_file)
    model = params_from_numpy(params, state)
    tmc = TQ.ModelConfig(**mc._asdict())
    batch = next(ds.batches(cfg.eval_batch_size))

    class Twice:
        index_to_word = ds.index_to_word

        def batches(self, batch_size):
            yield batch
            yield batch

    kw = dict(strategy="sampling", batch_size=cfg.eval_batch_size,
              pred_max_len=cfg.question_max_length, seed=3)
    preds, bleu = E.evaluate(model, tmc, Twice(), **kw)
    again, bleu2 = E.evaluate(model, tmc, Twice(), **kw)
    assert preds == again and bleu == bleu2
    n = int(batch.valid.sum())
    assert len(preds) == 2 * n
    assert [p["question_id"] for p in preds[:n]] == [
        p["question_id"] for p in preds[n:]]
    assert ([p["pred_question"] for p in preds[:n]]
            != [p["pred_question"] for p in preds[n:]])


def test_cli_refuses_what_is_not_ported(setup, capsys):
    _, path, *_ = setup
    base = ["-c", str(path), "-s", "greedy", "--device", "cpu"]
    # --data-parallel and --streaming are ported: on one device the first
    # warns and evaluates there, as the JAX CLI does; the streaming loader
    # gives the predictions of the materialised split
    cfg0 = setup[0]
    preds = cfg0.output_path / "best_predictions_greedy.json"
    ref_bleu = E.main(base)
    ref = json.loads(preds.read_text())
    for flag in ("--data-parallel", "--streaming"):
        capsys.readouterr()
        assert E.main(base + [flag]) == ref_bleu
        assert json.loads(preds.read_text()) == ref
        if flag == "--data-parallel":
            assert "only one device is visible" in capsys.readouterr().out
    # the non-attention decoder is ported: it needs parameters of its own
    # (a checkpoint of the attention decoder is refused with ValueError),
    # and on them it writes the JAX CLI's predictions
    with pytest.raises(ValueError, match="decoder='non_attn'"):
        E.main(base + ["--decoder", "non_attn"])
    cfg, _, mc, _, _ = setup
    na = cfg.replace(output_path=cfg.output_path.parent / "non_attn")
    na.ensure_dirs()
    na_path = na.save(na.output_path / "config.json")
    params, state = TQ.init_params(TQ.ModelConfig(**mc._asdict())._replace(
        decoder="non_attn"), 5)
    JC.save_checkpoint(na.checkpoint_dir, "best", jax.tree.map(np.asarray, {
        "params": params, "model_state": state,
        "opt_state": JT.make_optimizer(na).init(params),
        "step": np.zeros((), np.int32)}))
    argv = ["-c", str(na_path), "-s", "greedy", "--decoder", "non_attn"]
    out = na.output_path / "best_predictions_greedy.json"
    ref_bleu = JE.main(argv)
    ref = json.loads(out.read_text())
    out.unlink()
    assert E.main(argv + ["--device", "cpu"]) == ref_bleu
    assert json.loads(out.read_text()) == ref
    with pytest.raises(SystemExit):
        E.main(base + ["--decoder", "pointer"])
    with pytest.raises(SystemExit, match="no 'last' checkpoint"):
        E.main(base + ["--last"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            E.main(["-c", str(path), "-s", "greedy"])
