"""Evaluation: decode a dataset and score it with BLEU (``mmqg_tpu/evaluate.py``).

    python -m mmqg_tpu_torch.evaluate -c config.json -s beam --best   # card
    python -m mmqg_tpu_torch.evaluate -c config.json -s beam --best --device cpu

``--best``/``--last`` pick the checkpoint alias (the JAX trainer's msgpack
or the port's, read by ``checkpoint.load_checkpoint``); ``--strategy`` is
greedy, sampling, topk (``--top-k``), topp (``--top-p``) or beam. The
predictions go to ``<output_path>/<alias>_predictions_<strategy>.json`` as
records {question_id, gt_question, pred_question}, and the BLEU suite is
printed and returned, as the JAX package's CLI does.

``--data-parallel`` evaluates over every visible card, one model replica
each (``evaluate(mesh=...)``); with one card it warns and runs on it.
``--streaming`` reads the test split with ``data.streaming.StreamingLoader``
instead of materialising it. ``--compile-cache`` is left out, since the
port has no compiled programs to cache.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import torch

from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch import decode as DEC
from mmqg_tpu_torch import metrics as M
from mmqg_tpu_torch.compat.from_jax import params_from_numpy
from mmqg_tpu_torch.config import Config
from mmqg_tpu_torch.data.dataset import QGDataset
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.data.streaming import StreamingLoader
from mmqg_tpu_torch.parallel.mesh import (Mesh, data_parallel_mesh,
                                          visible_devices)
from mmqg_tpu_torch.parallel.replicas import Replicas
from mmqg_tpu_torch.train import batch_arrays, to_device
from mmqg_tpu_torch.utils import prng
from mmqg_tpu_torch.utils.device import resolve_device
from mmqg_tpu_torch.utils.pipelining import pipelined

def evaluate(model: qg_model.QGModel, mc: qg_model.ModelConfig, dataset, *,
             strategy: str = "greedy", batch_size: int = 32,
             pred_max_len: int = 21, beam_size: int = 4, topk: int = 1,
             topp: float = 0.9, seed: int = 0, compat_bleu: bool = False,
             mesh: Optional[Mesh] = None
             ) -> Tuple[List[Dict], Dict[str, float]]:
    """Decode every batch of ``dataset`` (any object with
    ``batches(batch_size)`` and ``index_to_word``) on the model's device,
    computing in bf16 as the JAX evaluate does; returns (predictions, BLEU
    suite averages over the valid rows).

    The sampling strategies use the legacy per-batch stream: ``rng, k =
    split(rng)`` before each batch, from ``PRNGKey(seed)``, as the JAX
    evaluate does.

    ``mesh``: evaluate data-parallel, one replica of ``model`` on each
    device of its data axis (``parallel.replicas``): each batch is padded
    to the data axis and split, its AV buckets taken from the whole batch;
    the per-batch stream draws for the padded batch, as the JAX evaluate's
    does on a mesh, so each replica's rows take their share of it."""
    device = model.embedding.device
    rng = prng.prng_key(seed, device)
    replicas = Replicas(model, mesh) if mesh is not None else None
    predictions: List[Dict] = []
    sums = {k: 0.0 for k in M.BLEU_WEIGHTS}
    n_total = 0

    def dispatch(batch):
        nonlocal rng
        arrays = batch_arrays(batch)
        caps = dict(audio_cap=DEC.audio_bucket(mc, arrays["audio_len"]),
                    frames_cap=DEC.frames_bucket(mc, arrays["frames_len"]))
        key = None
        if strategy not in ("greedy", "beam"):
            rng, key = prng.split(rng)

        def run(model, inputs, lo: int, total: int):
            if strategy == "beam":
                return DEC.beam_decode_batch(model, mc, inputs,
                                             max_len=pred_max_len,
                                             beam_size=beam_size,
                                             dtype=torch.bfloat16, **caps)
            return DEC.decode_batch(
                model, mc, inputs,
                None if key is None else key.to(model.embedding.device),
                strategy=strategy, max_len=pred_max_len, k=topk, p=topp,
                dtype=torch.bfloat16, global_rows=(lo, total), **caps)

        if replicas is not None:
            return replicas.map(run, arrays)
        toks = run(model, to_device(arrays, device), 0,
                   len(arrays["valid"]))
        return lambda: toks.cpu().numpy()

    def finalize(gather, batch):
        nonlocal n_total
        # padded rows of a sharded batch are past the zip's end
        word_rows = DEC.tokens_to_words(gather(), dataset.index_to_word)
        for words, q, qid, ok in zip(word_rows, batch.questions,
                                     batch.question_id, batch.valid):
            if not ok:
                continue
            for key, v in M.bleu_suite(q, words, compat=compat_bleu).items():
                sums[key] += v
            predictions.append({"question_id": int(qid), "gt_question": q,
                                "pred_question": " ".join(words)})
            n_total += 1

    # the host scores batch i while the device decodes the next ones
    try:
        for _ in pipelined(dataset.batches(batch_size), dispatch, finalize):
            pass
    finally:
        if replicas is not None:
            replicas.close()
    return predictions, {k: v / max(n_total, 1) for k, v in sums.items()}


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(
        description="Evaluate model (PyTorch port)")
    parser.add_argument("-b", "--best", action="store_true",
                        help="get best epoch results")
    parser.add_argument("-l", "--last", action="store_true",
                        help="get last epoch results")
    parser.add_argument("-c", "--config_path", type=str, required=True)
    parser.add_argument("-s", "--strategy", type=str, required=True,
                        choices=["greedy", "sampling", "topk", "topp",
                                 "beam"])
    parser.add_argument("--mode", type=str, default="trimodal",
                        choices=["text", "text_video", "trimodal"])
    parser.add_argument("--decoder", type=str, default="attn",
                        choices=["attn", "non_attn"])
    parser.add_argument("--compat-bleu", action="store_true",
                        help="score with the reference's (non-standard) "
                             "BLEU call")
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard evaluation batches over every visible "
                             "card (one replica each; a data-axis mesh); "
                             "it buys no questions/s while the decode is "
                             "host-bound: one interpreter pays every "
                             "replica's launches")
    parser.add_argument("--top-k", type=int, default=1,
                        help="k for -s topk (reference used 1)")
    parser.add_argument("--top-p", type=float, default=0.9,
                        help="nucleus mass for -s topp")
    parser.add_argument("--streaming", action="store_true",
                        help="stream test batches from disk (double-buffered "
                             "pack pool) instead of materialising the split "
                             "in host RAM")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default; the kernels run there) or "
                             "'cpu' (the kernels' plain versions)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device, caller="evaluate --device")
    config = Config.load(args.config_path)
    alias = "last" if args.last else "best"
    load_media = args.mode != "text"
    if args.streaming:
        dataset = StreamingLoader(config, config.test_file,
                                  batch_size=config.eval_batch_size,
                                  load_media=load_media)
    else:
        dataset = QGDataset(config, config.test_file, load_media=load_media)
    mesh = None
    if args.data_parallel:
        mesh = data_parallel_mesh(
            config, visible_devices() if device.type == "cuda" else [device])
    mc = qg_model.ModelConfig.from_config(config, n_vocab=len(dataset.vocab),
                                          mode=args.mode, dec=args.decoder)
    qg_model.check_supported(mc)
    if not ckpt.has_checkpoint(config.checkpoint_dir, alias):
        raise SystemExit(
            f"error: no '{alias}' checkpoint in {config.checkpoint_dir} — "
            f"train first (mmqg_tpu_torch.train) or pass "
            f"{'--best' if alias == 'last' else '--last'}")
    state = ckpt.load_checkpoint(config.checkpoint_dir, alias)
    model = params_from_numpy(state["params"], state["model_state"], device)

    predictions, bleu = evaluate(
        model, mc, dataset, strategy=args.strategy,
        batch_size=config.eval_batch_size,
        pred_max_len=config.question_max_length, beam_size=config.beam_size,
        topk=args.top_k, topp=args.top_p, compat_bleu=args.compat_bleu,
        mesh=mesh)

    out_path = config.output_path / f"{alias}_predictions_{args.strategy}.json"
    with open(out_path, "w") as f:
        json.dump(predictions, f)
    print(f"Predictions saved to {out_path}")
    print(f"Val_bleu - {round(bleu['bleu'], 3)}, "
          f"Val_bleu_1 - {round(bleu['bleu_1'], 3)}")
    return bleu


if __name__ == "__main__":
    main()
