"""Released pretrained encoder weights -> a port checkpoint,
``python -m mmqg_tpu_torch.convert`` (``scripts/convert_released_weights.py``
of the JAX package).

The reference downloaded both files when it built its model:

* VGGish (``torch.hub.load('harritaylor/torchvggish', 'vggish')``):
  ``vggish-10086976.pth``, sha256 prefix ``10086976``, from
  https://github.com/harritaylor/torchvggish/releases/download/v0.1/vggish-10086976.pth
* R(2+1)D-18 on Kinetics-400 (``torchvision.models.video.r2plus1d_18(
  pretrained=True)``): ``r2plus1d_18-91a641e6.pth``, sha256 prefix
  ``91a641e6``, from
  https://download.pytorch.org/models/r2plus1d_18-91a641e6.pth
* the Video Swin Transformer, base, on Kinetics-400
  (``torchvision.models.video.swin3d_b(weights="KINETICS400_V1")``):
  ``swin3d_b_1k-24f7c7c6.pth``, sha256 prefix ``24f7c7c6``, from
  https://download.pytorch.org/models/swin3d_b_1k-24f7c7c6.pth (the
  port's third video encoder; the reference repository does not load it)

Each file's sha256 prefix is checked (``--no-verify-hash`` skips it), its
weights go through ``models.audio_encoder.load_vggish_state_dict`` and
``compat.from_torchvision.load_pretrained_video_resnet`` into a fresh train
state (``train.init_train_state``), and the result is written as the msgpack
checkpoint ``<alias>`` that ``Trainer.resume(alias)`` (``train --resume
--resume-alias <alias>``) reads:

    python -m mmqg_tpu_torch.convert --config <results>/config.json \\
        --vggish vggish-10086976.pth --resnet r2plus1d_18-91a641e6.pth \\
        --alias pretrained [--device cpu]

``--resnet`` fits only a config with ``video_encoder: "resnet"``, and
``--swin3d <file>`` only one with ``video_encoder: "swin3d"`` whose
``vid_mean`` and ``vid_std`` are the weights' own (ImageNet's, as
torchvision's transforms for them normalise); a swin3d_b state dict of
any other shape is refused, naming the tensor.
``--dry-run`` rehearses the whole path with no download: it writes a tiny
corpus and stand-in ``.pth`` files of seeded random values under the
released key names, converts them and restores the checkpoint.
"""

from __future__ import annotations

import argparse
import hashlib
import tempfile
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from mmqg_tpu_torch import checkpoint as ckpt
from mmqg_tpu_torch.compat.from_jax import train_state_to_numpy
from mmqg_tpu_torch.compat.from_torchvision import (
    import_video_swin, load_pretrained_video_resnet)
from mmqg_tpu_torch.config import Config
from mmqg_tpu_torch.data.dataset import QGDataset
from mmqg_tpu_torch.data.glove import ingest_glove
from mmqg_tpu_torch.data.vocab import prepare_data
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.models.audio_encoder import BLOCKS as AUDIO_BLOCKS
from mmqg_tpu_torch.models.audio_encoder import (_VGGISH_CONV_KEYS,
                                                 _VGGISH_FC_KEYS,
                                                 load_vggish_state_dict)
from mmqg_tpu_torch.models import video_resnet, video_swin
from mmqg_tpu_torch.models.video_encoder import flatten_dim_for
from mmqg_tpu_torch.optim import make_optimizer, tree_leaves, tree_map
from mmqg_tpu_torch.train import Trainer, init_train_state
from mmqg_tpu_torch.utils.device import resolve_device

PINNED = {
    "vggish": ("vggish-10086976.pth", "10086976"),
    "resnet": ("r2plus1d_18-91a641e6.pth", "91a641e6"),
    "swin3d": ("swin3d_b_1k-24f7c7c6.pth", "24f7c7c6"),
}


def _check_sha(path: Path, kind: str) -> None:
    fname, prefix = PINNED[kind]
    digest = hashlib.sha256(Path(path).read_bytes()).hexdigest()
    if not digest.startswith(prefix):
        raise SystemExit(
            f"{kind}: {path} sha256 {digest[:8]}... does not match the "
            f"released {fname} (expected prefix {prefix}). Download from "
            f"the pinned URL in this script's docstring.")
    print(f"{kind}: sha256 {digest[:8]}... OK ({fname})")


def _load_state_dict(path: Path) -> Dict[str, np.ndarray]:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v.numpy() for k, v in sd.items()}


def _check_resnet_shapes(sd: Dict[str, np.ndarray]) -> None:
    """SystemExit naming the first tensor of a torchvision ``r2plus1d_18``
    state dict whose shape is not the model's (the Kinetics head aside):
    a checkpoint the model could not restore is never written."""
    for key, shape in r2plus1d_18_shapes():
        if key in sd and not key.startswith("fc.") \
                and tuple(np.shape(sd[key])) != shape:
            raise SystemExit(
                f"resnet: {key} has shape {tuple(np.shape(sd[key]))}, the "
                f"model's R(2+1)D-18 takes {shape}")


def convert(config_path: Path, vggish: Optional[Path], resnet: Optional[Path],
            alias: str, verify_hash: bool = True, mode: str = "trimodal",
            device="cuda", swin3d: Optional[Path] = None) -> Path:
    """Write ``<checkpoint_dir>/<alias>.msgpack`` from the released files
    given; returns its path. The train state is built on ``device`` (the
    card unless the caller asks for the CPU)."""
    device = resolve_device(device, caller="convert")
    config = Config.load(config_path)
    if resnet is not None and config.video_encoder != "resnet":
        raise SystemExit(
            "--resnet given but the config's video_encoder is "
            f"{config.video_encoder!r}; the R(2+1)D weights only fit "
            "video_encoder: 'resnet' (reference model/encoder.py:24)")
    if swin3d is not None and config.video_encoder != "swin3d":
        raise SystemExit(
            "--swin3d given but the config's video_encoder is "
            f"{config.video_encoder!r}; the swin3d_b weights only fit "
            "video_encoder: 'swin3d'")
    if swin3d is not None and not (
            np.allclose(config.vid_mean, video_swin.MEAN)
            and np.allclose(config.vid_std, video_swin.STD)):
        raise SystemExit(
            f"--swin3d given but the config normalises frames with vid_mean "
            f"{tuple(config.vid_mean)} and vid_std {tuple(config.vid_std)}; "
            f"the swin3d_b weights expect mean {video_swin.MEAN} and std "
            f"{video_swin.STD} (torchvision's "
            "Swin3D_B_Weights.KINETICS400_V1 transforms)")
    if vggish is None and resnet is None and swin3d is None:
        raise SystemExit("nothing to convert: pass --vggish, --resnet "
                         "and/or --swin3d")
    if verify_hash:
        for kind, path in (("vggish", vggish), ("resnet", resnet),
                           ("swin3d", swin3d)):
            if path is not None:
                _check_sha(path, kind)
    resnet_sd = None
    if resnet is not None:
        resnet_sd = _load_state_dict(resnet)
        _check_resnet_shapes(resnet_sd)
    swin_enc = None
    if swin3d is not None:
        try:
            swin_enc = import_video_swin(_load_state_dict(swin3d))
        except ValueError as e:
            raise SystemExit(str(e)) from None

    train_ds = QGDataset(config, config.train_file, load_media=False)
    emb = np.load(config.weights_matrix_file).astype(np.float32)
    mc = qg_model.ModelConfig.from_config(config, n_vocab=len(train_ds.vocab),
                                          mode=mode)
    ts = init_train_state(mc, emb, make_optimizer(config), seed=config.seed,
                          device=device)
    tree = train_state_to_numpy(ts.model, ts.opt_state, ts.step)
    del ts
    params, state = tree["params"], tree["model_state"]
    imported = []
    if vggish is not None:
        if "audio_enc" not in params:
            raise SystemExit(f"--vggish given but mode {mode!r} has no "
                             "audio encoder")
        params["audio_enc"] = load_vggish_state_dict(
            params["audio_enc"], _load_state_dict(vggish))
        imported.append("vggish")
    if resnet_sd is not None:
        params, state = load_pretrained_video_resnet(params, state, resnet_sd)
        imported.append("r2plus1d_18")
    if swin_enc is not None:
        params = dict(params, video_enc=swin_enc[0])
        state = dict(state, video_enc=swin_enc[1])
        imported.append("swin3d_b")
    tree["params"], tree["model_state"] = params, state

    out = ckpt.save_checkpoint(
        config.checkpoint_dir, alias, tree,
        metadata={"pretrained": imported, "mode": mode,
                  "source": "convert_released_weights"})
    print(f"checkpoint written: {out} (alias {alias!r}, "
          f"imported: {', '.join(imported)})")
    return out


# ------------------------------------------------------------ the dry run

def vggish_shapes(mel_frames: int = 96, mel_bins: int = 64,
                  embedding_dim: int = 128) -> Iterator[Tuple[str, tuple]]:
    """torchvggish's state_dict names and shapes (the released file's at
    the default 96 x 64 log-mel patch)."""
    c_in = 1
    outs = [c for c, reps in AUDIO_BLOCKS for _ in range(reps)]
    for key, c_out in zip(_VGGISH_CONV_KEYS, outs):
        yield f"{key}.weight", (c_out, c_in, 3, 3)
        yield f"{key}.bias", (c_out,)
        c_in = c_out
    flat = (mel_frames // 16) * (mel_bins // 16) * c_in
    for key, (i, o) in zip(_VGGISH_FC_KEYS, ((flat, 4096), (4096, 4096),
                                             (4096, embedding_dim))):
        yield f"{key}.weight", (o, i)
        yield f"{key}.bias", (o,)


def r2plus1d_18_shapes(num_classes: int = 400
                       ) -> Iterator[Tuple[str, tuple]]:
    """torchvision ``r2plus1d_18``'s state_dict names and shapes, those of
    the released file and of the port's R(2+1)D-18 tree
    (``video_resnet.init_numpy``), the inverse of
    ``from_torchvision.import_video_resnet``: each block's two (2+1)D convs
    share the midplanes of its input and output channels."""
    def conv(key, cin, cout, k):
        yield f"{key}.weight", (cout, cin) + k

    def bn(key, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            yield f"{key}.{leaf}", (c,)
        yield f"{key}.num_batches_tracked", ()

    yield from conv("stem.0", 3, 45, (1, 7, 7))
    yield from bn("stem.1", 45)
    yield from conv("stem.3", 45, 64, (3, 1, 1))
    yield from bn("stem.4", 64)
    cin = 64
    for si, cout in enumerate(video_resnet.STAGES):
        for bi in range(2):
            pre = f"layer{si + 1}.{bi}"
            m = video_resnet.midplanes(cin, cout)
            for cn, a in (("conv1", cin), ("conv2", cout)):
                yield from conv(f"{pre}.{cn}.0.0", a, m, (1, 3, 3))
                yield from bn(f"{pre}.{cn}.0.1", m)
                yield from conv(f"{pre}.{cn}.0.3", m, cout, (3, 1, 1))
                yield from bn(f"{pre}.{cn}.1", cout)
            if bi == 0 and si > 0:
                yield from conv(f"{pre}.downsample.0", cin, cout, (1, 1, 1))
                yield from bn(f"{pre}.downsample.1", cout)
            cin = cout
    yield "fc.weight", (num_classes, 512)
    yield "fc.bias", (num_classes,)


def standin_state_dict(shapes, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded stand-in values for a released file: weights uniform in
    [-0.05, 0.05), variances in [0.5, 1.5), step counts 0."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in shapes:
        if key.endswith("num_batches_tracked"):
            a = np.zeros(shape, np.int64)
        else:
            a = rng.random(shape, dtype=np.float32)
            a = a + np.float32(0.5) if key.endswith("running_var") else (
                (a - np.float32(0.5)) * np.float32(0.1))
        sd[key] = torch.from_numpy(a)
    return sd


_DRY_WORDS = ("what", "is", "the", "a", "lecture", "about", "energy",
              "matrix", "of", "rank", "proof", "step", "why", "does", "it",
              "hold")


def _dry_corpus(cfg: Config, n: int = 10, seed: int = 0) -> None:
    """A tiny prepared corpus, made by the port's own prepare stages: a
    GloVe file covering half the words, then the glove and data stages
    over ``n`` records."""
    rng = np.random.RandomState(seed)
    cfg.glove_file.parent.mkdir(parents=True, exist_ok=True)
    with open(cfg.glove_file, "w") as f:
        for w in _DRY_WORDS[::2]:
            vec = " ".join(f"{v:.5f}" for v in rng.randn(cfg.glove_emb_dim))
            f.write(f"{w} {vec}\n")
    ingest_glove(cfg)

    def sentence(k):
        return " ".join(rng.choice(_DRY_WORDS, k))

    records = [{"question_id": i, "video_id": f"v{i % 3}",
                "question": sentence(4), "context": sentence(9),
                "answer": sentence(2)} for i in range(n)]
    prepare_data(cfg, records)


def dry_run(work_dir: Optional[Path] = None, device="cuda") -> Path:
    """The conversion with no download: a tiny trimodal R(2+1)D config
    and corpus under ``work_dir`` (a new temporary directory when None),
    stand-in VGGish and R(2+1)D-18 files, ``convert`` (hash check
    skipped), then the checkpoint restored through ``Trainer.resume`` and
    its ``audio_enc`` compared with the stand-in's weights. Returns the
    work directory."""
    root = Path(work_dir) if work_dir else Path(
        tempfile.mkdtemp(prefix="convert_dry_"))
    cfg = Config(
        output_path=root / "results", dataset_path=root / "dataset",
        data_path=root / "data", glove_path=root / "glove.6B",
        glove_emb_dim=8, batch_size=4, question_max_length=6,
        context_max_length=12, av_max_length=3, frame_size=32,
        flatten_dim=flatten_dim_for(32), video_hidden_dim=512,
        text_lstm_hidden_dim=16, text_lstm_layers=2, dec_lstm_hidden_dim=16,
        dec_lstm_layers=2, video_encoder="resnet", optim="sgd",
    ).ensure_dirs()
    _dry_corpus(cfg)
    cfg_path = cfg.save()

    vggish_sd = standin_state_dict(vggish_shapes(), seed=1)
    vggish_path = root / "vggish-standin.pth"
    torch.save(vggish_sd, vggish_path)
    resnet_path = root / "r2plus1d_18-standin.pth"
    torch.save(standin_state_dict(r2plus1d_18_shapes(), seed=2), resnet_path)

    convert(cfg_path, vggish_path, resnet_path, alias="pretrained",
            verify_hash=False, device=device)

    config = Config.load(cfg_path)
    train_ds = QGDataset(config, config.train_file, load_media=False)
    val_ds = QGDataset(config, config.val_file, load_media=False)
    emb = np.load(config.weights_matrix_file).astype(np.float32)
    mc = qg_model.ModelConfig.from_config(config, n_vocab=len(train_ds.vocab))
    trainer = Trainer(config, mc, emb, train_ds, val_ds, device=device,
                      log_fn=lambda *a, **k: None)
    if not trainer.resume("pretrained"):
        raise RuntimeError("dry run: no 'pretrained' checkpoint to resume")
    meta = ckpt.load_metadata(config.checkpoint_dir, "pretrained")
    if meta["pretrained"] != ["vggish", "r2plus1d_18"]:
        raise RuntimeError(f"dry run: metadata {meta}")
    audio = tree_map(lambda p: p.detach().cpu().numpy(),
                     qg_model.param_tree(trainer.train_state.model)
                     )["audio_enc"]
    want = load_vggish_state_dict(audio, {k: v.numpy()
                                          for k, v in vggish_sd.items()})
    if not all(np.array_equal(a, b) for a, b in zip(tree_leaves(audio),
                                                     tree_leaves(want))):
        raise RuntimeError("dry run: the restored audio_enc is not the "
                           "stand-in's weights")
    print(f"dry run OK: conversion + checkpoint round trip under {root}")
    return root


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=Path,
                    help="results/config.json of the target run")
    ap.add_argument("--vggish", type=Path,
                    help="released vggish-10086976.pth")
    ap.add_argument("--resnet", type=Path,
                    help="released r2plus1d_18-91a641e6.pth "
                         "(video_encoder: resnet configs only)")
    ap.add_argument("--swin3d", type=Path,
                    help="released swin3d_b_1k-24f7c7c6.pth "
                         "(video_encoder: swin3d configs only)")
    ap.add_argument("--alias", default="pretrained",
                    help="checkpoint alias to write (default: pretrained)")
    ap.add_argument("--mode", default="trimodal", choices=qg_model.MODES,
                    help="model mode the checkpoint must match "
                         "(default: trimodal)")
    ap.add_argument("--no-verify-hash", action="store_true",
                    help="skip the sha256 prefix check")
    ap.add_argument("--dry-run", action="store_true",
                    help="no-download rehearsal on stand-in state_dicts")
    ap.add_argument("--work-dir", type=Path, default=None,
                    help="--dry-run: where to write its corpus, stand-ins "
                         "and checkpoint (default: a new temporary dir)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the train state is built (default: cuda; "
                         "raises without a card unless 'cpu')")
    args = ap.parse_args(argv)
    if args.dry_run:
        dry_run(args.work_dir, device=args.device)
        return
    if not args.config:
        ap.error("--config is required (or use --dry-run)")
    convert(args.config, args.vggish, args.resnet, args.alias,
            verify_hash=not args.no_verify_hash, mode=args.mode,
            device=args.device, swin3d=args.swin3d)


if __name__ == "__main__":
    main()
