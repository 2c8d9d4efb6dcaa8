"""Result plotting + best-epoch reporting (``mmqg_tpu/utils/plotting.py``;
reference utils/plot_results.py) and gradient-flow diagnostics (reference
utils/plot_gradient.py). The port's own copy: matplotlib is imported inside
the plotting functions, and the gradient trees are the port's (dicts and
lists of tensors, or of numpy arrays)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np


def plot_stat(stats: Dict, split: str, key: str, save_path: Path) -> Path:
    """One curve -> ``<save_path>/<split>_<key>.png``
    (reference utils/plot_results.py:6-11)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.plot(stats[split][key])
    plt.xlabel("epoch")
    plt.ylabel(f"{split} {key}")
    out = Path(save_path) / f"{split}_{key}.png"
    plt.savefig(out)
    plt.close()
    return out


def best_epoch_stats(stats: Dict) -> Dict[str, float]:
    """Best-train-loss / best-val-bleu report
    (reference utils/plot_results.py:13-20, with its off-by-one metric lookup
    — ``bleu[best_train_epoch]`` — fixed to use the right index)."""
    best_train = int(np.argmin(stats["train"]["loss"]))
    best_val = int(np.argmax(stats["val"]["bleu"])) if stats["val"]["bleu"] else -1
    report = {
        "best_train_epoch": best_train,
        "best_train_loss": stats["train"]["loss"][best_train],
    }
    if best_val >= 0:
        report["best_val_epoch"] = best_val
        report["best_val_bleu"] = stats["val"]["bleu"][best_val]
    return report


def plot_results(stats_file: Path, out_dir: Optional[Path] = None) -> Dict:
    """Load stats.json and emit the reference's plot set
    (reference utils/plot_results.py:22-30)."""
    stats_file = Path(stats_file)
    out_dir = Path(out_dir) if out_dir else stats_file.parent
    with open(stats_file) as f:
        stats = json.load(f)
    plot_stat(stats, "train", "loss", out_dir)
    if stats["val"].get("bleu"):
        plot_stat(stats, "val", "bleu", out_dir)
    return best_epoch_stats(stats)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        # numpy has no bfloat16: widen it, exactly
        return (x.float() if str(x.dtype) == "torch.bfloat16" else x).numpy()
    return np.asarray(x)


def grad_norms_by_layer(grads) -> List[Tuple[str, float]]:
    """Mean-|grad| per parameter tensor (reference utils/plot_gradient.py:3-8
    semantics over a tree of dicts and lists of tensors or arrays)."""
    out = []

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}/")
        elif hasattr(tree, "ndim"):
            out.append((prefix.rstrip("/"), float(np.abs(_host(tree)).mean())))

    walk(grads)
    return out


def plot_grad_flow(grads, save_path: Path) -> Path:
    """Gradient-flow bar plot (reference utils/plot_gradient.py:9-17)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # filter BIAS leaves only (reference plot_gradient.py:11 'bias' check) —
    # match the final path segment, not a substring ("/b" would also drop
    # every batch-norm subtree: bns/, bn1/, ...)
    pairs = [(n, g) for n, g in grad_norms_by_layer(grads)
             if n.split("/")[-1] not in ("b", "bias")]
    names = [n for n, _ in pairs]
    vals = [v for _, v in pairs]
    plt.figure(figsize=(max(6, len(names) * 0.4), 4))
    plt.plot(vals, alpha=0.3, color="b")
    plt.hlines(0, 0, len(vals) + 1, linewidth=1, color="k")
    plt.xticks(range(len(names)), names, rotation="vertical", fontsize=5)
    plt.xlim(0, len(vals))
    plt.xlabel("Layers")
    plt.ylabel("average gradient")
    plt.title("Gradient flow")
    plt.grid(True)
    plt.tight_layout()
    out = Path(save_path)
    plt.savefig(out)
    plt.close()
    return out
