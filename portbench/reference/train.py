"""The reference's training steps: the f32 model of ``model.py`` under
autograd, Adam in optax's form (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias-corrected moments), every parameter trained. It follows
the program's first steps on the same rows from the same weights and
reports, per step, the loss, and per leaf the first gradient's norm and
the norm of the change after the last step followed."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.reference.model import Reference

B1, B2, EPS = 0.9, 0.999, 1e-8


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: leaf} of a nested dict / list tree, paths like
    ``decoder/lstm/layers/0/wx``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def follow(cfg: Dict, params: Dict, state: Dict, batches: Sequence,
           lr: float, device, precision: str = "f32") -> Dict:
    """Train on ``batches`` (each (ids, frames, pcms, targets) as
    ``Reference.loss`` takes them), one Adam step a batch. Returns
    ``loss`` (per step), ``grad`` ({path: norm of the first step's
    gradient}), ``grad_vectors`` (that gradient, on the host) and
    ``change`` ({path: norm of the last parameters minus the first})."""
    ref = Reference(cfg, params, state, device, precision, grad=True)
    named = leaves(ref.p)
    names = list(named)
    first = {n: p.detach().clone() for n, p in named.items()}
    mu = {n: torch.zeros_like(p) for n, p in named.items()}
    nu = {n: torch.zeros_like(p) for n, p in named.items()}
    out: Dict = {"loss": []}
    for step, (ids, frames, pcms, targets) in enumerate(batches, start=1):
        obj, loss = ref.loss(ids, frames, pcms, targets)
        grads = torch.autograd.grad(obj, [named[n] for n in names],
                                    allow_unused=True)
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            for n, g in zip(names, grads):
                g = torch.zeros_like(named[n]) if g is None else g
                if step == 1:
                    out.setdefault("grad", {})[n] = float(g.norm())
                    out.setdefault("grad_vectors", {})[n] = g.cpu()
                mu[n].mul_(B1).add_((1 - B1) * g)
                nu[n].mul_(B2).add_((1 - B2) * g * g)
                mh = mu[n] / (1 - B1 ** step)
                vh = nu[n] / (1 - B2 ** step)
                named[n].sub_(lr * mh / (torch.sqrt(vh) + EPS))
        del obj, grads
    with torch.no_grad():
        out["change"] = {n: float((named[n] - first[n]).norm())
                         for n in names}
    return out


def leaf_differences(prog: Dict[str, torch.Tensor],
                     ref: Dict[str, torch.Tensor], keep: List[str]
                     ) -> Dict[str, float]:
    """Per kept leaf, the norm of the program's tensor minus the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf."""
    norms = {n: float(ref[n].norm()) for n in keep}
    med = sorted(norms.values())[len(keep) // 2]
    return {n: float((prog[n] - ref[n]).norm()) / max(norms[n], med)
            for n in keep}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> Dict[str, float]:
    """Per kept leaf, the gap between the program's and the reference's
    norm, over the larger of the reference's norm of that leaf and of the
    median leaf."""
    med = sorted(ref[n] for n in keep)[len(keep) // 2]
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep}
