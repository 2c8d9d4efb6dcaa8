"""Optimizers and learning-rate schedules written as plain functions on
tensors, mirroring the optax pieces ``mmqg_tpu/train.py`` builds
(``learning_rate_schedule`` and ``make_optimizer``).

``torch.optim`` is not used: a checkpoint's optimizer state has to map leaf
for leaf onto ``flax.serialization.to_state_dict(optimizer.init(params))``
of the JAX package, so the state here has optax's layout. A tree is nested
dicts and lists with tensor leaves (the JAX pytree, lists for lists); an
optax state becomes, as in its state dict:

* a ``chain`` -- a list of its members' states;
* a NamedTuple state -- a dict of its fields (``ScaleByAdamState`` ->
  ``{"count", "mu", "nu"}``, ``EmptyState`` -> ``{}``);
* ``masked`` -- ``{"inner_state": ...}``, with ``{}`` in place of every
  masked-out leaf (optax's ``MaskedNode``);
* ``multi_transform`` -- ``{"inner_states": {group: masked state}}``.

Counts are int32 0-d tensors; moments are float32 like the parameters. Each
transform is an (init, update) pair, as in optax; ``update`` computes new
tensors and never writes in place. :func:`apply_updates` adds the updates
to the parameters in place.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

Tensor = torch.Tensor
Tree = Any
Schedule = Callable[[Tensor], Tensor]
_INT32_MAX = 2 ** 31 - 1


# ------------------------------------------------------------------- trees

def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Map ``fn`` over the leaves of ``tree`` (and the matching nodes of
    ``rest``). Dicts and lists recurse; an empty dict (a masked-out leaf)
    stays empty."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """Leaves in a fixed order: dict keys sorted, as JAX flattens."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map_with_path(fn: Callable, tree: Tree, path: Tuple = ()) -> Tree:
    """``fn(path, leaf)`` with the path of keys / list indices."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def global_norm(tree: Tree) -> Tensor:
    """``optax.global_norm``: the l2 norm of all leaves together."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(x * x) for x in leaves))


def _mask_out(tree: Tree, mask: Tree) -> Tree:
    return tree_map(lambda x, m: x if m else {}, tree, mask)


def _count(device) -> Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _increment(count: Tensor) -> Tensor:
    """``numerics.safe_increment``: +1, saturating at the int32 maximum."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def _device(tree: Tree):
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


# -------------------------------------------------------------- transforms

class Transform(NamedTuple):
    """An optax ``GradientTransformation``: ``init(params) -> state`` and
    ``update(updates, state, params) -> (updates, state)``."""
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Optional[Tree]], Tuple[Tree, Tree]]


def _empty(params: Tree) -> Dict:
    return {}


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Transform:
    """``optax.scale_by_adam``: bias-corrected moments, ``eps`` outside
    the square root."""
    def init(params):
        zeros = tree_map(torch.zeros_like, params)
        return {"count": _count(_device(params)), "mu": zeros,
                "nu": tree_map(torch.zeros_like, params)}

    def update(updates, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, updates,
                      state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, updates,
                      state["nu"])
        count = _increment(state["count"])
        n = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, device=n.device), n)
        c2 = 1 - torch.pow(torch.tensor(b2, device=n.device), n)
        out = tree_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps),
                       mu, nu)
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def scale_by_learning_rate(lr: Union[float, Schedule]) -> Transform:
    """``optax.scale_by_learning_rate``: ``-lr * g``; a schedule keeps a
    count that starts at 0, so the first update uses ``lr(0)``."""
    if not callable(lr):
        return Transform(_empty, lambda u, s, p=None: (
            tree_map(lambda g: -lr * g, u), s))

    def init(params):
        return {"count": _count(_device(params))}

    def update(updates, state, params=None):
        step = -lr(state["count"])
        return (tree_map(lambda g: step.to(g.dtype) * g, updates),
                {"count": _increment(state["count"])})

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    """``optax.add_decayed_weights``: ``g + wd * p``."""
    return Transform(_empty, lambda u, s, p: (
        tree_map(lambda g, x: g + weight_decay * x, u, p), s))


def clip_by_global_norm(max_norm: float) -> Transform:
    """``optax.clip_by_global_norm``: scale every leaf by
    ``max_norm / norm`` when the norm of the updates reaches ``max_norm``."""
    def update(updates, state, params=None):
        norm = global_norm(updates)
        keep = norm < max_norm
        return tree_map(lambda t: torch.where(keep, t, (t / norm) * max_norm),
                        updates), state

    return Transform(_empty, update)


def set_to_zero() -> Transform:
    return Transform(_empty, lambda u, s, p=None: (
        tree_map(torch.zeros_like, u), s))


def identity() -> Transform:
    return Transform(_empty, lambda u, s, p=None: (u, s))


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, new_state

    return Transform(init, update)


def masked(inner: Transform, mask_fn: Callable[[Tree], Tree]) -> Transform:
    """``optax.masked``: ``inner`` sees only the leaves where the mask is
    True; the others pass through unchanged."""
    def init(params):
        return {"inner_state": inner.init(_mask_out(params, mask_fn(params)))}

    def update(updates, state, params=None):
        mask = mask_fn(updates if params is None else params)
        new, inner_state = inner.update(
            _mask_out(updates, mask), state["inner_state"],
            None if params is None else _mask_out(params, mask))
        merged = tree_map(lambda u, m, n: n if m else u, updates, mask, new)
        return merged, {"inner_state": inner_state}

    return Transform(init, update)


def multi_transform(transforms: Dict[str, Transform],
                    label_fn: Callable[[Tree], Tree]) -> Transform:
    """``optax.multi_transform``: each group's transform, masked to the
    leaves with that label, in the dict's order."""
    parts = {group: masked(t, lambda p, g=group: tree_map(
        lambda lab: lab == g, label_fn(p))) for group, t in transforms.items()}

    def init(params):
        return {"inner_states": {g: t.init(params) for g, t in parts.items()}}

    def update(updates, state, params=None):
        new_states = {}
        for g, t in parts.items():
            updates, new_states[g] = t.update(
                updates, state["inner_states"][g], params)
        return updates, {"inner_states": new_states}

    return Transform(init, update)


def apply_updates(params: Tree, updates: Tree) -> None:
    """``optax.apply_updates``, in place: ``p += u``."""
    with torch.no_grad():
        tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)


# --------------------------------------------------------------- schedules

def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule``: ``init`` to ``end`` over ``steps``."""
    if steps <= 0:
        return lambda count: torch.full((), init, dtype=torch.float32,
                                        device=count.device)

    def schedule(count):
        c = torch.clamp(count, 0, steps).to(torch.float32)
        frac = 1 - c / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c = torch.clamp(count.to(torch.float32), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)

    return schedule


def _join(schedules, boundaries) -> Schedule:
    """``optax.join_schedules``."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, s(count - boundary))
        return out

    return schedule


def learning_rate_schedule(config) -> Union[float, Schedule]:
    """``train.learning_rate_schedule``: ``lr_schedule`` in {"constant",
    "cosine", "linear"} with ``lr_warmup_steps`` of linear warmup from 0
    and, for the decaying shapes, an ``lr_decay_steps`` horizon (warmup
    included) down to ``lr * lr_min_ratio``. A plain constant is a float;
    the others map an int32 count tensor to a float32 tensor. The same
    checks raise the same errors."""
    lr = config.lr
    sched = getattr(config, "lr_schedule", "constant")
    warmup = int(getattr(config, "lr_warmup_steps", 0) or 0)
    decay = int(getattr(config, "lr_decay_steps", 0) or 0)
    ratio = float(getattr(config, "lr_min_ratio", 0.0) or 0.0)
    end = lr * ratio
    if sched == "constant":
        if decay or ratio:
            raise ValueError(
                f"lr_decay_steps={decay}/lr_min_ratio={ratio} are set but "
                f"lr_schedule is 'constant' — set lr_schedule to 'cosine' "
                f"or 'linear' (or clear the decay knobs)")
        if not warmup:
            return lr
        return _join([_linear(0.0, lr, warmup),
                      lambda count: torch.full((), lr, dtype=torch.float32,
                                               device=count.device)],
                     [warmup])
    if sched not in ("cosine", "linear"):
        raise ValueError(f"unknown lr_schedule: {sched}")
    if decay <= warmup:
        raise ValueError(
            f"lr_schedule={sched!r} needs lr_decay_steps (total optimizer "
            f"updates, > lr_warmup_steps); got decay={decay}, "
            f"warmup={warmup}")
    if sched == "cosine":
        alpha = 0.0 if lr == 0.0 else end / lr
        return _join([_linear(0.0, lr, warmup),
                      _cosine(lr, decay - warmup, alpha)], [warmup])
    return _join([_linear(0.0, lr, warmup),
                  _linear(lr, end, decay - warmup)], [warmup])


def make_optimizer(config) -> Transform:
    """``train.make_optimizer``: adam (adamw when ``weight_decay`` > 0,
    decaying only leaves with ndim >= 2) or sgd, with the learning-rate
    schedule, an optional ``clip_by_global_norm`` in front, and the
    ``text_non_trainable`` freeze of the embedding table (a
    ``multi_transform`` whose "freeze" group is set to zero, so the clip's
    norm sees only the trained leaves)."""
    lr = learning_rate_schedule(config)
    wd = float(getattr(config, "weight_decay", 0.0) or 0.0)
    if config.optim == "adam":
        if wd > 0:
            opt = chain(scale_by_adam(),
                        masked(add_decayed_weights(wd), lambda params: tree_map(
                            lambda p: p.ndim >= 2, params)),
                        scale_by_learning_rate(lr))
        else:
            opt = chain(scale_by_adam(), scale_by_learning_rate(lr))
    elif config.optim == "sgd":
        if wd > 0:
            raise ValueError(
                "weight_decay is only implemented for optim='adam' "
                "(decoupled adamw); got optim='sgd' — a silently ignored "
                "knob would change the training the user asked for")
        opt = chain(identity(), scale_by_learning_rate(lr))
    else:
        raise ValueError(f"unknown optim: {config.optim}")
    if config.grad_clip_norm and config.grad_clip_norm > 0:
        opt = chain(clip_by_global_norm(config.grad_clip_norm), opt)
    if getattr(config, "text_non_trainable", False):
        def labels(params):
            return tree_map_with_path(
                lambda path, _: "freeze" if path[0] == "embedding"
                else "train", params)
        opt = multi_transform({"train": opt, "freeze": set_to_zero()},
                              labels)
    return opt
