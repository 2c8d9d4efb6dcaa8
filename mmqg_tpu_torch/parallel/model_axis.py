"""The model axis of a process grid: tensor parallelism and the collectives
of sequence parallelism, written out where the JAX package lets GSPMD
place them (``mmqg_tpu/parallel/mesh.py``'s ``param_shardings`` and
``sequence_constraint``, ``mmqg_tpu/ops/attention_sp.py``).

JAX annotates each parameter with its sharding and XLA inserts the
collectives. The port stores each leaf as ``mesh.param_shardings`` splits
it -- between steps a rank of the model group holds its slice
(:class:`ModelAxis`) -- and uses the split leaves in one of two ways:

* **Gather at use.** A split leaf that a hand-written kernel or a cuDNN
  conv reads whole (the LSTM gate matrices of K1/K4, the attention heads
  of K2, the conv kernels, the VGGish dense layers) is all-gathered over
  the model group once a step, or once a decode, and freed after
  (:meth:`ModelAxis.gathered`). The kernel then runs whole on every rank
  of the group: their persistent sweeps synchronise with a grid barrier
  every time step and cannot wait on another process. The JAX program
  runs the same: its Pallas calls have no partitioning rule, so GSPMD
  hands them whole operands. The ranks of a model group compute identical
  replicas, so the backward of the gather keeps this rank's slice of the
  gradient (:func:`gather_from_model`); a reduce-scatter would count it
  ``model`` times.
* **Column-parallel vocab projection.** ``decoder/out/w``, split over the
  vocabulary, stays split: each rank computes its columns of the logits
  (``layers.Dense`` with a ``column_group``), and only the log-softmax
  reductions cross the axis (:func:`log_prob`: a max and a sum
  all-reduce and the target's logit from the rank that owns it;
  :func:`argmax`: each rank's max and index, combined), JAX's account of
  the rule (``mesh.py:12-13``). The projection's input gradient is summed
  over the group (:func:`copy_to_model`).

For the parameters the gather writes the whole tensor into the
parameter's storage for the step (as ``parallel/zero.py``'s FSDP does), so
every module, kernel wrapper and cuDNN call reads it unchanged, and
:meth:`ModelAxis.own_grads` applies :func:`gather_from_model`'s backward
to the whole gradient the parameter collects.

The four autograd Functions are the conventions of a replicated
computation: :func:`copy_to_model` (identity; backward sums over the
group), :func:`reduce_from_model` (sum; backward identity, the cotangent
of a sum that every rank holds equally), :func:`gather_from_model`
(all-gather; backward keeps the own block) and :func:`split_to_model`
(keep the own block; backward all-gathers). Sequence parallelism's
memory split (:class:`SequenceConstraint`) is the last two.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from mmqg_tpu_torch.optim import tree_items, tree_map, tree_map_with_path
from mmqg_tpu_torch.parallel.multihost import all_gather_flat, world

Tensor = torch.Tensor
KeyPath = Tuple
VOCAB_PATH = ("decoder", "out", "w")


# ----------------------------------------------------------- collectives

def gather_along(x: Tensor, dim: int, group) -> Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along
    ``dim`` in rank order: one all-gather. ``x`` itself alone."""
    size = world(group)[1]
    if size == 1:
        return x
    moved = x.detach().movedim(dim, 0).contiguous()
    flat = all_gather_flat(moved.reshape(-1), group)
    return flat.view((size * moved.shape[0],) + moved.shape[1:]).movedim(
        0, dim).contiguous()


def own_block(x: Tensor, dim: int, group) -> Tensor:
    """This rank's block of ``x`` along ``dim`` (its length a multiple of
    the group's size), a view."""
    rank, size = world(group)
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n)


def _check_divides(x: Tensor, dim: int, group) -> None:
    size = world(group)[1]
    if x.shape[dim] % size:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {size} ranks")


def all_reduce_(x: Tensor, group, op=dist.ReduceOp.SUM) -> Tensor:
    """``x`` reduced over ``group`` in place (no autograd); ``x`` alone."""
    if world(group)[1] > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return own_block(g, ctx.dim, ctx.group).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return own_block(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_along(g.contiguous(), ctx.dim, ctx.group), None, None


def copy_to_model(x: Tensor, group) -> Tensor:
    """``x`` as it is, entering a computation split over the model axis:
    each rank's gradient is its part, so the backward sums them."""
    return x if world(group)[1] == 1 else _Copy.apply(x, group)


def reduce_from_model(x: Tensor, group) -> Tensor:
    """The sum over the model group of each rank's part ``x``; its
    backward passes the cotangent, which every rank holds equally, to
    each part."""
    return x if world(group)[1] == 1 else _Reduce.apply(x, group)


def gather_from_model(x: Tensor, dim: int, group) -> Tensor:
    """Every rank's block concatenated along ``dim``; its backward keeps
    this rank's block of the (replicated) cotangent."""
    return x if world(group)[1] == 1 else _Gather.apply(x, dim, group)


def split_to_model(x: Tensor, dim: int, group) -> Tensor:
    """This rank's block of a replicated ``x`` along ``dim``; its backward
    all-gathers the blocks' gradients, so every rank holds the whole
    gradient of ``x``."""
    if world(group)[1] == 1:
        return x
    _check_divides(x, dim, group)
    return _Split.apply(x, dim, group)


# ----------------------------------------------- the column-parallel vocab

class _VocabLogProb(torch.autograd.Function):
    """log softmax over the whole vocabulary at ``target``, from this
    rank's columns of the logits."""

    @staticmethod
    def forward(ctx, local, target, group):
        rank, _ = world(group)
        width = local.shape[-1]
        lo = rank * width
        m = local.detach().amax(dim=-1)
        all_reduce_(m, group, dist.ReduceOp.MAX)
        e = torch.exp(local - m[:, None])
        s = all_reduce_(e.sum(dim=-1), group)
        own = (target >= lo) & (target < lo + width)
        idx = torch.clamp(target - lo, 0, width - 1)
        picked = torch.where(own, local.gather(-1, idx[:, None])[:, 0], 0.0)
        picked = all_reduce_(picked.contiguous(), group)
        ctx.save_for_backward(e / s[:, None], idx, own)
        return picked - (m + torch.log(s))

    @staticmethod
    def backward(ctx, g):
        soft, idx, own = ctx.saved_tensors
        grad = -g[:, None] * soft
        grad.scatter_add_(1, idx[:, None],
                          torch.where(own, g, 0.0)[:, None])
        return grad, None, None


def log_prob(logits: Tensor, target: Tensor, group=None) -> Tensor:
    """``log_softmax(logits)[..., target]`` in float32 for logits of any
    leading shape. With a ``group`` (the column-parallel projection)
    ``logits`` are this rank's columns, rank r holding columns
    ``[r * width, (r + 1) * width)``."""
    lead = logits.shape[:-1]
    target = target.long()
    if group is None or world(group)[1] == 1:
        logp = torch.log_softmax(logits.float(), dim=-1)
        return logp.gather(-1, target[..., None])[..., 0]
    flat = _VocabLogProb.apply(logits.float().reshape(-1, logits.shape[-1]),
                               target.reshape(-1), group)
    return flat.reshape(lead)


def argmax(logits: Tensor, group=None) -> Tensor:
    """The index of the largest logit over the whole vocabulary, the first
    on ties (``torch.argmax``). With a ``group``, ``logits`` are this
    rank's columns: each rank's max and its index, gathered, the largest
    kept (the lowest rank on ties)."""
    if group is None or world(group)[1] == 1:
        return torch.argmax(logits, dim=-1)
    with torch.no_grad():
        rank, _ = world(group)
        width = logits.shape[-1]
        vals = logits.float().amax(dim=-1, keepdim=True)
        idx = torch.argmax(logits, dim=-1, keepdim=True) + rank * width
        vals = gather_along(vals, -1, group)
        idx = gather_along(idx, -1, group)
        win = torch.argmax(vals, dim=-1, keepdim=True)
        return idx.gather(-1, win)[..., 0]


# ------------------------------------------------------- sequence parallel

class SequenceConstraint:
    """Sequence parallelism of a (B, L, H) attention memory over the model
    group: ``constraint(x)`` pads L to a multiple of the group (zeros,
    which the length masks exclude) and keeps this rank's block of it
    (:func:`split_to_model`); ``gather(block, length)`` gives the whole
    memory back, cut to ``length`` (:func:`gather_from_model`). The pair
    is the identity on the values and on the gradients."""

    def __init__(self, group):
        self.group = group
        self.size = world(group)[1]

    def __call__(self, x: Tensor) -> Tensor:
        pad = (-x.shape[1]) % self.size
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        return split_to_model(x, 1, self.group)

    def gather(self, block: Tensor, length: int) -> Tensor:
        return gather_from_model(block, 1, self.group)[:, :length]


# ---------------------------------------------------- tensor-parallel state

def _meta(tree: Any) -> Any:
    """``tree`` with every tensor replaced by an empty one of its shape on
    the meta device: the full shapes the rules are keyed on."""
    return tree_map(lambda x: torch.empty(tuple(x.shape), device="meta"),
                    tree)


class ModelAxis:
    """This rank's share of ``model`` over the model axis of a ``(data,
    model)`` grid: every leaf that ``mesh.param_shardings`` splits holds
    this rank's slice between steps (the parameters' storage is the
    slice). ``dims``: each parameter's split dimension or None, by tree
    path; ``vocab``: whether ``decoder/out/w`` is split, and so projected
    column-parallel.

    :meth:`gathered` makes the split leaves whole for a step or a decode
    (the vocab projection stays split unless asked for); :meth:`own_grads`
    keeps this rank's slice of their gradients. :meth:`shard_tree` and
    :meth:`full_tree` cut and rebuild an optimizer state of the same
    paths, :meth:`host_state` and :meth:`load` the checkpoints'
    whole train state (collectives: every rank calls them)."""

    def __init__(self, model, group, shape: Tuple[int, int]):
        from mmqg_tpu_torch.models import qg_model
        from mmqg_tpu_torch.parallel.mesh import model_dims, param_shardings

        self.model = model
        self.group = group
        self.shape = tuple(shape)
        self.rank, self.size = world(group)
        if self.size != self.shape[1]:
            raise ValueError(f"the model group has {self.size} ranks, the "
                             f"mesh's model axis {self.shape[1]}")
        params = qg_model.param_tree(model)
        param_shardings(params, self.shape)          # the audit raises
        self.param_meta = _meta(params)
        self.dims: Dict[KeyPath, Optional[int]] = dict(
            tree_items(model_dims(params, self.shape)))
        self.shapes = {path: tuple(p.shape) for path, p in tree_items(params)}
        self.split = [(path, p) for path, p in tree_items(params)
                      if self.dims[path] is not None]
        self.vocab = self.dims.get(VOCAB_PATH) is not None
        self.opt_meta = None
        self.opt_dims: Dict[KeyPath, Optional[int]] = {}
        self._held: Dict[KeyPath, Tensor] = {}

    # ---------------------------------------------------------- storage
    def own(self, x: Tensor, d: Optional[int]) -> Tensor:
        return x if d is None else own_block(x, d, self.group)

    def shard_params(self) -> None:
        """Keep this rank's slice of every split parameter (own copies;
        the whole ones are freed) and project the vocabulary
        column-parallel when its matrix is split."""
        with torch.no_grad():
            for path, p in self.split:
                p.data = self.own(p.data, self.dims[path]).clone()
        self.model.decoder.out.column_group = self.group if self.vocab \
            else None
        self.model.tp = self

    def shard_tree(self, tree: Any, *, record: bool = False) -> Any:
        """This rank's slices of a whole optimizer state
        (:func:`shard_params`); ``record`` keeps its dimensions for
        :meth:`full_tree`."""
        if record:
            from mmqg_tpu_torch.parallel.mesh import model_dims
            self.opt_meta = _meta(tree)
            self.opt_dims = dict(tree_items(model_dims(tree, self.shape)))
        return shard_params(tree, self.group, self.shape)

    def full_tree(self, tree: Any) -> Any:
        """The whole optimizer state from every rank's slices (one
        all-gather a split leaf)."""
        return tree_map_with_path(
            lambda path, x: x if self.opt_dims.get(path) is None
            else gather_along(x, self.opt_dims[path], self.group), tree)

    # ----------------------------------------------------------- the step
    def gather(self, vocab: bool = False) -> None:
        """Make the split parameters whole (one all-gather each over the
        model group); the vocab projection too with ``vocab``. Nothing
        for a leaf already whole."""
        for path, p in self.split:
            if path in self._held or (path == VOCAB_PATH and not vocab):
                continue
            self._held[path] = p.data
            p.data = gather_along(p.data, self.dims[path], self.group)

    def release(self) -> None:
        """Back to this rank's slices (the whole copies are freed)."""
        for path, p in self.split:
            if path in self._held:
                p.data = self._held.pop(path)

    @contextlib.contextmanager
    def gathered(self, vocab: bool = False) -> Iterator[None]:
        """The split parameters whole inside the block (a collective)."""
        held = set(self._held)
        self.gather(vocab)
        try:
            yield
        finally:
            for path, p in self.split:
                if path in self._held and path not in held:
                    p.data = self._held.pop(path)

    def own_grads(self, grads: Any) -> Any:
        """This rank's slice of the gradients of the gathered leaves (the
        ranks' replicas computed the same whole gradient); the others'
        as they are."""

        def cut(path, g):
            d = self.dims.get(path)
            if d is None or path not in self._held:
                return g
            return self.own(g, d).contiguous()
        return tree_map_with_path(cut, grads)

    def norm_buckets(self, tree: Any, data_dims: Dict, data_group) -> Tensor:
        """The l2 norm of the whole tree that ``tree`` holds this rank's
        share of: each leaf's sum of squares summed over the axes that
        split it (``data_dims``: the data-axis split of each path, or
        empty)."""
        sq = {(True, True): [], (True, False): [], (False, True): [],
              (False, False): []}
        for path, x in tree_items(tree):
            sq[(data_dims.get(path) is not None,
                self.dims.get(path) is not None)].append(torch.sum(x * x))
        dev = next(x for _, x in tree_items(tree)).device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        part = {k: sum(v, zero) for k, v in sq.items()}
        over_data = torch.stack([part[(True, True)], part[(True, False)]])
        if data_group is not None:      # None: no data axis (not the world)
            all_reduce_(over_data, data_group)
        over_model = all_reduce_(torch.stack(
            [over_data[0], part[(False, True)]]), self.group)
        return torch.sqrt(over_model.sum() + over_data[1]
                          + part[(False, False)])

    # --------------------------------------------------------- checkpoints
    def host_state(self, ts) -> Dict[str, Any]:
        """The whole train state as numpy (``train_state_to_numpy``'s
        layout), on every rank: gathered over the data axis first when it
        splits the state too (``parallel.zero``), then over this axis."""
        from mmqg_tpu_torch.compat.from_jax import train_state_to_numpy

        shards = ts.shards
        opt = shards.full_opt_state(ts.opt_state) if shards is not None \
            else ts.opt_state
        opt = self.full_tree(opt)
        with (shards.gathered() if shards is not None
              else contextlib.nullcontext()), self.gathered(vocab=True):
            return train_state_to_numpy(ts.model, opt, ts.step)

    def load(self, ts, state: Dict[str, Any]) -> None:
        """Copy a whole train state (a checkpoint) into ``ts`` and keep this
        rank's slices, over this axis and then the data axis's."""
        from mmqg_tpu_torch.compat.from_jax import load_train_state
        from mmqg_tpu_torch.models import qg_model

        shards = ts.shards
        for path, p in tree_items(qg_model.param_tree(ts.model)):
            if tuple(p.shape) != self.shapes[path]:
                p.data = torch.empty(self.shapes[path], dtype=p.dtype,
                                     device=p.device)
        opt, ts.step = load_train_state(ts.model, state, ts.opt_state)
        self._held.clear()
        self.shard_params()
        opt = self.shard_tree(opt)
        if shards is None:
            ts.opt_state = opt
            return
        ts.opt_state = shards.shard_opt_state(opt)
        if shards.fsdp:
            shards.take_param_slices()


def shard_params(tree: Any, group, shape: Tuple[int, int]) -> Any:
    """This rank's slice of every leaf of a whole ``tree`` (parameters or
    an optimizer state of the same paths) that ``mesh.param_shardings``
    splits on a ``shape`` mesh, as own copies; the others as they are (JAX's
    ``shard_params``/``shard_params_global``: each process keeps the
    shards it owns). ``group``: the model group."""
    from mmqg_tpu_torch.parallel.mesh import model_dims
    dims = dict(tree_items(model_dims(tree, shape)))
    return tree_map_with_path(
        lambda path, x: x if dims[path] is None
        else own_block(x, dims[path], group).clone(), tree)


def shard(ts, grid) -> ModelAxis:
    """Store ``ts`` (a whole ``train.TrainState``) over the model axis of
    ``grid`` in place: its split parameters and optimizer-state leaves
    become this rank's slices. Returns the ``ModelAxis``, also set as
    ``ts.model.tp``."""
    tp = ModelAxis(ts.model, grid.model_group, grid.shape)
    ts.opt_state = tp.shard_tree(ts.opt_state, record=True)
    tp.shard_params()
    return tp


@contextlib.contextmanager
def whole(model) -> Iterator[None]:
    """The model's split leaves gathered inside the block when it is
    stored over a model axis (``model.tp``; the vocab projection stays
    column-parallel); nothing otherwise."""
    tp = getattr(model, "tp", None)
    if tp is None:
        yield
        return
    with tp.gathered():
        yield
