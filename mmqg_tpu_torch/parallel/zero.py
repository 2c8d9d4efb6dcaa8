"""ZeRO-1 and FSDP over the data axis, on the one-process-per-device runtime
(``mmqg_tpu/parallel/mesh.py:227-302``, ``mmqg_tpu/train.py:399-470``).

The JAX package places the optimizer state (ZeRO-1) and the parameters
(FSDP) on its mesh split over "data"; GSPMD reduce-scatters the gradients
into that layout, updates each device's shard and all-gathers the
parameters: after the update (ZeRO-1), or at each use inside the step
(FSDP). The port makes those collectives itself (``parallel.multihost``):

* :func:`shard` keeps this process's slice of every optimizer-state leaf
  that ``mesh.zero1_shardings`` splits -- and, with FSDP, of every
  parameter that ``mesh.fsdp_shardings`` splits, the parameters' storage
  freed between steps. A leaf the rule leaves whole stays whole.
* The train step (``train.make_train_step(zero1=, fsdp=)``) gathers the
  parameters at its start (FSDP), reduce-scatters the split leaves'
  gradients as one flat bucket and all-reduces the whole leaves', runs
  the optimizer on the slices -- its global-norm clip and the
  ``grad_norm`` metric sum every process's slices
  (:meth:`Shards.global_norm`) -- and then all-gathers the updated slices
  into the parameters (ZeRO-1) or keeps them and frees the parameters
  (FSDP).
* :meth:`Shards.host_state` gathers the whole train state for a
  checkpoint (a collective: every process calls it); :meth:`Shards.load`
  keeps this process's slices of a loaded one.

FSDP here gathers every parameter once a step and holds it for the whole
step, where GSPMD gathers each weight at its use: between steps a process
holds about 1/dp of the parameters and moments, during a step all the
parameters. The batchnorm running statistics and the step stay whole on
every process. Without a data axis (one process) nothing is sharded, as
in the JAX package.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from mmqg_tpu_torch.compat.from_jax import (load_train_state,
                                            train_state_to_numpy)
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.optim import (tree_items, tree_leaves,
                                  tree_map_with_path)
from mmqg_tpu_torch.parallel import multihost
from mmqg_tpu_torch.parallel.mesh import fsdp_shardings, zero1_shardings

Tensor = torch.Tensor
KeyPath = Tuple


def _slice_shape(shape, d: int, dp: int) -> Tuple[int, ...]:
    out = list(shape)
    out[d] //= dp
    return tuple(out)


def _blocks(x: Tensor, d: int, dp: int) -> Tensor:
    """A view of ``x`` as (dp, ...): index r is process r's slice along
    dimension ``d``."""
    return x.unflatten(d, (dp, x.shape[d] // dp)).movedim(d, 0)


def _unblocks(rows: Tensor, shape, d: int, dp: int) -> Tensor:
    """``rows`` (dp, m): process r's slice, flattened, in row r -> the
    whole tensor of ``shape``."""
    return rows.reshape((dp,) + _slice_shape(shape, d, dp)).movedim(
        0, d).reshape(shape)


def _own_slice(x: Tensor, d: int, rank: int, dp: int) -> Tensor:
    n = x.shape[d] // dp
    return x.detach().narrow(d, rank * n, n)


class Shards:
    """This process's share of a train state split over the data axis of
    ``group``: the split dimension of every parameter and optimizer-state
    leaf (by tree path), and with FSDP the parameters' slices."""

    def __init__(self, params: Dict, opt_state: Any, group, *, fsdp: bool,
                 model_axis=None):
        self.group = group
        self.rank, self.dp = multihost.world(group)
        self.fsdp = fsdp
        self.params = params
        # on a model axis the rule is keyed on the whole leaves' shapes,
        # and the slices split here are the model axis's
        shape, pmeta, ometa = (self.dp, 1), params, opt_state
        if model_axis is not None:
            shape = (self.dp, model_axis.size)
            pmeta, ometa = model_axis.param_meta, model_axis.opt_meta
        self.param_dims = dict(tree_items(fsdp_shardings(pmeta, shape)))
        self.shapes = {path: tuple(p.shape) for path, p in tree_items(params)}
        self.opt_dims = dict(tree_items(zero1_shardings(ometa, shape)))
        self.opt_shapes = {path: tuple(x.shape)
                           for path, x in tree_items(opt_state)}
        for path, d in self.opt_dims.items():
            mirror = self._param_path(path)
            if mirror is not None and self.param_dims[mirror] != d \
                    and self.opt_shapes[path] == self.shapes[mirror]:
                raise ValueError(f"optimizer state {path} splits dimension "
                                 f"{d}, its parameter {mirror} "
                                 f"{self.param_dims[mirror]}")
        self.split = [(path, p) for path, p in tree_items(params)
                      if self.param_dims[path] is not None]
        self.slices: Dict[KeyPath, Tensor] = {}
        self.gathered_now = True

    def _param_path(self, path: KeyPath) -> Optional[KeyPath]:
        """The parameter an optimizer-state path mirrors ("0/mu/<param>"),
        or None (a count)."""
        for i in range(len(path)):
            if path[i:] in self.param_dims:
                return path[i:]
        return None

    # ---------------------------------------------------- the optimizer
    def shard_opt_state(self, opt_state: Any) -> Any:
        """This process's slices of a whole optimizer state (own copies:
        the whole leaves can be freed)."""
        def cut(path, x):
            d = self.opt_dims[path]
            return x if d is None else _own_slice(x, d, self.rank,
                                                  self.dp).clone()
        return tree_map_with_path(cut, opt_state)

    def full_opt_state(self, opt_state: Any) -> Any:
        """The whole optimizer state from every process's slices (one
        all-gather; every process calls it)."""
        split = [(path, x) for path, x in tree_items(opt_state)
                 if self.opt_dims[path] is not None]
        whole = self._all_gather([x for _, x in split])
        full = {path: _unblocks(rows, self.opt_shapes[path],
                                self.opt_dims[path], self.dp)
                for (path, _), rows in zip(split, whole)}
        return tree_map_with_path(lambda path, x: full.get(path, x),
                                  opt_state)

    def _all_gather(self, slices: List[Tensor]) -> List[Tensor]:
        """Each of ``slices`` (this process's) as (dp, its numel): every
        process's, one all-gather for them all."""
        if not slices:
            return []
        flat = torch.cat([s.reshape(-1) for s in slices])
        rows = multihost.all_gather_flat(flat, self.group).view(self.dp, -1)
        out, i = [], 0
        for s in slices:
            out.append(rows[:, i:i + s.numel()])
            i += s.numel()
        return out

    # ------------------------------------------------------- the step
    def reduce_scatter(self, grads: Dict) -> Dict:
        """The gradients summed over the processes, in the update's layout:
        this process's slice of each split leaf (one reduce-scatter of them
        all, as one flat bucket) and each whole leaf whole (one
        all-reduce)."""
        items = tree_items(grads)
        split = [(path, g) for path, g in items
                 if self.param_dims[path] is not None]
        out = {}
        if split:
            sizes = [g.numel() // self.dp for _, g in split]
            buf = torch.empty((self.dp, sum(sizes)), dtype=split[0][1].dtype,
                              device=split[0][1].device)
            i = 0
            for (path, g), m in zip(split, sizes):
                d = self.param_dims[path]
                buf[:, i:i + m].view((self.dp,) + _slice_shape(
                    g.shape, d, self.dp)).copy_(_blocks(g, d, self.dp))
                i += m
            mine = multihost.reduce_scatter_flat(buf.view(-1), self.group)
            i = 0
            for (path, g), m in zip(split, sizes):
                out[path] = mine[i:i + m].view(_slice_shape(
                    g.shape, self.param_dims[path], self.dp))
                i += m
        whole = [(path, g) for path, g in items
                 if self.param_dims[path] is None]
        for (path, _), s in zip(whole, multihost.all_reduce_flat(
                [g for _, g in whole], self.group)):
            out[path] = s
        return tree_map_with_path(lambda path, _: out[path], grads)

    def global_norm(self, tree: Any) -> Tensor:
        """The l2 norm of the whole tree that ``tree`` (the parameters'
        structure, masked-out leaves empty) holds this process's share of:
        the sum of squares of every process's slices (one all-reduce), plus
        each whole leaf once."""
        split, whole = [], []
        tree_map_with_path(
            lambda path, x: (split if self.param_dims.get(path) is not None
                             else whole).append(x), tree)
        dev = (split + whole)[0].device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        mine = sum((torch.sum(x * x) for x in split), zero)
        total, = multihost.all_reduce_flat([mine], self.group)
        return torch.sqrt(total + sum((torch.sum(x * x) for x in whole),
                                      zero))

    def param_slices(self) -> Dict:
        """The parameters the update takes and writes, in place: this
        process's slice of each split leaf (FSDP: the held slice; ZeRO-1: a
        view into the parameter) and each whole leaf itself."""
        def pick(path, p):
            d = self.param_dims[path]
            if d is None:
                return p
            return (self.slices[path] if self.fsdp
                    else _own_slice(p, d, self.rank, self.dp))
        return tree_map_with_path(pick, self.params)

    def publish(self) -> None:
        """After the update: ZeRO-1 all-gathers the updated slices into
        the parameters; FSDP frees the parameters, keeping the slices."""
        if self.fsdp:
            self.free_params()
        else:
            self._gather_into_params(
                [_own_slice(p, self.param_dims[path], self.rank, self.dp)
                 for path, p in self.split])

    def _gather_into_params(self, slices: List[Tensor]) -> None:
        with torch.no_grad():
            for (path, p), rows in zip(self.split, self._all_gather(slices)):
                full = _unblocks(rows, self.shapes[path],
                                 self.param_dims[path], self.dp)
                if p.numel() == 0:
                    p.data = full
                else:
                    p.copy_(full)

    # ----------------------------------------------------------- FSDP
    def take_param_slices(self) -> None:
        """FSDP: keep this process's slice of each split parameter (own
        copies) and free the parameters."""
        self.slices = {path: _own_slice(p, self.param_dims[path], self.rank,
                                        self.dp).clone()
                       for path, p in self.split}
        self.free_params()

    def gather_params(self) -> None:
        """FSDP: the whole parameters from every process's slices (one
        all-gather); nothing when they are gathered already."""
        if self.fsdp and not self.gathered_now:
            self._gather_into_params([self.slices[path]
                                      for path, _ in self.split])
            self.gathered_now = True

    def free_params(self) -> None:
        """FSDP: the split parameters' storage released (each becomes an
        empty tensor); their slices stay."""
        for _, p in self.split:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.gathered_now = False

    @contextlib.contextmanager
    def gathered(self) -> Iterator[None]:
        """The whole parameters inside the block (FSDP: gathered, then
        freed; a collective); ZeRO-1 always holds them."""
        if not self.fsdp or self.gathered_now:
            yield
            return
        self.gather_params()
        try:
            yield
        finally:
            self.free_params()

    # ---------------------------------------------------- checkpoints
    def host_state(self, ts) -> Dict[str, Any]:
        """The whole train state as numpy (``train_state_to_numpy``'s
        layout), gathered on every process: a collective."""
        opt_state = self.full_opt_state(ts.opt_state)
        with self.gathered():
            return train_state_to_numpy(ts.model, opt_state, ts.step)

    def load(self, ts, state: Dict[str, Any]) -> None:
        """Copy a whole train state (a checkpoint) into ``ts``, keeping
        this process's slices."""
        if self.fsdp:
            for path, p in self.split:
                p.data = torch.empty(self.shapes[path], dtype=p.dtype,
                                     device=p.device)
        opt_state, ts.step = load_train_state(ts.model, state, ts.opt_state)
        ts.opt_state = self.shard_opt_state(opt_state)
        if self.fsdp:
            self.take_param_slices()


def shard(ts, group, *, fsdp: bool = False) -> Shards:
    """Split ``ts`` (a whole ``train.TrainState``, or one stored over a
    model axis, ``model_axis.shard``: its slices are split further, by the
    rule on the whole leaves) over the data axis of ``group`` in place:
    its optimizer state becomes this process's slices and, with ``fsdp``,
    its split parameters are freed, their slices kept. Returns the
    ``Shards``, also set as ``ts.shards``."""
    shards = Shards(qg_model.param_tree(ts.model), ts.opt_state, group,
                    fsdp=fsdp, model_axis=ts.model.tp)
    ts.opt_state = shards.shard_opt_state(ts.opt_state)
    if fsdp:
        shards.take_param_slices()
    ts.shards = shards
    return shards


def held_bytes(ts) -> Dict[str, int]:
    """Bytes this process holds of ``ts``: the optimizer state's leaves and
    the parameters' storage (FSDP: the held slices, the parameters freed
    between steps)."""
    def size(xs):
        return sum(x.numel() * x.element_size() for x in xs)
    params = size(tree_leaves(qg_model.param_tree(ts.model)))
    if ts.shards is not None and ts.shards.fsdp:
        params += size(ts.shards.slices.values())
    return {"opt_state": size(tree_leaves(ts.opt_state)), "params": params}


def rule_bytes(tree: Any, dims: Any, dp: int) -> int:
    """Bytes of one process's share of ``tree`` under a split rule
    (``mesh.zero1_shardings`` / ``fsdp_shardings``): a split leaf's
    1/dp, a whole leaf's all."""
    total = 0
    for (_, x), (_, d) in zip(tree_items(tree), tree_items(dims)):
        n = math.prod(x.shape)
        total += (n // dp if d is not None else n) * x.element_size()
    return total


def grid_rule_bytes(tree: Any, mesh, *, data: bool = True) -> int:
    """Bytes of one process's share of ``tree`` (whole leaves) on a
    ``(data, model)`` mesh: each leaf over the product of the axes its
    spec names (``mesh.grid_specs``; ``data=False``: the model axis's
    ``param_shardings`` alone)."""
    from mmqg_tpu_torch.parallel.mesh import (grid_specs, mesh_shape,
                                              param_shardings)
    sizes = dict(zip(("data", "model"), mesh_shape(mesh)))
    specs = (grid_specs(tree, mesh) if data
             else param_shardings(tree, mesh, audit=False))
    total = 0
    for (path, x) in tree_items(tree):
        spec = specs
        for k in path:
            spec = spec[k]
        split = math.prod(sizes[a] for a in spec if a is not None)
        total += math.prod(x.shape) // split * x.element_size()
    return total
