"""One model replica per device of a mesh's data axis, for serving and
evaluation in one process (``QGPipeline.shard``, ``evaluate --data-parallel``;
the JAX package places the parameters replicated on the mesh and lets XLA
split the batch).

Each request batch is padded to the data axis (``mesh.pad_batch``) and cut
into contiguous row blocks (``mesh.row_block``); block r is encoded and
decoded on device r. One dispatch thread enqueues the blocks one after
another and the caller returns at once: the launches are asynchronous, so
the devices overlap, and the decode is a host loop of small launches
that a thread per replica would only run slower, each waiting for the
interpreter lock (on four H100s, 37 requests: 272-283 ms a generate()
with one dispatch thread, 528-660 ms with a thread per replica). Even
so, sharding buys no questions/s while the decode is host-bound, since
one interpreter pays every replica's launches: the same 37 requests take
221-242 ms on one card. The blocks' outputs come back in row order.
Encode and decode are row-independent in inference (batchnorm takes its
running statistics), so a replica's rows equal those rows of one program
over the whole batch, given the same AV bucket caps: the caller computes
them from the host arrays of the whole batch before the split, as the JAX
package does. On CUDA each replica has a stream of its own, so two
replicas on one card do not share the kernels' per-stream scratch.

On a mesh with a model axis larger than 1 there is one replica per row of
the data axis, built from the model's weights; each leaf that
``mesh.param_shardings`` splits is stored as slices over the row's devices
(:class:`RowStore`), gathered onto the row's first device once per block
(device-to-device copies) and freed after: ``model_axis``'s gather at use,
in one process. The replica then runs whole on that device, its kernels as
they are, with the tokens of the unsharded model.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, contextmanager
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

from mmqg_tpu_torch.compat.from_jax import params_from_numpy, tree_to_numpy
from mmqg_tpu_torch.models import qg_model
from mmqg_tpu_torch.optim import tree_items
from mmqg_tpu_torch.parallel.mesh import (Mesh, model_dims, pad_batch,
                                          param_shardings, row_block)

# fn(model, batch tensors on its device, first row, padded batch rows)
BlockFn = Callable[[qg_model.QGModel, Dict[str, torch.Tensor], int, int],
                   torch.Tensor]


class RowStore:
    """A replica's split leaves stored over the devices of its row of the
    mesh: slice j of each leaf (``mesh.param_shardings`` on the row's
    model axis) on device j, the leaf itself empty between
    :meth:`gathered` blocks, in which it is whole on the replica's device."""

    def __init__(self, model: qg_model.QGModel, devices: List[torch.device]):
        shape = (1, len(devices))
        params = qg_model.param_tree(model)
        param_shardings(params, shape)               # the audit raises
        dims = dict(tree_items(model_dims(params, shape)))
        self.split = [(p, dims[path]) for path, p in tree_items(params)
                      if dims[path] is not None]
        self.slices = []
        for p, d in self.split:
            n = p.shape[d] // len(devices)
            self.slices.append([p.detach().narrow(d, j * n, n).to(dev,
                                                                copy=True)
                                for j, dev in enumerate(devices)])
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def held_bytes(self) -> List[int]:
        """Bytes of the split leaves each device of the row holds between
        blocks."""
        out = [0] * len(self.slices[0]) if self.slices else []
        for parts in self.slices:
            for j, s in enumerate(parts):
                out[j] += s.numel() * s.element_size()
        return out

    @contextmanager
    def gathered(self) -> Iterator[None]:
        """The split leaves whole on the replica's device inside the block,
        freed after."""
        for (p, d), parts in zip(self.split, self.slices):
            p.data = torch.cat([s.to(p.device) for s in parts], dim=d)
        try:
            yield
        finally:
            for p, _ in self.split:
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)


class Replicas:
    """``model`` on every row of ``mesh``'s data axis. Without a model axis
    the model itself serves as the replica on its own device (the first
    such position); every other position gets a copy built from its
    weights (``compat.from_jax``). With one, every row gets a copy, its
    split leaves stored over the row's devices (:class:`RowStore`), and
    the model stays as it is."""

    def __init__(self, model: qg_model.QGModel, mesh: Mesh):
        self.mesh = mesh
        home = model.embedding.device
        params = tree_to_numpy(qg_model.param_tree(model))
        state = tree_to_numpy(qg_model.model_state(model))
        self.models: List[qg_model.QGModel] = []
        for dev in mesh.data_devices:
            if dev == home and model not in self.models and mesh.tp == 1:
                self.models.append(model)
            else:
                self.models.append(params_from_numpy(params, state, dev))
        self.stores = ([RowStore(m, mesh.row(r))
                        for r, m in enumerate(self.models)]
                       if mesh.tp > 1 else None)
        self.streams = []
        for dev in mesh.data_devices:
            if dev.type == "cuda":
                # the kernel library is built here, not by racing threads
                from mmqg_tpu_torch.ops import _build
                _build.library()
                self.streams.append(torch.cuda.Stream(device=dev))
                torch.cuda.synchronize(dev)
            else:
                self.streams.append(None)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="replicas")

    def map(self, fn: BlockFn, host: Dict[str, np.ndarray],
            owned: bool = False) -> Callable[[], np.ndarray]:
        """Pad ``host`` to the data axis, enqueue ``fn`` on each row block
        and its replica from the dispatch thread, and return a
        zero-argument gather: it waits
        for every block and returns their outputs (numpy) concatenated in
        row order, the padded rows included. ``fn`` gets the block's
        tensors on its device, the block's first row and the padded rows.

        The dispatch thread reads a block after map returns, when the
        caller may have refilled its arrays (the streaming loader's
        rotating buffers), so the blocks of the caller's own arrays are
        copied here; ``owned=True`` hands the arrays over instead (the
        caller never writes them again), and padding makes new ones."""
        dp = self.mesh.dp
        padded = pad_batch(host, dp)
        total = len(next(iter(padded.values())))
        copy = {k: not owned and v is host[k] for k, v in padded.items()}
        futures = []
        for r in range(dp):
            lo, hi = row_block(r, dp, total)
            block = {k: v[lo:hi].copy() if copy[k] else v[lo:hi]
                     for k, v in padded.items()}
            futures.append(self._pool.submit(self._run, r, fn, block, lo,
                                             total))

        def gather() -> np.ndarray:
            # every future is read, so a failing block raises here
            finishers = [f.result() for f in futures]
            return np.concatenate([finish() for finish in finishers])
        return gather

    def close(self) -> None:
        """Stop the worker threads once their blocks are done."""
        self._pool.shutdown(wait=True)

    def _run(self, r: int, fn: BlockFn, block: Dict[str, np.ndarray],
             lo: int, total: int) -> Callable[[], np.ndarray]:
        dev, stream = self.mesh.data_devices[r], self.streams[r]
        with ExitStack() as ctx:
            if stream is not None:
                ctx.enter_context(torch.cuda.device(dev))
                ctx.enter_context(torch.cuda.stream(stream))
            tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                       for k, v in block.items()}
            if self.stores is not None:
                ctx.enter_context(self.stores[r].gathered())
            out = fn(self.models[r], tensors, lo, total)
            if stream is None:
                cpu = out.numpy()
                return lambda: cpu
            # the copy and an event go on this replica's stream: the gather
            # waits for this block alone
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)

        def finish() -> np.ndarray:
            done.synchronize()
            return host.numpy()
        return finish
