"""The device mesh, its batch rules, the tensor-parallel rules of the model
axis and the ZeRO-1/FSDP rule of the data axis
(``mmqg_tpu/parallel/mesh.py``).

A :class:`Mesh` is a ``(data, model)`` array of ``torch.device``s. Serving
and evaluation run one model replica per row of the data axis
(``parallel/replicas.py``): every request batch is padded to a multiple of
the axis (:func:`pad_batch`) and cut into contiguous row blocks
(:func:`row_block`), the first block on the first row. Training runs one
process per device, the processes forming the same grid
(``multihost.Grid``).

The model axis stores each parameter leaf as JAX's ``param_shardings``
splits it (:func:`param_shardings`: the LSTM gate matrices and the vocab
projection by columns, the attention location heads by rows, the dense
layers and the conv kernels by output features; a dimension that does not
divide stays whole), checked by :func:`audit_tp_coverage`.
:func:`zero1_shardings` and :func:`fsdp_shardings` say which dimension
of each leaf is split over the data axis on top of that
(``parallel/zero.py`` holds the slices). How the split leaves are used is
``parallel/model_axis.py``'s; sequence parallelism is
:func:`sequence_constraint` and :func:`sp_greedy_decode`.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mmqg_tpu_torch.optim import tree_map_with_path

AXIS_NAMES = ("data", "model")
Spec = Tuple[Optional[str], ...]


class Mesh:
    """A ``(data, model)`` array of devices (``devices``, a numpy object
    array) with its ``axis_names``."""

    def __init__(self, devices: np.ndarray,
                 axis_names: Tuple[str, str] = AXIS_NAMES):
        if tuple(axis_names) != AXIS_NAMES:
            raise ValueError(f"axis_names must be {AXIS_NAMES}: the data "
                             f"rules name those axes, got {axis_names}")
        if devices.ndim != 2:
            raise ValueError(f"a (data, model) device array, got shape "
                             f"{devices.shape}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> list:
        """The first device of each row of the data axis, in row-block
        order: where that row's replica computes."""
        return list(self.devices[:, 0])

    def row(self, r: int) -> list:
        """The devices of row ``r`` of the data axis (its model axis)."""
        return list(self.devices[r])

    @property
    def dp(self) -> int:
        return self.devices.shape[0]

    @property
    def tp(self) -> int:
        return self.devices.shape[1]

    def __repr__(self) -> str:
        rows = [[str(d) for d in r] for r in self.devices]
        return f"Mesh({self.shape}, {rows})"


def visible_devices() -> list:
    """Every visible CUDA device, in index order. None visible raises:
    a mesh on the CPU names its devices (``make_mesh(devices=["cpu",
    "cpu"])``), as every entry point of the port runs on the card unless
    asked for the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible (torch.cuda"
                           ".is_available() is False); pass the devices, "
                           "e.g. devices=['cpu', 'cpu'], for a CPU mesh")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` (default: every visible
    card, :func:`visible_devices`), row-major (device i at
    ``(i // model, i % model)``, as JAX's ``make_mesh``). ``shape=None``
    puts every device on the data axis. A device may appear more than
    once: two positions on one card exercise the split and the merge, not
    scaling."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else visible_devices())]
    if shape is None:
        shape = (len(devs), 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != len(devs):
        raise ValueError(f"mesh shape {shape} != {len(devs)} devices")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape))


def mesh_shape(mesh: Union[Mesh, int, Tuple[int, int]]) -> Tuple[int, int]:
    """(data, model) of a Mesh, a ``(data, model)`` pair, or a data-axis
    size (model 1)."""
    if isinstance(mesh, Mesh):
        return mesh.dp, mesh.tp
    if isinstance(mesh, (tuple, list)):
        return int(mesh[0]), int(mesh[1])
    return int(mesh), 1


def padded_rows(rows: int, dp: int) -> int:
    """``rows`` rounded up to a multiple of ``dp``."""
    return -(-rows // dp) * dp


def pad_batch(batch: Dict[str, np.ndarray], dp: int) -> Dict[str, np.ndarray]:
    """Pad a host batch to a multiple of ``dp`` rows: padded rows are zeros
    with ``valid=False`` and ``frames_len``, ``target_len`` and
    ``context_len`` of 1 (the JAX package's ``pad_and_shard_batch``). The
    rows before them are untouched, so outputs trim back to the input's
    rows. Non-array entries are dropped, as there; a batch that needs no
    padding is returned as it is."""
    arrays = {k: v for k, v in batch.items() if hasattr(v, "ndim")}
    n = len(arrays["valid"]) if "valid" in arrays else \
        len(next(iter(arrays.values())))
    pad = (-n) % dp
    if not pad:
        return arrays
    out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
           for k, v in arrays.items()}
    if "valid" in out:
        out["valid"][n:] = False
    for key in ("frames_len", "target_len", "context_len"):
        if key in out:
            out[key][n:] = 1
    return out


def row_block(rank: int, dp: int, rows: int) -> Tuple[int, int]:
    """[start, stop) of the rows that data-axis position ``rank`` owns in a
    batch of ``rows`` (a multiple of ``dp``): contiguous blocks in rank
    order, the process-major order of the JAX package's
    ``assemble_global_batch``."""
    if rows % dp:
        raise ValueError(f"{rows} rows do not split over {dp} devices; pad "
                         "them first (pad_batch)")
    if not 0 <= rank < dp:
        raise ValueError(f"rank {rank} outside a data axis of {dp}")
    b = rows // dp
    return rank * b, (rank + 1) * b


def data_parallel_mesh(config, devices: Sequence, log=print
                       ) -> Optional[Mesh]:
    """The mesh of a ``--data-parallel`` run over ``devices``, as the JAX
    CLIs build it: ``config.mesh_shape`` (1, 1) puts every device on the
    data axis, another ``(data, model)`` shape is taken as it is. With one
    device it logs the JAX package's warning and returns None (run
    single-device)."""
    if len(devices) < 2:
        log("warning: --data-parallel requested but only one device is "
            "visible; running single-device")
        return None
    if tuple(config.mesh_axis_names) != AXIS_NAMES:
        raise SystemExit("mesh_axis_names must stay ('data', 'model'): the "
                         "sharding rules (parallel/mesh.py) name those axes")
    shape = tuple(config.mesh_shape)
    mesh = make_mesh(None if shape == (1, 1) else shape, devices=devices)
    log(f"data-parallel over {len(devices)} devices (mesh {mesh.shape})")
    return mesh


# ---------------------------------------------------------------- param rules

def _path(path) -> str:
    return "/".join(str(k) for k in path)


def _spec_for(path: str, leaf) -> Spec:
    """The partition spec of one parameter leaf, keyed by its tree path
    ("decoder/attn/w_text"; JAX's ``mesh.py::_spec_for``): the LSTM gate
    matrices and the vocab projection by columns, the attention location
    heads by rows (their output is the prime context/AV length), the dense
    layers and the conv kernels (2-d and 3-d) by output features; vectors
    and the embedding table whole."""
    if not hasattr(leaf, "ndim") or leaf.ndim < 2:
        return ()
    if re.search(r"lstm.*(wx|wh)$", path):
        return (None, "model")
    if re.search(r"attn/w_", path):
        return ("model", None)
    if re.search(r"out.*w", path) or path.endswith("out/w"):
        return (None, "model")
    if re.search(r"fc\d?/w$", path):
        return (None, "model")
    if leaf.ndim == 4:
        return (None, None, None, "model")
    if leaf.ndim == 5:
        return (None, None, None, None, "model")
    return ()


# big-and-whole is deliberate only for the shared embedding table (gathered
# by ids everywhere) and its optimizer state; any other leaf of 2+ dims at
# or above the size floor must get a model-axis spec (JAX's allowlist)
_TP_REPLICATED_OK = re.compile(r"embedding")
_TP_AUDIT_MIN_ELEMENTS = 4096


def audit_tp_coverage(params: Any, mesh, *,
                      min_elements: int = _TP_AUDIT_MIN_ELEMENTS) -> list:
    """The paths (with shapes) of the leaves of 2+ dims and at least
    ``min_elements`` elements that the rules leave whole on a mesh whose
    model axis is larger than 1 and that are not allowlisted (JAX's
    ``audit_tp_coverage``). Empty: full coverage."""
    if mesh_shape(mesh)[1] <= 1:
        return []
    bad = []

    def visit(path, leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 2 \
                and math.prod(leaf.shape) >= min_elements:
            p = _path(path)
            if all(s is None for s in _spec_for(p, leaf)) \
                    and not _TP_REPLICATED_OK.search(p):
                bad.append(f"{p} {tuple(leaf.shape)}")
    tree_map_with_path(visit, params)
    return bad


def _model_spec(path, leaf, sizes: Dict[str, int]) -> Spec:
    """One leaf's spec: the rule's, a dimension that does not divide by its
    axis's size left whole."""
    if not hasattr(leaf, "ndim"):
        return ()
    rule = _spec_for(_path(path), leaf)
    return tuple(None if name is not None
                 and leaf.shape[d] % sizes.get(name, 1) else name
                 for d, name in enumerate(rule))


def param_shardings(params: Any, mesh, *, audit: bool = True) -> Any:
    """Each leaf's partition spec on ``mesh`` (a Mesh or a ``(data,
    model)`` shape), a tuple of axis names or None per dimension, as JAX's
    ``param_shardings``: the rule's spec, with a dimension that does not
    divide by its axis's size left whole. ``audit``: on a model axis
    larger than 1, raise if a big matrix fell through the rules to whole
    (:func:`audit_tp_coverage`) with JAX's message."""
    if audit:
        bad = audit_tp_coverage(params, mesh)
        if bad:
            raise ValueError(
                "TP rules left big matrices fully replicated on a model-"
                "parallel mesh (rename drift? add a rule in _spec_for or "
                "allowlist in _TP_REPLICATED_OK): " + ", ".join(bad))
    sizes = dict(zip(AXIS_NAMES, mesh_shape(mesh)))
    return tree_map_with_path(lambda path, x: _model_spec(path, x, sizes),
                              params)


def model_dims(tree: Any, mesh) -> Any:
    """For each leaf, the dimension :func:`param_shardings` splits over the
    model axis, or None (a model axis of 1 splits nothing)."""
    sizes = dict(zip(AXIS_NAMES, mesh_shape(mesh)))

    def dim(path, leaf):
        spec = _model_spec(path, leaf, sizes)
        return (spec.index("model") if sizes["model"] > 1
                and "model" in spec else None)
    return tree_map_with_path(dim, tree)


# ------------------------------------------- ZeRO-1 / FSDP (state over "data")

def _grid_spec(path, leaf, sizes: Dict[str, int]) -> Spec:
    dp = sizes["data"]
    if not hasattr(leaf, "ndim"):
        return ()
    spec = _model_spec(path, leaf, sizes)
    spec = spec + (None,) * (leaf.ndim - len(spec))
    if dp > 1:
        for d in range(leaf.ndim):
            if spec[d] is None and leaf.shape[d] % dp == 0 \
                    and leaf.shape[d] >= dp:
                return spec[:d] + ("data",) + spec[d + 1:]
    return spec


def grid_specs(tree: Any, mesh) -> Any:
    """Each leaf's spec with the data axis added, JAX's
    ``_widen_over_data``: from :func:`param_shardings`, the first
    dimension left free that divides by the data axis's size dp (and is at
    least dp) is split over "data". Scalars (Adam's ``count``), leaves
    that do not divide and every leaf of a one-device data axis keep their
    model spec. Returned padded to the leaf's rank."""
    sizes = dict(zip(AXIS_NAMES, mesh_shape(mesh)))
    return tree_map_with_path(lambda path, x: _grid_spec(path, x, sizes),
                              tree)


def _widen_over_data(tree: Any, mesh) -> Any:
    """For each leaf of ``tree`` (dicts and lists of tensors or arrays),
    the dimension :func:`grid_specs` splits over the data axis, or None.
    ``mesh``: a Mesh, a ``(data, model)`` shape, or dp (model 1)."""
    sizes = dict(zip(AXIS_NAMES, mesh_shape(mesh)))

    def dim(path, leaf):
        spec = _grid_spec(path, leaf, sizes)
        return spec.index("data") if "data" in spec else None
    return tree_map_with_path(dim, tree)


def zero1_shardings(opt_state: Any, mesh) -> Any:
    """ZeRO-1: the split dimension of each optimizer-state leaf over the
    data axis (``mesh.py::zero1_shardings``). Adam's moments are
    elementwise consumers of the gradient, so each process of the data
    axis owns 1/dp of every moment; the gradients are reduce-scattered
    into that layout and the updated parameters all-gathered
    (``parallel/zero.py``). On a model axis larger than 1 the dimension
    the model axis splits is never the data one."""
    return _widen_over_data(opt_state, mesh)


def fsdp_shardings(params: Any, mesh) -> Any:
    """FSDP: the split dimension of each parameter leaf over the data axis
    (``mesh.py::fsdp_shardings``), the same rule as ZeRO-1's, so the
    parameter and moment slices line up leaf for leaf."""
    return _widen_over_data(params, mesh)


# ------------------------------------------------------- sequence parallelism

def sequence_constraint(grid):
    """Sequence parallelism of the text attention memory over the model
    axis of ``grid`` (a ``multihost.Grid``; JAX's ``sequence_constraint``,
    a sharding annotation there): a callable that keeps this rank's block
    of the context axis of a (B, L, H) memory, L zero-padded to a
    multiple of the axis (283 is prime, as ``ops/attention_sp.py``
    pads), and whose ``gather(block, length)`` gives the whole memory
    back (one all-gather; see ``model_axis.SequenceConstraint``)."""
    from mmqg_tpu_torch.parallel.model_axis import SequenceConstraint
    return SequenceConstraint(grid.model_group)


def sp_greedy_decode(model, mc, batch: Dict[str, torch.Tensor], grid, *,
                     max_len: int = 4, gather_free: bool = False,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Greedy decode with the text attention memory split over the model
    axis of ``grid`` (sequence parallelism; JAX's ``sp_greedy_decode``).
    Every rank of a model group calls it on its data row's batch and gets
    the tokens of the unsharded ``decode.decode_batch``.

    The memory is encoded whole, and each rank keeps its block of the
    context axis (:func:`sequence_constraint`). ``gather_free`` runs the
    attention as ``ops.attention_sp.trimodal_attention_sp``, the
    distributed two-pass softmax whose per-step communication is O(B·H)
    whatever the context length; otherwise the memory is gathered once,
    before the first step, and the decoder's attention reads it whole.
    A model stored over the model axis (``model.tp``, tensor parallelism)
    gathers its split leaves for the decode and projects the vocabulary
    column-parallel (``parallel/model_axis.py``)."""
    from functools import partial

    from mmqg_tpu_torch import decode as DEC
    from mmqg_tpu_torch.parallel import model_axis
    from mmqg_tpu_torch.ops.attention_sp import trimodal_attention_sp

    constrain = sequence_constraint(grid)
    with torch.no_grad(), model_axis.whole(model):
        mem, dec_state = DEC.encode(model, mc, batch, dtype=dtype)
        length = mem.enc_text.shape[1]
        mem = mem._replace(enc_text=constrain(mem.enc_text))
        attn_fn = None
        if gather_free:
            attn_fn = partial(trimodal_attention_sp, group=grid.model_group)
        else:
            mem = mem._replace(enc_text=constrain.gather(mem.enc_text,
                                                         length))
        return DEC.decode_from_memories(model, mem, dec_state,
                                        strategy="greedy", max_len=max_len,
                                        dtype=dtype, attn_fn=attn_fn)
