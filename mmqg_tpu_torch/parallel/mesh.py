"""The device mesh and the batch rules of data parallelism
(``mmqg_tpu/parallel/mesh.py``, its data axis).

A :class:`Mesh` is a ``(data, model)`` array of ``torch.device``s. The port
runs the data axis only: one model replica per device of the axis, every
request batch padded to a multiple of it (:func:`pad_batch`) and cut into
contiguous row blocks (:func:`row_block`), the first block on the first
device. A model axis larger than 1 (the tensor-parallel rules, sequence
parallelism, ZeRO-1/FSDP, GPipe) is ROADMAP item 19b and raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_NAMES = ("data", "model")
_MODEL_AXIS = ("a model axis larger than 1 (tensor parallelism, sequence "
               "parallelism, ZeRO-1/FSDP, GPipe) is not ported (ROADMAP "
               "queue 1, item 19b)")


class Mesh:
    """A ``(data, model)`` array of devices (``devices``, a numpy object
    array) with its ``axis_names``. Only ``model == 1`` is supported."""

    def __init__(self, devices: np.ndarray,
                 axis_names: Tuple[str, str] = AXIS_NAMES):
        if tuple(axis_names) != AXIS_NAMES:
            raise ValueError(f"axis_names must be {AXIS_NAMES}: the data "
                             f"rules name those axes, got {axis_names}")
        if devices.ndim != 2:
            raise ValueError(f"a (data, model) device array, got shape "
                             f"{devices.shape}")
        if devices.shape[1] != 1:
            raise NotImplementedError(f"mesh shape {devices.shape}: "
                                      + _MODEL_AXIS)
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> list:
        """The devices of the data axis, in row-block order."""
        return list(self.devices[:, 0])

    @property
    def dp(self) -> int:
        return self.devices.shape[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.data_devices]})"


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
    card, :func:`visible_devices`). ``shape=None`` puts every device on the
    data axis. A device may appear more than once: two replicas on one card
    exercise the split and the merge, not scaling."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else visible_devices())]
    if shape is None:
        shape = (len(devs), 1)
    shape = tuple(int(s) for s in shape)
    if shape[1] != 1:
        raise NotImplementedError(f"mesh shape {shape}: " + _MODEL_AXIS)
    if shape[0] * shape[1] != len(devs):
        raise ValueError(f"mesh shape {shape} != {len(devs)} devices")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape))


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
    data axis, another shape is taken as it is. With one device it logs
    the JAX package's warning and returns None (run single-device)."""
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
