"""Read and write the JAX package's msgpack checkpoints without flax or JAX
(``mmqg_tpu/checkpoint.py``, msgpack backend).

``<ckpt_dir>/<alias>.msgpack`` is flax's ``msgpack_serialize`` of
``to_state_dict(train_state)``:

* an ndarray is msgpack ext type 1 holding the packed tuple
  (shape, dtype name, C-order bytes); a numpy scalar is ext type 3, the same
  encoding of a 0-d array;
* arrays over 2**30 bytes are split into a dict
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``;
* lists and tuples became dicts keyed "0", "1", ...; NamedTuples (the
  attention's ``AttnParams``, optax states) became dicts of their fields.

:func:`load_checkpoint` undoes the chunking and turns the "0".."n-1" dicts
back into lists; NamedTuples stay dicts of their fields, which is what
``compat.from_jax`` reads. :func:`save_checkpoint` writes the same format
from such a tree (lists and tuples become "0".."n-1" dicts), with every
dict's keys sorted as JAX's ``tree_map`` inside flax's ``msgpack_serialize``
leaves them, so a tree that equals a JAX train state's is written byte for
byte as the JAX package writes it. ``msgpack`` is imported only when a file
is read or written.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import json
import os
import shutil
from typing import Optional

import numpy as np

from mmqg_tpu_torch.parallel import multihost

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_CHUNK_BYTES = 2 ** 30  # flax's MAX_CHUNK_SIZE
_NOT_PORTED = ("not ported: the port writes msgpack checkpoints "
               "synchronously (ROADMAP queue 1, item 23)")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        # bf16 is the top half of an f32: widen the bits, losslessly
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _restore(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node.get("__msgpack_chunked_array__"):
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    out = {k: _restore(v) for k, v in node.items()}
    if out and all(k == str(i) for i, k in enumerate(out)):
        return [out[str(i)] for i in range(len(out))]
    return out


def msgpack_restore(blob: bytes) -> Dict[str, Any]:
    """Bytes of a flax msgpack checkpoint -> nested dicts/lists of numpy."""
    import msgpack

    return _restore(msgpack.unpackb(blob, ext_hook=_ext_hook, raw=False))


def load_checkpoint(ckpt_dir: Path, alias: str) -> Dict[str, Any]:
    """The train state saved as ``<ckpt_dir>/<alias>.msgpack``: a dict with
    "params", "model_state", "opt_state" and "step"."""
    path = Path(ckpt_dir) / f"{alias}.msgpack"
    if not path.exists():
        raise FileNotFoundError(
            f"no '{alias}.msgpack' checkpoint in {ckpt_dir} (the port reads "
            "the msgpack backend only)")
    return msgpack_restore(path.read_bytes())


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    import msgpack

    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    import msgpack

    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    raise TypeError(f"cannot serialise {type(x).__name__} in a checkpoint")


def _chunk(arr: np.ndarray) -> Dict[str, Any]:
    """flax's ``_chunk``: a flat array split into 2**30-byte pieces."""
    size = max(1, _MAX_CHUNK_BYTES // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in
                       enumerate(range(0, flat.size, size))}}


def _state_dict(node: Any) -> Any:
    """flax's ``to_state_dict`` of a tree of dicts, lists and numpy arrays,
    with sorted keys and oversized arrays chunked."""
    if isinstance(node, dict):
        return {k: _state_dict(node[k]) for k in sorted(node, key=str)}
    if isinstance(node, (list, tuple)):
        return _state_dict({str(i): v for i, v in enumerate(node)})
    if isinstance(node, np.ndarray) and node.nbytes > _MAX_CHUNK_BYTES:
        return _chunk(node)
    return node


def msgpack_serialize(tree: Any) -> bytes:
    """flax's ``msgpack_serialize(to_state_dict(tree))`` for a tree of
    dicts, lists and numpy arrays or scalars."""
    import msgpack

    return msgpack.packb(_state_dict(tree), default=_ext_pack,
                         strict_types=True)


def _only_primary(group, write) -> None:
    """``write()`` on the primary of ``group`` (a torch.distributed group
    of a data-parallel run; None: this process alone), then every process
    of the group waits until it is done (a barrier), so none reads a file
    before it is published."""
    if group is None:
        write()
        return
    try:
        if multihost.is_primary(group):
            write()
    finally:
        multihost.barrier(group)


def save_checkpoint(ckpt_dir: Path, alias: str,
                    train_state: Optional[Dict[str, Any]],
                    metadata: Optional[Dict[str, Any]] = None,
                    backend: str = "msgpack",
                    async_save: bool = False, *, group=None) -> Path:
    """Write ``<ckpt_dir>/<alias>.msgpack`` (published atomically with
    ``os.replace``) and the ``<alias>.json`` metadata sidecar.
    ``train_state`` is the JAX layout with numpy leaves (see
    ``compat.from_jax.train_state_to_numpy``). With a process ``group``
    (data-parallel training) only its primary writes -- the others may
    pass None -- and every process returns once the files are published.
    The orbax backend and asynchronous saves raise NotImplementedError."""
    if backend == "orbax" or async_save:
        raise NotImplementedError(
            f"checkpoint backend={backend!r} async_save={async_save}: "
            + _NOT_PORTED)
    if backend != "msgpack":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    path = Path(ckpt_dir) / f"{alias}.msgpack"
    _only_primary(group, lambda: _write_checkpoint(Path(ckpt_dir), alias,
                                                   train_state, metadata))
    return path


def _write_checkpoint(ckpt_dir: Path, alias: str, train_state: Dict[str, Any],
                      metadata: Optional[Dict[str, Any]]) -> None:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"{alias}.msgpack"
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(train_state))
    os.replace(tmp, path)
    # the alias's orbax artifact, if any, is now stale
    shutil.rmtree(ckpt_dir / f"{alias}.orbax", ignore_errors=True)
    if metadata is not None:
        with open(ckpt_dir / f"{alias}.json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def copy_checkpoint(ckpt_dir: Path, src_alias: str, dst_alias: str,
                    backend: str = "msgpack",
                    async_copy: bool = False, *, group=None) -> None:
    """Duplicate a published alias (``.msgpack`` and ``.json``), e.g.
    ``best`` from a just-written ``last``, atomically; with a process
    ``group``, on its primary, the others waiting for it."""
    if backend == "orbax" or async_copy:
        raise NotImplementedError(
            f"copy_checkpoint backend={backend!r} async_copy={async_copy}: "
            + _NOT_PORTED)
    _only_primary(group, lambda: _copy_checkpoint(Path(ckpt_dir), src_alias,
                                                  dst_alias))


def _copy_checkpoint(ckpt_dir: Path, src_alias: str, dst_alias: str) -> None:
    dst = ckpt_dir / f"{dst_alias}.msgpack"
    tmp = dst.with_suffix(".tmp")
    shutil.copyfile(ckpt_dir / f"{src_alias}.msgpack", tmp)
    os.replace(tmp, dst)
    shutil.rmtree(ckpt_dir / f"{dst_alias}.orbax", ignore_errors=True)
    meta = ckpt_dir / f"{src_alias}.json"
    if meta.exists():
        shutil.copyfile(meta, ckpt_dir / f"{dst_alias}.json")


def has_checkpoint(ckpt_dir: Path, alias: str) -> bool:
    """Whether ``<alias>.msgpack`` exists (the only backend the port
    reads)."""
    return (Path(ckpt_dir) / f"{alias}.msgpack").exists()


def load_metadata(ckpt_dir: Path, alias: str) -> Dict[str, Any]:
    """The ``<alias>.json`` sidecar, or {} when there is none."""
    path = Path(ckpt_dir) / f"{alias}.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)
