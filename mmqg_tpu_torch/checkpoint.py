"""Read and write the JAX package's checkpoints without flax, orbax or JAX
(``mmqg_tpu/checkpoint.py``): the msgpack backend, the orbax backend and
asynchronous saves and copies.

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

``<ckpt_dir>/<alias>.orbax/`` is what orbax's ``StandardCheckpointer``
writes for the same state dict (orbax imports JAX, so the port writes the
layout itself with ``tensorstore``, imported only when this backend is
used): ``_CHECKPOINT_METADATA`` and ``_METADATA`` (JSON; the tree's
key paths), and the arrays as zarr v2 (one zstd chunk each), keyed by the
dotted state-dict path (``params.decoder.out.w``), in an OCDBT key-value
store that the process writes under ``ocdbt.process_0/`` and merges into
the directory's root manifest, as orbax does. The JAX package's
``load_checkpoint`` restores it, and :func:`load_checkpoint` reads the JAX
package's. Without ``tensorstore`` the orbax backend raises ImportError;
it never falls back to msgpack.

Asynchronous saves and copies run on the process's one writer thread, in
submission order (a queued ``last`` and then ``best`` never interleave);
the caller pays only for the host copy. :func:`wait_for_pending` blocks
until every queued write is published and re-raises the first writer
error; :func:`load_checkpoint` and synchronous saves and copies wait
first.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from mmqg_tpu_torch.parallel import multihost

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_CHUNK_BYTES = 2 ** 30  # flax's MAX_CHUNK_SIZE
BACKENDS = ("msgpack", "orbax")


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


# ------------------------------------------------------------------ orbax

def _tensorstore():
    """``tensorstore``, which the orbax backend reads and writes with (it
    imports no JAX); ImportError naming it when it is not installed."""
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "the orbax checkpoint backend needs the 'tensorstore' package "
            "(it writes and reads <alias>.orbax/ without orbax, which "
            "imports JAX); install it or use backend='msgpack'") from e
    return tensorstore


def _orbax_path(ckpt_dir: Path, alias: str) -> Path:
    return (Path(ckpt_dir) / f"{alias}.orbax").resolve()


def _state_items(node: Any, keys: Tuple[str, ...] = ()
                 ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs of flax's ``to_state_dict`` of a tree, keys
    sorted as strings (lists and tuples keyed "0".."n-1"); an empty dict
    (optax's ``EmptyState``, a masked-out leaf) is a leaf of its own."""
    if isinstance(node, (list, tuple)):
        node = {str(i): v for i, v in enumerate(node)}
    if isinstance(node, dict) and node:
        return [item for k in sorted(node, key=str)
                for item in _state_items(node[k], keys + (str(k),))]
    return [(keys, node)]


def _ocdbt(directory: Path) -> Dict[str, Any]:
    """The OCDBT key-value store spec of orbax's writes
    (``tensorstore_utils.build_kvstore_tspec`` and
    ``add_ocdbt_write_options``)."""
    return {"driver": "ocdbt",
            "base": {"driver": "file", "path": str(directory)},
            "config": {"max_inline_value_bytes": 1024,
                       "max_decoded_node_bytes": 100000000,
                       "manifest_kind": "single"},
            "assume_config": True}


def _zarr_metadata(arr: np.ndarray) -> Dict[str, Any]:
    return {"zarr_format": 2, "shape": list(arr.shape),
            "chunks": list(arr.shape), "dtype": arr.dtype.str,
            "compressor": {"id": "zstd", "level": 1}, "fill_value": None,
            "order": "C", "dimension_separator": ".", "filters": None}


def _save_orbax(path: Path, state: Any) -> None:
    """Write ``state`` as orbax's ``StandardCheckpointer`` does, into a
    temporary sibling of ``path`` that then replaces it."""
    ts = _tensorstore()
    t0 = time.time_ns()
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    items = _state_items(state)
    ctx = ts.Context()
    process = _ocdbt(tmp / "ocdbt.process_0")
    txn = ts.Transaction()
    writes = []
    for keys, leaf in items:
        if isinstance(leaf, dict):
            continue
        arr = np.asarray(leaf)
        store = ts.open({"driver": "zarr",
                         "kvstore": dict(process, path=".".join(keys) + "/"),
                         "metadata": _zarr_metadata(arr)},
                        create=True, context=ctx, transaction=txn).result()
        writes.append(store.write(arr))
    for w in writes:
        w.result()
    txn.commit_async().result()
    # orbax's merge of the per-process store into the root manifest
    root = ts.KvStore.open(_ocdbt(tmp), context=ctx).result()
    merge = ts.Transaction(atomic=True)
    ts.KvStore.open(process, context=ctx).result().experimental_copy_range_to(
        root.with_transaction(merge)).result()
    merge.commit_async().result()
    tree = {str(keys): {
        "key_metadata": [{"key": k, "key_type": 2} for k in keys],
        "value_metadata": {
            "value_type": "Dict" if isinstance(leaf, dict) else "np.ndarray",
            "skip_deserialize": isinstance(leaf, dict)}}
        for keys, leaf in items}
    (tmp / "_METADATA").write_text(json.dumps({
        "tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None}))
    (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": "orbax.checkpoint._src.handlers."
                         "standard_checkpoint_handler."
                         "StandardCheckpointHandler",
        "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}}))
    _publish_dir(tmp, path)


def _publish_dir(tmp: Path, path: Path) -> None:
    """Move a finished directory into place, over an older one."""
    old = path.with_name(path.name + ".old")
    if path.exists():
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _load_orbax(path: Path) -> Dict[str, Any]:
    """An orbax ``StandardCheckpointer`` directory (the JAX package's or
    the port's) -> nested dicts/lists of numpy, as ``msgpack_restore``
    returns them."""
    ts = _tensorstore()
    meta = json.loads((path / "_METADATA").read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr3 arrays are not read (orbax's "
                         "StandardCheckpointer writes zarr v2)")
    ctx = ts.Context()
    root = {"driver": "ocdbt", "base": {"driver": "file", "path": str(path)}}
    out: Dict[str, Any] = {}
    reads = []
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if entry["value_metadata"]["skip_deserialize"]:
            node[keys[-1]] = {}
            continue
        store = ts.open({"driver": "zarr",
                         "kvstore": dict(root, path=".".join(keys) + "/")},
                        open=True, context=ctx).result()
        reads.append((node, keys[-1], store.read()))
    for node, key, read in reads:
        arr = np.asarray(read.result())
        if arr.dtype.name == "bfloat16":  # widened, losslessly, as msgpack
            arr = arr.astype(np.float32)
        node[key] = arr
    return _restore(out)


# ------------------------------------------------------------ the writer

class _Writer:
    """One writer thread for the process: writes run in submission order.
    The thread starts with the first asynchronous write."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []

    def submit(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="ckpt")
            self._pending.append(self._pool.submit(fn))

    def wait(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    return
                future = self._pending.pop(0)
            future.result()


_WRITER = _Writer()


def wait_for_pending(group=None) -> None:
    """Block until every asynchronous write of this process is published;
    re-raises the first writer error. With a process ``group`` it is a
    collective: the primary (the only process that writes) drains its
    writer, then every process meets at a barrier, so that no process
    reads a checkpoint that is still being written."""
    try:
        _WRITER.wait()
    finally:
        if group is not None:
            multihost.barrier(group)


def _only_primary(group, write) -> None:
    """``write()`` on the primary of ``group`` (a torch.distributed group
    of a data-parallel run; None: this process alone), then every process
    of the group waits until it is done (a barrier). A synchronous write
    is then published; an asynchronous one only queued on the primary's
    writer, so a process that reads it calls ``wait_for_pending(group)``
    first."""
    if group is None:
        write()
        return
    try:
        if multihost.is_primary(group):
            write()
    finally:
        multihost.barrier(group)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    if backend == "orbax":
        _tensorstore()


def save_checkpoint(ckpt_dir: Path, alias: str,
                    train_state: Optional[Dict[str, Any]],
                    metadata: Optional[Dict[str, Any]] = None,
                    backend: str = "msgpack",
                    async_save: bool = False, *, group=None) -> Path:
    """Write ``<ckpt_dir>/<alias>.msgpack`` or ``<alias>.orbax/``
    (published atomically: a temporary name, then ``os.replace``) and the
    ``<alias>.json`` metadata sidecar, and drop the alias's artifact of the
    other backend, now stale. ``train_state`` is the JAX layout with numpy
    leaves (``compat.from_jax.train_state_to_numpy``): the host copy, made
    on the caller's thread. ``async_save``: serialise and write on the
    writer thread, after every earlier queued write; a synchronous save
    waits for those first. With a process ``group`` (data-parallel
    training) only its primary writes -- the others may pass None -- and
    every process returns after the barrier (see ``_only_primary``)."""
    _check_backend(backend)
    ckpt_dir = Path(ckpt_dir)

    def publish():
        def write():
            _write_checkpoint(ckpt_dir, alias, train_state, metadata,
                              backend)
        if async_save:
            _WRITER.submit(write)
        else:
            _WRITER.wait()
            write()

    _only_primary(group, publish)
    return (ckpt_dir / f"{alias}.msgpack" if backend == "msgpack"
            else _orbax_path(ckpt_dir, alias))


def _drop(path: Path) -> None:
    if path.is_dir():
        shutil.rmtree(path, ignore_errors=True)
    elif path.exists():
        path.unlink()


def _write_checkpoint(ckpt_dir: Path, alias: str, train_state: Dict[str, Any],
                      metadata: Optional[Dict[str, Any]],
                      backend: str) -> None:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    msgpack_path = ckpt_dir / f"{alias}.msgpack"
    if backend == "msgpack":
        tmp = msgpack_path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            f.write(msgpack_serialize(train_state))
        os.replace(tmp, msgpack_path)
        # load prefers msgpack: a stale orbax artifact would resume old
        # weights against fresh metadata, and the other way round
        _drop(_orbax_path(ckpt_dir, alias))
    else:
        _save_orbax(_orbax_path(ckpt_dir, alias), train_state)
        _drop(msgpack_path)
    if metadata is not None:
        with open(ckpt_dir / f"{alias}.json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def copy_checkpoint(ckpt_dir: Path, src_alias: str, dst_alias: str,
                    backend: str = "msgpack",
                    async_copy: bool = False, *, group=None) -> None:
    """Duplicate a published alias (its artifact and ``.json``), e.g.
    ``best`` from a just-written ``last``, atomically, without serialising
    the state again. ``async_copy``: on the writer thread, so after the
    source's queued write; a synchronous copy waits for that write first.
    With a process ``group``, on its primary, as ``save_checkpoint``."""
    _check_backend(backend)
    ckpt_dir = Path(ckpt_dir)

    def publish():
        def copy():
            _copy_checkpoint(ckpt_dir, src_alias, dst_alias, backend)
        if async_copy:
            _WRITER.submit(copy)
        else:
            _WRITER.wait()
            copy()

    _only_primary(group, publish)


def _copy_checkpoint(ckpt_dir: Path, src_alias: str, dst_alias: str,
                     backend: str) -> None:
    if backend == "orbax":
        dst = _orbax_path(ckpt_dir, dst_alias)
        tmp = dst.with_name(dst.name + ".tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.copytree(_orbax_path(ckpt_dir, src_alias), tmp)
        _publish_dir(tmp, dst)
        _drop(ckpt_dir / f"{dst_alias}.msgpack")
    else:
        dst = ckpt_dir / f"{dst_alias}.msgpack"
        tmp = dst.with_suffix(".tmp")
        shutil.copyfile(ckpt_dir / f"{src_alias}.msgpack", tmp)
        os.replace(tmp, dst)
        _drop(_orbax_path(ckpt_dir, dst_alias))
    meta = ckpt_dir / f"{src_alias}.json"
    if meta.exists():
        shutil.copyfile(meta, ckpt_dir / f"{dst_alias}.json")


def load_checkpoint(ckpt_dir: Path, alias: str) -> Dict[str, Any]:
    """The train state saved as ``<alias>.msgpack`` or ``<alias>.orbax/``
    (msgpack preferred when both exist, as the JAX package's load): a dict
    with "params", "model_state", "opt_state" and "step". Waits for this
    process's queued writes first."""
    wait_for_pending()
    ckpt_dir = Path(ckpt_dir)
    path = ckpt_dir / f"{alias}.msgpack"
    if path.exists():
        return msgpack_restore(path.read_bytes())
    if _orbax_path(ckpt_dir, alias).exists():
        return _load_orbax(_orbax_path(ckpt_dir, alias))
    raise FileNotFoundError(f"no '{alias}' checkpoint in {ckpt_dir}")


def has_checkpoint(ckpt_dir: Path, alias: str) -> bool:
    """Whether ``<alias>.msgpack`` or ``<alias>.orbax/`` exists."""
    return ((Path(ckpt_dir) / f"{alias}.msgpack").exists()
            or _orbax_path(ckpt_dir, alias).exists())


def load_metadata(ckpt_dir: Path, alias: str) -> Dict[str, Any]:
    """The ``<alias>.json`` sidecar, or {} when there is none."""
    path = Path(ckpt_dir) / f"{alias}.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)
