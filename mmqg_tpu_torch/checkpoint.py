"""Read the JAX package's msgpack checkpoints without flax or JAX
(``mmqg_tpu/checkpoint.py:load_checkpoint``, msgpack backend).

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
``compat.from_jax`` reads. ``msgpack`` is imported only when reading.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


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
