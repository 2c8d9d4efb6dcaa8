"""Reused page-locked host staging for the serving batch.

A serving call packs ~160 MB of frames and PCM. Packed into fresh numpy
buffers, every page of them faults in zeroed, the copy to the card goes
through CUDA's pageable bounce buffer while the host waits, and the
buffers are unmapped again when the call ends. On a CUDA pipeline,
``QGPipeline._pack`` instead writes each shipped array straight into a block
of page-locked host memory that outlives the call (``Lease.array``), and
``QGPipeline._to_device`` ships the blocks with ``non_blocking`` copies
(``HostStaging.ship``): the card pulls the bytes by DMA while the host goes
on to queue the encoder.

    staging = HostStaging(lambda n: torch.empty(n, dtype=torch.uint8,
                                                pin_memory=True))
    lease = staging.lease()
    frames = lease.array("frames", (rows, fcap, H, W, 3), np.uint8, keep)
    ...                                   # write each row's first keep[i]
    tensors = staging.ship([frames, ...], device)

A reused block is not zero. Each block remembers which of its byte ranges
may hold non-zero bytes, and ``Lease.array`` zeroes only the part of them
that the new array leaves as padding; the caller writes the rest, the
requests' frames and samples through ``Lease.copy``. Both are spread over
host threads: numpy's copies release the GIL, and one thread of an H100
machine's host CPU moves ~4 GB/s, ~21 ms for a serving batch's 83 MB of
frames (~6 ms on its 8 cores).

A slot (one block for each key) is written again only when

- no array of the batch that last held it is alive: a lease lives as long
  as any numpy view of its arrays, so a caller may keep them; and
- the CUDA event recorded behind its copies to the card has completed.

``FRESH`` has the same interface over new ``np.zeros`` buffers: the CPU
pipeline's packing.
"""

from __future__ import annotations

import itertools
import math
import os
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Interval = Tuple[int, int]


def _overlaps(xs: List[Interval], ys: List[Interval]):
    """The non-empty intersections of two sorted lists of disjoint
    [start, end) intervals, in order."""
    i = j = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            yield a, b
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1


def _assign(pair: Tuple[np.ndarray, np.ndarray]) -> None:
    dst, src = pair
    dst[...] = src


def _merged(xs: List[Interval]) -> List[Interval]:
    """Sorted intervals with the touching and overlapping ones joined."""
    out: List[Interval] = []
    for a, b in xs:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class _Block:
    """A reused host buffer (uint8) and the byte ranges of it that may
    hold non-zero bytes: sorted, disjoint, everything while its contents
    are unknown."""

    def __init__(self, mem: torch.Tensor):
        self.mem = mem
        self.bytes = mem.numpy()
        self.dirty: List[Interval] = [(0, mem.numel())]

    def prepare(self, rows: int, row_bytes: int, keep: np.ndarray
                ) -> List[np.ndarray]:
        """Make the block ready for ``rows`` rows of ``row_bytes`` bytes
        from its start whose first ``keep[i]`` bytes the caller writes;
        returns views of the stale bytes in the rest of the rows, for the
        caller to zero."""
        rows_keep = [(i * row_bytes, k) for i, k in enumerate(keep.tolist())]
        written = [(s, s + k) for s, k in rows_keep if k]
        pads = [(s + k, s + row_bytes) for s, k in rows_keep if k < row_bytes]
        stale = [self.bytes[a:b] for a, b in _overlaps(self.dirty, pads)]
        end = rows * row_bytes
        self.dirty = _merged(written + [(max(a, end), b)
                                        for a, b in self.dirty if b > end])
        return stale


class _Slot:
    """One block for each key, the lease that holds them, and the event
    behind their last copies to the card."""

    def __init__(self):
        self.blocks: Dict[str, _Block] = {}
        self.lease: Callable[[], Optional["Lease"]] = lambda: None
        self.event: Optional[torch.cuda.Event] = None
        self.shipped = 0          # order in which the event was recorded


class _Held:
    """The ``base`` of a staged array: the typed tensor over its block, and
    the lease the array keeps alive."""

    def __init__(self, tensor: torch.Tensor, lease: "Lease", typestr: str,
                 address: int):
        self.tensor = tensor
        self.lease = lease
        # ``address``: the block's, never NULL (an empty tensor's may be)
        self.__array_interface__ = {
            "version": 3, "shape": tuple(tensor.shape), "typestr": typestr,
            "data": (address, False)}


class Lease:
    """One batch's hold on a slot, alive while any view of its arrays is."""

    def __init__(self, staging: "HostStaging", slot: _Slot):
        self._staging = staging
        self.slot = slot

    def array(self, key: str, shape: Sequence[int], dtype,
              keep: Optional[Sequence[int]] = None) -> np.ndarray:
        """A ``shape`` array of ``dtype`` in the slot's block for ``key``
        (once per key and lease). The first ``keep[i]`` entries along axis
        1 of each row ``i`` are the caller's to write (all of every row
        without ``keep``); the rest of the array is zero."""
        dtype = np.dtype(dtype)
        shape = tuple(int(d) for d in shape)
        rows = shape[0]
        per_entry = math.prod(shape[2:]) * dtype.itemsize
        row_bytes = math.prod(shape[1:]) * dtype.itemsize
        keep_bytes = (np.full(rows, row_bytes, np.int64) if keep is None else
                      np.minimum(np.asarray(keep, np.int64) * per_entry,
                                 row_bytes))
        block = self._staging._block(self.slot, key, rows * row_bytes)
        self.copy([(stale, 0) for stale in
                   block.prepare(rows, row_bytes, keep_bytes)])
        tensor = block.mem[:rows * row_bytes].view(
            torch.from_numpy(np.empty(0, dtype)).dtype).view(shape)
        return np.asarray(_Held(tensor, self, dtype.str, block.mem.data_ptr()))

    def put(self, key: str, src: np.ndarray) -> np.ndarray:
        """``src``, copied into the slot's block for ``key``."""
        out = self.array(key, src.shape, src.dtype)
        out[...] = src
        return out

    def copy(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
        """``dst[...] = src`` for each (dst, src) pair, on host threads."""
        if pairs:
            self._staging._copy(pairs)


# free slots that may wait on copies in flight before a lease waits for the
# oldest rather than take a new slot: a second lets a batch pack while the
# last one's copies still queue behind the card's work
DEPTH = 2


class HostStaging:
    """Slots of reused host blocks, from ``alloc(nbytes)`` (a uint8 tensor
    of at least ``nbytes``; page-locked for the card)."""

    def __init__(self, alloc: Callable[[int], torch.Tensor]):
        self._alloc = alloc
        self._slots: List[_Slot] = []
        self._lock = threading.Lock()
        self._order = itertools.count(1)
        self._writers: Optional[ThreadPoolExecutor] = None

    def lease(self) -> Lease:
        """Hold a slot for one batch: a free one whose copies have landed;
        else a new one while fewer than ``DEPTH`` free slots wait on theirs;
        else the free slot shipped first, once its copies have landed."""
        with self._lock:
            free = [s for s in self._slots if s.lease() is None]
            slot = next((s for s in free
                         if s.event is None or s.event.query()), None)
            if slot is None and len(free) >= DEPTH:
                slot = min(free, key=lambda s: s.shipped)
            if slot is None:
                slot = _Slot()
                self._slots.append(slot)
            lease = Lease(self, slot)
            slot.lease = weakref.ref(lease)
        if slot.event is not None:
            slot.event.synchronize()
        return lease

    def _block(self, slot: _Slot, key: str, nbytes: int) -> _Block:
        block = slot.blocks.get(key)
        if block is None or block.mem.numel() < nbytes:
            # a power of two, as the caching host allocator rounds
            block = slot.blocks[key] = _Block(
                self._alloc(1 << max(0, nbytes - 1).bit_length()))
        return block

    def _copy(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
        with self._lock:
            if self._writers is None:
                self._writers = ThreadPoolExecutor(
                    os.cpu_count() or 1, thread_name_prefix="staging")
        for _ in self._writers.map(_assign, pairs):
            pass

    def ship(self, arrays: Sequence[np.ndarray], device
             ) -> Optional[List[torch.Tensor]]:
        """Copy whole staged arrays to the CUDA ``device``, ``non_blocking``
        on its current stream, and record the event that their slots wait
        on before they are written again. None, copying nothing, for
        another device or where any array is not a whole staged one."""
        device = torch.device(device)
        held = [a.base for a in arrays]
        if device.type != "cuda" or not all(isinstance(h, _Held)
                                            for h in held):
            return None
        # the copies read the blocks' own tensors, so the caching host
        # allocator also holds a block until they land
        out = [h.tensor.to(device, non_blocking=True) for h in held]
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        with self._lock:
            order = next(self._order)
            for h in held:
                h.lease.slot.event, h.lease.slot.shipped = event, order
        return out


class _Fresh:
    """``Lease``'s interface over new zeroed numpy buffers."""

    @staticmethod
    def array(key: str, shape: Sequence[int], dtype,
              keep: Optional[Sequence[int]] = None) -> np.ndarray:
        return np.zeros(shape, dtype)

    @staticmethod
    def put(key: str, src: np.ndarray) -> np.ndarray:
        return src

    @staticmethod
    def copy(pairs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
        for pair in pairs:
            _assign(pair)


FRESH = _Fresh()
