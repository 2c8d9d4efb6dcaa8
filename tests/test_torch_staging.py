"""``mmqg_tpu_torch/staging.py`` on the CPU: reused blocks read zero
wherever the caller does not write, a held batch keeps its slot, and a
lease waits for the copies of the slot it takes. The copies themselves run
on the card (``test_torch_staging_cuda.py``)."""

import gc

import numpy as np
import pytest
import torch

from mmqg_tpu_torch.staging import DEPTH, FRESH, HostStaging


def _stale(nbytes):
    return torch.full((nbytes,), 0xAB, dtype=torch.uint8)


class _Copies:
    """A stand-in for the CUDA event behind a slot's copies."""

    def __init__(self, landed):
        self.landed, self.waited = landed, False

    def query(self):
        return self.landed

    def synchronize(self):
        self.waited = self.landed = True


@pytest.mark.parametrize("seed", range(4))
def test_arrays_read_zero_where_the_caller_does_not_write(seed):
    """Random layouts of two keys, one after another in the same slot:
    each array is zero outside each row's kept prefix before the caller
    writes it (``Lease.copy``), and blocks grow only for a larger array."""
    rng = np.random.RandomState(seed)
    allocs, want_allocs, caps = [], [], {}
    staging = HostStaging(lambda n: allocs.append(n) or _stale(n))
    for _ in range(12):
        lease = staging.lease()
        rows = int(rng.choice([1, 2, 4, 8]))
        for key, dtype, tail in (("frames", np.uint8, (3, 2)),
                                 ("pcm", np.int16, ())):
            width = int(rng.randint(0, 9))
            keep = rng.randint(0, width + 1, rows)
            need = rows * width * int(np.prod(tail)) * np.dtype(dtype).itemsize
            if key not in caps or need > caps[key]:
                caps[key] = 1 << max(0, need - 1).bit_length()
                want_allocs.append(caps[key])
            a = lease.array(key, (rows, width) + tail, dtype, keep)
            assert a.dtype == dtype and a.shape == (rows, width) + tail
            want = np.zeros(a.shape, dtype)
            for i, k in enumerate(keep):
                assert not a[i, k:].any(), (key, i)
                want[i, :k] = rng.randint(1, 100, want[i, :k].shape)
            lease.copy([(a[i, :k], want[i, :k]) for i, k in enumerate(keep)])
            assert a.tobytes() == want.tobytes()
        del lease, a
    assert len(staging._slots) == 1
    assert allocs == want_allocs           # powers of two, when outgrown


def test_a_held_array_keeps_its_slot():
    """A view, or a tensor over a view, of a batch's array keeps the slot:
    the next lease takes another, and its writes leave the view intact."""
    staging = HostStaging(_stale)
    first = staging.lease().array("x", (4, 5), np.int32)
    first[...] = np.arange(20).reshape(4, 5)
    tensor = torch.from_numpy(first[1:, 2:])
    del first
    gc.collect()
    second = staging.lease().array("x", (4, 5), np.int32)
    second[...] = -1
    assert len(staging._slots) == 2
    assert tensor.tolist() == [[7, 8, 9], [12, 13, 14], [17, 18, 19]]
    del tensor, second
    gc.collect()
    lens = staging.lease().put("lens", np.array([3, 1], np.int32))
    assert len(staging._slots) == 2 and lens.tolist() == [3, 1]


def test_a_lease_waits_for_copies_in_flight():
    """With ``DEPTH`` free slots whose copies are in flight, a lease takes
    the one shipped first once its copies land; with fewer, a new slot; a
    slot whose copies landed is taken as it is."""
    assert DEPTH == 2
    staging = HostStaging(_stale)
    held = [staging.lease().array("x", (2, 3), np.uint8) for _ in range(2)]
    del held
    a, b = staging._slots
    a.event, a.shipped = _Copies(False), 2
    b.event, b.shipped = _Copies(False), 1
    lease = staging.lease()
    assert lease.slot is b and b.event.waited and not a.event.waited
    assert len(staging._slots) == 2
    del lease
    staging._slots.pop()
    a.event = _Copies(False)
    assert staging.lease().slot is not a and len(staging._slots) == 2
    a.event = _Copies(True)
    assert staging.lease().slot is a


def test_ship_copies_nothing_off_the_card():
    """``ship`` returns None for a CPU device and for arrays not staged
    whole; ``FRESH`` is plain zeroed numpy."""
    staging = HostStaging(_stale)
    lease = staging.lease()
    a = lease.array("x", (2, 3), np.int16)
    assert staging.ship([a], "cpu") is None
    assert staging.ship([a[1:]], torch.device("cuda")) is None
    assert staging.ship([np.zeros(3)], "cuda") is None
    z = FRESH.array("x", (2, 3), np.int16, [1, 0])
    assert z.base is None and not z.any() and z.dtype == np.int16
    src = np.ones(3, np.int32)
    assert FRESH.put("y", src) is src
    FRESH.copy([(z[0], src), (z[1, :2], src[:2])])
    assert z.tolist() == [[1, 1, 1], [1, 1, 0]]
