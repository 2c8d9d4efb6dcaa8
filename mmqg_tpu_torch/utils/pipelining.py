"""Host-loop pipelining (``mmqg_tpu/utils/pipelining.py``): dispatch device
work a few items ahead of the blocking device-to-host reads, so the host
prepares batch i+1 while the device still runs batch i."""

from collections import deque
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
D = TypeVar("D")
R = TypeVar("R")


def pipelined(items: Iterable[T],
              dispatch: Callable[[T], D],
              finalize: Callable[[D, T], R],
              lag: int = 2) -> Iterator[R]:
    """Yield ``finalize(dispatch(item), item)`` for every item, in order,
    with ``dispatch`` running up to ``lag`` items ahead of ``finalize``.

    ``dispatch`` should enqueue device work and return without blocking;
    ``finalize`` does the blocking reads and any host-side work. ``lag=0``
    is the plain synchronous loop."""
    if lag < 0:
        raise ValueError(f"lag must be >= 0, got {lag}")
    pending: "deque" = deque()
    for item in items:
        pending.append((dispatch(item), item))
        if len(pending) > lag:
            d, it = pending.popleft()
            yield finalize(d, it)
    while pending:
        d, it = pending.popleft()
        yield finalize(d, it)
