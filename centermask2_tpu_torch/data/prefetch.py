"""Background prefetching (the port's own copy of
``centermask2_tpu/data/prefetch.py``): a daemon thread keeps a small
bounded queue of ready host items, so image decode, resize and packing
overlap the device instead of serializing with it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_DONE = object()


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield from ``it`` through a ``depth``-deep background queue.

    Exceptions in the producer re-raise at the consuming ``next()``.
    The producer thread is a daemon, so abandoning the iterator cannot
    hang interpreter exit, and it stops when the consumer's
    ``close()``/``finally`` runs, which garbage collection of the returned
    generator also does. There is deliberately no idle timeout:
    a consumer legitimately stalls for long stretches (first-call
    compiles, periodic evaluation). The consumer polls with a timeout
    and raises if the producer died without delivering its sentinel.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not put_or_stop(item):
                    return
            put_or_stop(_DONE)
        except BaseException as e:  # propagate to the consumer
            put_or_stop(e)

    t = threading.Thread(target=run, daemon=True, name="batch-prefetch")

    def gen():
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=5.0)
                except queue.Empty:
                    if not t.is_alive() and q.empty():
                        raise RuntimeError(
                            "prefetch producer thread died without a "
                            "sentinel") from None
                    continue
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    return gen()
