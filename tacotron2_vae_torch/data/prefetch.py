"""Background input pipeline: a prefetch thread and an ordered thread-pool map.

The port's copy of the JAX package's ``data/prefetch.py``.  ``prefetch``
runs featurise -> collate -> host-to-device copy ``depth`` batches ahead of
the train step in a daemon thread, so the host pipeline hides behind the
card's work; ``prefetch_map`` is the loader's ``num_workers`` pool.
"""

from __future__ import annotations

import collections
import concurrent.futures
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

_STOP = object()


def prefetch(iterable: Iterable, depth: int = 2,
             transform: Optional[Callable] = None) -> Iterator:
    """Iterate ``iterable`` through a bounded background queue.

    Order-preserving with at most ``depth`` items in flight; ``transform``
    runs in the worker thread; a worker's exception is raised at the
    consumer's next pull; an early exit of the consumer (break, close)
    stops the worker."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if stop.is_set():
                    return
                if not _put(transform(item) if transform else item):
                    return
        except BaseException as e:  # noqa: BLE001 - raised at the consumer
            _put(e)
            return
        _put(_STOP)

    threading.Thread(target=worker, daemon=True, name="input-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is _STOP:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def prefetch_map(fn: Callable, items: Iterable, workers: int = 4,
                 depth: Optional[int] = None) -> Iterator:
    """Order-preserving parallel map over a thread pool.

    ``workers`` threads run ``fn`` (batch assembly: np.load and the native
    collate, which release the GIL) up to ``depth`` results ahead of the
    consumer.  A worker's exception is raised at the consumer's pull of
    that item; queued work is cancelled on an early exit."""
    if workers <= 1:
        yield from prefetch((fn(x) for x in items), depth=depth or 2)
        return
    depth = depth or 2 * workers
    pool = concurrent.futures.ThreadPoolExecutor(workers, thread_name_prefix="input-worker")
    pending: collections.deque = collections.deque()
    try:
        for x in items:
            pending.append(pool.submit(fn, x))
            if len(pending) >= depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        for f in pending:
            f.cancel()
        pool.shutdown(wait=False)
