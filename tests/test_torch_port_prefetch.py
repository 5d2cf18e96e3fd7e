"""Port parity: the background input pipeline (``data/prefetch.py``).

``prefetch`` keeps order, runs its transform in the worker thread, raises a
worker's exception at the consumer's next pull and, on an early exit of the
consumer, stops its worker within 1 s; ``prefetch_map`` keeps order under
real concurrency, raises at the failing item and cancels queued work on an
early exit.  Both yield the same items as the JAX package's.
"""

import importlib
import threading
import time

import pytest
from _torch_port_common import one_thread  # noqa: F401 (autouse)

pf = importlib.import_module("tacotron2_vae_torch.data.prefetch")
jpf = importlib.import_module("tacotron2_vae_tpu.data.prefetch")


def _workers(prefix):
    return [t for t in threading.enumerate() if t.name.startswith(prefix) and t.is_alive()]


def test_prefetch_order_and_transform_match_jax():
    got = list(pf.prefetch(range(10), depth=3, transform=lambda x: x * 2))
    assert got == list(jpf.prefetch(range(10), depth=3, transform=lambda x: x * 2))
    assert got == [2 * x for x in range(10)]


def test_prefetch_transform_runs_in_the_worker():
    names = list(pf.prefetch(range(3), depth=2,
                             transform=lambda x: threading.current_thread().name))
    assert names == ["input-prefetch"] * 3


def test_prefetch_raises_at_the_pull():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("boom")

    it = pf.prefetch(gen(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetch_early_exit_stops_the_worker():
    before = len(_workers("input-prefetch"))
    it = pf.prefetch(iter(range(10 ** 6)), depth=1)
    assert next(it) == 0
    it.close()
    deadline = time.monotonic() + 1.0
    while len(_workers("input-prefetch")) > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(_workers("input-prefetch")) == before


def test_prefetch_map_matches_jax():
    def slow_sq(x):
        time.sleep(0.002 * (8 - x % 8))
        return x * x

    got = list(pf.prefetch_map(slow_sq, range(32), workers=4))
    assert got == list(jpf.prefetch_map(slow_sq, range(32), workers=4))
    assert got == [x * x for x in range(32)]
    assert list(pf.prefetch_map(lambda x: x + 1, range(5), workers=1)) == [1, 2, 3, 4, 5]


def test_prefetch_map_errors_and_early_exit():
    def boom(x):
        if x == 3:
            raise RuntimeError("boom")
        return x

    it = pf.prefetch_map(boom, range(6), workers=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="boom"):
        list(it)
    calls = []

    def record(x):
        calls.append(x)
        time.sleep(0.01)
        return x

    it = pf.prefetch_map(record, range(1000), workers=2, depth=4)
    assert next(it) == 0
    it.close()
    time.sleep(0.1)
    assert len(calls) < 20  # queued work was cancelled
