"""Async device->host pulls off the frame loop's thread.

A device->host pull waits for the producing program and then for the
transfer. The frame loop never pulls inline: it submits the result tree to
this pool right after dispatch and picks the numpy values up a frame (or
more) later, so the wait overlaps later frames' dispatch. Whether that
wins over a synchronous pull on a local GPU is for a benchmark to decide.

`jax.device_get` on a whole pytree batches all leaves into one transfer —
always submit the full result tree in one submit() call.
"""
from __future__ import annotations

import concurrent.futures as _fut

import jax
import numpy as np


class PullPool:
    """Thread pool wrapping batched jax.device_get calls."""

    def __init__(self, workers: int = 8):
        self._ex = _fut.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="pull")

    def submit(self, tree) -> _fut.Future:
        """Pull a pytree of device arrays to host numpy in a worker thread.
        Returns a Future whose result() is the same pytree with numpy
        leaves."""
        return self._ex.submit(jax.device_get, tree)


_POOLS: dict = {}


def pull_pool(name: str = "track") -> PullPool:
    """Named pools: the per-frame tracking pulls saturate their own pool
    under deep pipelining; mapping-stage pulls get a separate one so a
    merge's result does not queue behind six frame results (the stage
    queue's residency is what gates keyframe acceptance — see
    Slam._mapper_busy)."""
    pool = _POOLS.get(name)
    if pool is None:
        pool = _POOLS[name] = PullPool(workers=4 if name != "track" else 8)
    return pool


def get_result(pending):
    """Resolve either a Future (async pull) or a raw device tree
    (synchronous fallback) to numpy leaves."""
    if isinstance(pending, _fut.Future):
        return pending.result()
    return jax.tree.map(np.asarray, pending)
