"""Multiprocess generator prefetch (host input pipeline), the port of
``fots/data/prefetch.py``.

N daemon worker processes each run a generator *factory* (seeded per
worker) and feed one bounded queue; the consumer blocks on ``queue.get``.
Workers are spawned, not forked (the parent holds CUDA and threads), so a
factory must be a picklable top-level callable; they import NumPy and the
port's data modules only.

On a mesh one reader pool feeds the global batch, as in ``fots``: rank 0
runs it and :class:`BroadcastBatches` sends each batch to every rank (the
readers draw from one seeded generator in sequence, so pools on every rank
could not reproduce one pool's order).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import traceback
from typing import Callable, Iterator

#: a few batches absorb one slow sample; a deeper queue only hides readers
#: that fall behind the trainer
QUEUE_BATCHES = 4


def _worker(factory: Callable[[int], Iterator], worker_id: int, q, stop_event,
            parent_pid: int):
    try:
        for item in factory(worker_id):
            while True:
                if stop_event.is_set():
                    return
                # orphan watchdog: a SIGKILLed parent runs no cleanup, so a
                # worker whose parent changed exits; put() has a timeout so a
                # full queue with a dead consumer still reaches this check
                if os.getppid() != parent_pid:
                    return
                try:
                    q.put(item, timeout=5.0)
                    break
                except queue_mod.Full:
                    continue
    except KeyboardInterrupt:
        pass
    except Exception:
        traceback.print_exc()


class PrefetchPool:
    """N spawned worker processes feeding one queue of ``max_queue`` items."""

    def __init__(self, generator_factory: Callable[[int], Iterator], num_workers: int = 4,
                 max_queue: int = QUEUE_BATCHES):
        self._ctx = mp.get_context("spawn")
        self._queue = self._ctx.Queue(maxsize=max_queue)
        self._stop = self._ctx.Event()
        self._procs = []
        for wid in range(num_workers):
            p = self._ctx.Process(target=_worker,
                                  args=(generator_factory, wid, self._queue, self._stop,
                                        os.getpid()),
                                  daemon=True)
            p.start()
            self._procs.append(p)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                return self._queue.get(timeout=5.0)
            except queue_mod.Empty:
                if not any(p.is_alive() for p in self._procs):
                    raise StopIteration
                continue

    def stop(self):
        self._stop.set()
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class BroadcastBatches:
    """The batches of ``source`` on every rank of ``group`` (a gloo group:
    host objects travel pickled): rank ``src`` iterates ``source`` and
    broadcasts each item, then None at its end; the other ranks pass
    ``source=None`` and yield what arrives.  Every rank must iterate in
    step.  :meth:`stop` stops the source."""

    def __init__(self, source, group, src: int = 0):
        import torch.distributed as dist

        self._dist = dist
        self._source = source
        self._group = group
        self._src = src
        self._main = dist.get_rank() == src
        self._it = iter(source) if self._main else None

    def __iter__(self):
        return self

    def __next__(self):
        box = [next(self._it, None) if self._main else None]
        self._dist.broadcast_object_list(box, src=self._src, group=self._group)
        if box[0] is None:
            raise StopIteration
        return box[0]

    def stop(self):
        if self._main and hasattr(self._source, "stop"):
            self._source.stop()
