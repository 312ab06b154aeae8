"""Ordered, bounded, threaded stage pipeline.

Counterpart of ``yugabyte_db_tpu/storage/pipeline.py``.  Each stage
function runs on its own worker thread, connected by bounded queues
(depth 2 = double buffering), so the streaming scan forms chunk k+1's
batch while chunk k's kernels run.  Order is preserved end to end: the
consumer sees results exactly as if it had mapped the stages serially.
An exception in any stage cancels the pipeline and re-raises in the
consumer; an early consumer exit (generator close) tears the workers
down without deadlocking on the bounded queues.

A batch built on a worker thread is on the card when the consumer gets
it: ``build_batch``'s host-to-device copies run on the worker thread's
current stream, which is the device's default stream (as the consumer's
is), so a launch the consumer issues afterwards is ordered behind them.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, List, Sequence

_SENTINEL = object()


class StreamPipeline:
    """stages: callables ``payload -> payload``; depth: max in-flight
    items per stage boundary.  After a run, ``stage_s[i]`` holds stage
    i's busy seconds and ``wait_s`` the consumer's blocked time on the
    final queue."""

    def __init__(self, stages: Sequence[Callable], depth: int = 2,
                 name: str = "pipeline"):
        if not stages:
            raise ValueError("StreamPipeline needs at least one stage")
        self.stages = list(stages)
        self.depth = depth
        self.name = name
        self.stage_s: List[float] = [0.0] * len(stages)
        self.wait_s = 0.0
        self.items = 0

    def run(self, items: Iterable) -> Iterator:
        """Yield the fully-staged result of every item, in order."""
        qs = [queue.Queue(self.depth)
              for _ in range(len(self.stages) + 1)]
        cancel = threading.Event()

        def feeder():
            try:
                for it in items:
                    if cancel.is_set():
                        break
                    qs[0].put(("item", it))
            except BaseException as e:   # noqa: BLE001 — forwarded
                qs[0].put(("error", e))
            qs[0].put(_SENTINEL)

        def worker(si: int, fn: Callable):
            in_q, out_q = qs[si], qs[si + 1]
            while True:
                got = in_q.get()
                if got is _SENTINEL:
                    out_q.put(_SENTINEL)
                    return
                kind, payload = got
                if kind == "item" and not cancel.is_set():
                    t0 = time.perf_counter()
                    try:
                        payload = fn(payload)
                    except BaseException as e:  # noqa: BLE001 — forwarded
                        kind, payload = "error", e
                    self.stage_s[si] += time.perf_counter() - t0
                elif kind == "item":
                    kind, payload = "skip", None
                out_q.put((kind, payload))

        threads = [threading.Thread(target=feeder, daemon=True,
                                    name=f"{self.name}-feed")]
        threads += [threading.Thread(target=worker, args=(i, fn),
                                     daemon=True, name=f"{self.name}-s{i}")
                    for i, fn in enumerate(self.stages)]
        for t in threads:
            t.start()
        final = qs[-1]
        finished = False
        try:
            while True:
                t0 = time.perf_counter()
                got = final.get()
                self.wait_s += time.perf_counter() - t0
                if got is _SENTINEL:
                    finished = True
                    break
                kind, payload = got
                if kind == "error":
                    cancel.set()
                    raise payload
                if kind == "skip":
                    continue
                self.items += 1
                yield payload
        finally:
            cancel.set()
            # unblock any worker stuck on a bounded put, then join so no
            # stage thread outlives the run
            if not finished:
                self._drain(final)
            for t in threads:
                t.join(timeout=10.0)

    @staticmethod
    def _drain(q: "queue.Queue") -> None:
        while True:
            if q.get() is _SENTINEL:
                return

    def stats(self) -> dict:
        return {"items": self.items,
                "stage_s": [round(s, 4) for s in self.stage_s],
                "consumer_wait_s": round(self.wait_s, 4)}

