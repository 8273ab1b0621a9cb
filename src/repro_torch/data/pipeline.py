"""Prefetching data pipeline wrapper with checkpointable cursor.

A copy of the JAX package's `data/pipeline.py` (a thread and a queue; no
JAX in either)."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

__all__ = ["Pipeline"]


class Pipeline:
    """Wraps a `TokenStream`-like source with a one-deep prefetch thread.

    The *cursor semantics* make prefetch safe to checkpoint: `state()`
    returns the source state as of the last batch HANDED OUT (not the last
    prefetched), so restore replays nothing and skips nothing.
    """

    def __init__(self, source, make_batch: Optional[Callable] = None,
                 prefetch: int = 2):
        self.source = source
        self.make_batch = make_batch or (lambda s: {"tokens": s.next_batch()})
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._handed_state = source.state()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while not self._stop.is_set():
            pre_state = self.source.state()
            batch = self.make_batch(self.source)
            self._q.put((pre_state, batch))

    def __next__(self):
        return self.next_with_state()[0]

    def next_with_state(self):
        """Returns (batch, resume_state): resume_state reproduces the stream
        from *after* this batch."""
        pre_state, batch = self._q.get()
        # The source has advanced past this batch already (prefetch), but the
        # correct resume point is pre_state.cursor + 1.
        resume = dict(pre_state)
        resume["cursor"] = pre_state["cursor"] + 1
        return batch, resume

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
