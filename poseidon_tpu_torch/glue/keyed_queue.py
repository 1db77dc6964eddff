"""Per-key serializing work queue.

Semantics match the reference's keyed queue (pkg/k8sclient/keyed_queue.go:24-135):

- ``add(key, item)`` enqueues work for a key.  Multiple items for the same
  key coalesce in arrival order.
- ``get()`` blocks for the next (key, items) batch, marking the key as
  *processing*; further adds for that key park in a side queue.
- ``done(key)`` releases the key; parked items (if any) re-enter the main
  queue.  This guarantees ordered, non-concurrent processing per pod/node
  while allowing many workers.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Hashable, List, Optional, Tuple

from poseidon_tpu_torch.utils.locks import tracked_condition


class KeyedQueue:
    def __init__(self) -> None:
        self._cond = tracked_condition("glue.KeyedQueue._cond")
        self._queue: "OrderedDict[Hashable, List[Any]]" = OrderedDict()
        self._parked: "OrderedDict[Hashable, List[Any]]" = OrderedDict()
        self._processing: set = set()
        self._shutdown = False
        # First-enqueue timestamp per queued key (monotonic), kept in
        # the same arrival order as _queue: the head entry is the
        # oldest undelivered event, whose age is the glue-side ingest
        # lag (oldest_age_s) the streaming engine's staleness bound is
        # judged against.
        self._enqueued_at: "OrderedDict[Hashable, float]" = OrderedDict()

    def add(self, key: Hashable, item: Any) -> None:
        with self._cond:
            if self._shutdown:
                return
            if key in self._processing:
                self._parked.setdefault(key, []).append(item)
            else:
                self._queue.setdefault(key, []).append(item)
                self._enqueued_at.setdefault(key, time.monotonic())
                self._cond.notify()

    def get(self) -> Optional[Tuple[Hashable, List[Any]]]:
        """Next batch; None after shutdown drains."""
        with self._cond:
            while not self._queue and not self._shutdown:
                self._cond.wait()
            if not self._queue:
                return None
            key, items = self._queue.popitem(last=False)
            self._enqueued_at.pop(key, None)
            self._processing.add(key)
            return key, items

    def oldest_age_s(self) -> Optional[float]:
        """Age of the oldest QUEUED (undelivered) batch, or None when
        nothing waits.  A worker mid-batch does not count — delivery
        latency, not processing latency, is the ingest-lag signal."""
        with self._cond:
            for ts in self._enqueued_at.values():
                return time.monotonic() - ts
            return None

    def done(self, key: Hashable) -> None:
        with self._cond:
            self._processing.discard(key)
            parked = self._parked.pop(key, None)
            if parked:
                self._queue.setdefault(key, []).extend(parked)
                # Unparked work re-enters the queue NOW; its wait while
                # parked was serialization, not delivery lag.
                self._enqueued_at.setdefault(key, time.monotonic())
                self._cond.notify()

    def shut_down(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def __len__(self) -> int:
        """Outstanding work: queued + parked items, plus keys whose batch a
        worker is still processing (popped but not yet ``done()``) — so a
        zero length really means the queue has drained."""
        with self._cond:
            return (
                sum(len(v) for v in self._queue.values())
                + sum(len(v) for v in self._parked.values())
                + len(self._processing)
            )
