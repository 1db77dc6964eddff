"""Clean concurrency fixture: consistent lock order, waits outside
critical sections, publication under the lock or via a documented
handoff.  Must produce ZERO findings for all three concurrency rules
(tests/test_torch_check_selfcheck.py)."""

import threading
import time

import torch

from poseidon_tpu_torch.utils.locks import TrackedLock, tracked_condition


class OrderedPair:
    """One global order — _coarse before _fine — on every path."""

    def __init__(self):
        self._coarse = TrackedLock("fixture.OrderedPair._coarse")
        self._fine = TrackedLock("fixture.OrderedPair._fine")
        self._items = []

    def update(self, x):
        with self._coarse:
            with self._fine:
                self._items.append(x)

    def refresh(self):
        with self._coarse:
            with self._fine:
                self._items.clear()


class PatientWorker:
    """Waits happen on the condition's OWN lock; sleeps happen outside
    any critical section; republication is locked or handed off."""

    def __init__(self):
        self._cond = tracked_condition("fixture.PatientWorker._cond")
        self._queue = []
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        with self._cond:
            while not self._queue:
                self._cond.wait()

    def put(self, item):
        with self._cond:
            self._queue.append(item)
            self._cond.notify()

    def rebuild(self):
        with self._cond:
            self._queue = []

    def reset_before_start(self):
        self._queue = []  # handoff: called before the worker starts

    def backoff(self):
        time.sleep(0.0)


class DeviceReader:
    """Device waits happen outside the lock; the lock only guards the
    host-side swap of what they produced."""

    def __init__(self):
        self._lock = TrackedLock("fixture.DeviceReader._lock")
        self._last = None

    def refresh(self, t):
        torch.cuda.synchronize()
        host = t.cpu()
        with self._lock:
            self._last = host
