"""Seeded concurrency violations (lock-order / blocking-under-lock /
unsafe-publication) for the posecheck self-tests.  Counts are asserted
exactly in tests/test_torch_check_selfcheck.py — keep them in sync.

Expected: 2 lock-order cycles, 9 blocking-under-lock (the reference's
five shapes and four device waits), 2 unsafe-publication.
"""

import queue
import threading
import time

import torch

from poseidon_tpu_torch.ops import _kernels
from poseidon_tpu_torch.ops.transport import _host_read


class TwoLocks:
    """In-class cycle: ``forward`` nests _a -> _b, ``backward`` nests
    _b -> _a — the textbook AB/BA deadlock."""

    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self.count = 0

    def forward(self):
        with self._a:
            with self._b:
                self.count += 1

    def backward(self):
        with self._b:
            with self._a:
                self.count -= 1


class Outer:
    """Cross-class cycle with :class:`Inner`: ``poke`` calls into
    Inner.submit while holding _mu; Inner.callback calls back into
    ``refresh`` while holding _gate."""

    def __init__(self):
        self._mu = threading.Lock()
        self.seen = 0

    def poke(self, inner):
        with self._mu:
            inner.submit()

    def refresh(self):
        with self._mu:
            self.seen += 1


class Inner:
    def __init__(self):
        self._gate = threading.Lock()
        self.pending = 0

    def submit(self):
        with self._gate:
            self.pending += 1

    def callback(self, outer):
        with self._gate:
            outer.refresh()


class Blocker:
    """Five distinct park-under-lock shapes, one legal Condition.wait,
    one suppressed sleep."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition()
        self._q = queue.Queue()
        self.ready = False

    def sleepy(self):
        with self._lock:
            time.sleep(0.1)

    def joiny(self, worker):
        with self._lock:
            worker.join()

    def getty(self):
        with self._lock:
            return self._q.get()

    def resulty(self, fut):
        with self._lock:
            return fut.result()

    def waity(self, event):
        with self._lock:
            event.wait()

    def legal_condition_wait(self):
        # Condition.wait on the HELD lock releases it — the one legal
        # wait inside a critical section; must not be flagged.
        with self._cond:
            while not self.ready:
                self._cond.wait()

    def suppressed_sleep(self):
        with self._lock:
            time.sleep(0.0)  # posecheck: ignore[blocking-under-lock]


class DeviceBlocker:
    """The torch meaning of the reference's device dispatch under a
    lock: four device waits while a lock is held, one read after the
    lock is released."""

    def __init__(self):
        self._lock = threading.Lock()
        self.last = None

    def synced(self):
        with self._lock:
            torch.cuda.synchronize()

    def read_back(self, t):
        with self._lock:
            self.last = _host_read(t)

    def scalar(self, t):
        with self._lock:
            return t.item()

    def launch(self, x):
        so = _kernels.lib()
        with self._lock:
            so.pt_kernel(x.data_ptr())

    def read_outside(self, t):
        host = _host_read(t)
        with self._lock:
            self.last = host


class Publisher:
    """Spawns a thread, then republishes mutable state without a lock
    (two findings); the locked and handoff-annotated swaps are clean."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}
        self._snapshots = []
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        pass

    def reset(self):
        self._state = {}

    def snapshot(self, items):
        self._snapshots = [i for i in items]

    def rebuild_under_lock(self):
        with self._lock:
            self._state = {}

    def swap_documented(self):
        self._state = {}  # handoff: worker joined before the swap


class QuietPublisher:
    """No thread ever spawned: republication is single-threaded state,
    out of unsafe-publication's jurisdiction."""

    def __init__(self):
        self._cache = {}

    def reset(self):
        self._cache = {}
