"""lock-discipline violation fixture: unlocked writes to guarded state.

Expected findings:
  - plain assignment outside the lock           (1: racy_set)
  - subscript store outside the lock            (1: racy_put)
  - mutating method call outside the lock       (1: racy_append)
  - augmented assignment outside the lock       (1: racy_bump)
  - helper with one unlocked call site is NOT lock-held; its write flags (1)
  - thread-target escape defeats lock-held inference                     (1)
  - suppressed unlocked write does NOT count
"""

import threading
from threading import Condition


class RacyRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = {}
        self._count = 0
        self._log = []

    def put(self, key, value):
        with self._lock:
            self._items[key] = value
            self._count += 1
            self._log.append(key)

    def racy_set(self):
        self._items = {}                    # VIOLATION: assignment

    def racy_put(self, key, value):
        self._items[key] = value            # VIOLATION: subscript store

    def racy_append(self, key):
        self._log.append(key)               # VIOLATION: mutation call

    def racy_bump(self):
        self._count += 1                    # VIOLATION: augmented assign

    def locked_then_not(self, key):
        with self._lock:
            self._helper(key)
        self._helper(key)                   # unlocked call site...

    def _helper(self, key):
        self._items[key] = 1                # VIOLATION: not lock-held

    def intentional(self):
        self._count = 0                     # posecheck: ignore[lock-discipline]


class ThreadTargetEscape:
    """A locked call site must not exempt a method that also escapes as a
    thread target — it runs unlocked on its own thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}

    def start(self):
        t = threading.Thread(target=self._worker)   # escapes _worker
        t.start()

    def sync_path(self, key):
        with self._lock:
            self._state[key] = 0
            self._worker()                  # the (only) lexical call site

    def _worker(self):
        self._state["tick"] = 1             # VIOLATION: runs on the thread


class RacyCond:
    def __init__(self):
        self._cond = Condition()
        self._queue = []

    def add(self, item):
        with self._cond:
            self._queue.append(item)
            self._cond.notify()

    def drop_all(self):
        self._queue.clear()                 # VIOLATION: mutation call
