"""lock-discipline clean fixture: every guarded write holds the lock,
including the locked-helper pattern (private method only entered under
the lock) and recursion."""

import threading


class GuardedRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = {}          # construction-time writes are exempt
        self._index = {}
        self._threads = []        # never touched under the lock: unguarded

    def put(self, key, value):
        with self._lock:
            self._items[key] = value
            self._reindex(key, value)

    def _reindex(self, key, value):
        # Lock-held helper: every intra-class call site holds the lock.
        self._index[value] = key
        for child in getattr(value, "children", ()):
            self._reindex(key, child)

    def get(self, key):
        with self._lock:
            return self._items.get(key)

    def track(self, thread):
        # _threads is not lock-guarded (single-threaded setup path).
        self._threads.append(thread)


class CondQueue:
    def __init__(self):
        self._cond = threading.Condition()
        self._queue = []
        self._shutdown = False

    def add(self, item):
        with self._cond:
            if self._shutdown:
                return
            self._queue.append(item)
            self._cond.notify()

    def shut_down(self):
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()


class NoLocksHere:
    """Classes without a lock are out of the rule's jurisdiction."""

    def __init__(self):
        self._state = 0

    def bump(self):
        self._state += 1
