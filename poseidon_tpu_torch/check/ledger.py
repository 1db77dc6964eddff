"""Runtime compile, transfer and numerics ledgers: exact budgets for the
silent per-round costs, in torch terms (the port of the JAX package's
``check/ledger.py``, with the same API and the same window contract).

- ``fresh_compile_count()``: a process-wide monotonic counter of compile
  events.  The reference counts XLA backend compiles, whose key is the
  padded shape plus scale.  The port compiles nothing per shape, so its
  compile events are:

  - a kernel build or library load (``ops/_kernels.lib``, the native
    graph core's ``native/bindings``), once per process;
  - the **first sight in the process of a solve key**: the route, the
    padded shape and the scale of a device solve (``note_solve_key``,
    called where ``transport._Telemetry.routes`` records the solve), and
    the one-program coarse solve's own key.

  Keys count whatever the route, so a CPU run holds the warm-round gate
  too.  Callers difference the counter around a window, exactly like
  ``transport.device_call_count()`` (``RoundMetrics.fresh_compiles``).
  ``CompileLedger`` wraps a window in an exact budget and names what
  compiled.  The reference's ``retrace_count`` (jaxpr traces that hit
  the executable cache) has no torch event, so the port has no such
  counter: a documented divergence.

- ``TransferLedger``: counts *implicit* device-to-host synchronizations.
  An install-once interposer over the scalar-sync methods the reference
  interposes (``item``/``tolist``/``__float__``/``__int__``/``__bool__``/
  ``__index__``) on ``torch.Tensor``, that list and no more, counts each
  call on a tensor on a CUDA device.  ``transport._host_read`` (the
  sanctioned seam, the reference's ``host_fetch``) reads through
  ``.cpu().numpy()``, which no interposed method serves, so it never
  counts.  Torch has no transfer guard, so the interposer is the only
  layer; ``np.asarray`` on a CUDA tensor raises in torch anyway.

- ``NumericsLedger``: the reference's value checks (non-finite floats,
  int32 values within 2^20 of the rails) run on what crosses
  ``_host_read`` while validation is on, and ``utils.numerics``
  saturation-certificate trips count too.

Each ledger's process counter is this package's own: the JAX package's
ledgers (which patch jax's array class) never see the port's events, nor
the port's theirs.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, List, Optional, Set

_lock = threading.Lock()

# ------------------------------------------------------------- compiles

_compile_count = 0
_active: List["CompileLedger"] = []
_solve_keys: Set[tuple] = set()
_key_captures: List[Set[tuple]] = []


def note_compile(name: str) -> None:
    """Record one compile event (a kernel build or library load, or a
    solve key's first sight), attributed to every open ledger."""
    global _compile_count
    with _lock:
        _compile_count += 1
        for led in _active:
            led._note(name)


def note_solve_key(key: tuple) -> bool:
    """Record a device solve's key; its first sight in the process is a
    compile event.  Returns True on a first sight."""
    with _lock:
        for cap in _key_captures:
            cap.add(key)
        if key in _solve_keys:
            return False
        _solve_keys.add(key)
    note_compile("solve " + "/".join(str(k) for k in key))
    return True


@contextmanager
def capture_solve_keys() -> Iterator[Set[tuple]]:
    """Collect every solve key noted while the window is open, first
    sight or not (the planner's precompile counts its keys this way)."""
    keys: Set[tuple] = set()
    with _lock:
        _key_captures.append(keys)
    try:
        yield keys
    finally:
        with _lock:
            _key_captures.remove(keys)


def fresh_compile_count() -> int:
    """Process-wide count of compile events.  Difference around a window
    (a scheduling round) the same way ``device_call_count`` is used."""
    return _compile_count


class CompileBudgetExceeded(AssertionError):
    """A ledger window saw more compile events than budgeted."""


class CompileLedger:
    """Context manager asserting an exact compile budget.

    >>> with CompileLedger(budget=0, label="warm gang round"):
    ...     planner.schedule_round()

    ``budget=None`` records without asserting (telemetry mode).  The
    assertion is raised from ``__exit__`` only when the body itself did
    not raise."""

    def __init__(self, budget: Optional[int] = 0, label: str = ""):
        self.budget = budget
        self.label = label
        self._fresh = 0
        self.compiled_names: List[str] = []

    @property
    def fresh_compiles(self) -> int:
        return self._fresh

    def _note(self, name: str) -> None:
        # Called under the module _lock (see note_compile).
        self._fresh += 1
        if len(self.compiled_names) < 32:  # cap the report, not the count
            self.compiled_names.append(name)

    def __enter__(self) -> "CompileLedger":
        with _lock:
            _active.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        with _lock:
            if self in _active:
                _active.remove(self)
        if exc_type is None and self.budget is not None \
                and self._fresh > self.budget:
            where = f" in {self.label}" if self.label else ""
            names = ", ".join(self.compiled_names) or "<names not captured>"
            raise CompileBudgetExceeded(
                f"{self._fresh} compile event(s){where}, budget "
                f"{self.budget}; compiled: {names}.  A warm path reached "
                "a solve key (route, padded shape, scale) the precompile "
                "did not cover."
            )
        return False


# ------------------------------------------------------------ transfers

# The scalar-coercion methods the reference interposes on its array
# class; each call on a CUDA tensor blocks the host on the device queue
# and ships the value — an implicit device-to-host sync.
_SYNC_METHODS = (
    "item", "tolist", "__float__", "__int__", "__bool__", "__index__",
)

_sync_installed = False
_transfer_count = 0
_transfer_active: List["TransferLedger"] = []


def _describe_sync(method: str, t) -> str:
    """`item() on torch.int32[] at transport.py:812` — the actionable
    half of a budget failure (a stack walk, paid only on a counted sync
    with a ledger open)."""
    import traceback

    try:
        desc = f"{method}() on {t.dtype}{list(t.shape)}"
    except Exception:  # noqa: BLE001 - description must never raise
        desc = f"{method}()"
    try:
        for frame in reversed(traceback.extract_stack(limit=16)):
            fn = frame.filename.replace("\\", "/")
            if "check/ledger.py" in fn or "/torch/" in fn:
                continue
            return f"{desc} at {fn.rsplit('/', 1)[-1]}:{frame.lineno}"
    except Exception:  # noqa: BLE001
        pass
    return desc


def _note_sync(method: str, t) -> None:
    # The description (a stack walk) is built outside the lock; the
    # counter bump and offender appends happen under it — the round's
    # worker threads may sync concurrently with the main thread.
    global _transfer_count
    with _lock:
        active = list(_transfer_active)
    desc = _describe_sync(method, t) if active else ""
    with _lock:
        _transfer_count += 1
        for led in _transfer_active:
            led._note(desc)


def _ensure_sync_interposer() -> None:
    """Patch the scalar-sync methods of ``torch.Tensor`` once,
    permanently (the reference's install posture)."""
    global _sync_installed
    if _sync_installed:
        return
    with _lock:
        if _sync_installed:
            return
        import torch

        for name in _SYNC_METHODS:
            orig = getattr(torch.Tensor, name, None)
            if orig is None:
                continue

            def make(method, orig):
                def wrapper(self, *args, **kwargs):
                    if self.is_cuda:
                        _note_sync(method, self)
                    return orig(self, *args, **kwargs)

                wrapper.__name__ = getattr(orig, "__name__", method)
                wrapper.__qualname__ = getattr(
                    orig, "__qualname__", method
                )
                wrapper._poseidon_sync_orig = orig
                return wrapper

            setattr(torch.Tensor, name, make(name, orig))
        _sync_installed = True


def implicit_transfer_count() -> int:
    """Process-wide count of implicit device-to-host scalar syncs since
    the first ledger/counter use.  Difference around a window exactly
    like ``fresh_compile_count``."""
    _ensure_sync_interposer()
    return _transfer_count


class TransferBudgetExceeded(AssertionError):
    """A ledger window performed more implicit device-to-host syncs than
    budgeted."""


class TransferLedger:
    """Context manager asserting an implicit-transfer budget.

    >>> with TransferLedger(budget=0, label="warm gang round"):
    ...     planner.schedule_round()

    ``budget=None`` records without asserting (telemetry mode).  The
    exit assertion names each offending sync with its call site."""

    def __init__(self, budget: Optional[int] = 0, label: str = ""):
        self.budget = budget
        self.label = label
        self._implicit = 0
        self.offenders: List[str] = []

    @property
    def implicit_transfers(self) -> int:
        return self._implicit

    def _note(self, desc: str) -> None:
        # Called under the module _lock (see _note_sync).
        self._implicit += 1
        if len(self.offenders) < 32:  # cap the report, not the count
            self.offenders.append(desc or "<unattributed sync>")

    def __enter__(self) -> "TransferLedger":
        _ensure_sync_interposer()
        with _lock:
            _transfer_active.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        with _lock:
            if self in _transfer_active:
                _transfer_active.remove(self)
        if exc_type is None and self.budget is not None \
                and self._implicit > self.budget:
            where = f" in {self.label}" if self.label else ""
            names = "; ".join(self.offenders) or "<not attributed>"
            raise TransferBudgetExceeded(
                f"{self._implicit} implicit device->host sync(s){where}, "
                f"budget {self.budget}: {names}.  Each blocks the host on "
                "the device queue — batch the values into the solve's "
                "sanctioned read (transport._host_read)."
            )
        return False


# ------------------------------------------------------------- numerics

# Declared int32 headroom at the host boundary: legit solver values stay
# at or below the 2^30 price/sentinel rails; a value inside the last
# 2^20 below the int32 rails is either a wrapped accumulation or a
# saturation-clamped one — both are anomalies to surface.
I32_FETCH_HEADROOM = 1 << 20
_I32_HI = (1 << 31) - 1 - I32_FETCH_HEADROOM
_I32_LO = -(1 << 31) + I32_FETCH_HEADROOM

_numeric_count = 0
_numerics_active: List["NumericsLedger"] = []


def numeric_anomaly_count() -> int:
    """Process-wide count of numeric anomalies (non-finite floats or
    int32 headroom violations at ``_host_read``, plus utils.numerics
    certificate trips)."""
    return _numeric_count


def note_numeric_anomaly(desc: str) -> None:
    """Record one numeric anomaly (also called by utils.numerics when a
    saturation certificate trips)."""
    global _numeric_count
    with _lock:
        _numeric_count += 1
        for led in _numerics_active:
            led._note(desc)


def numerics_enabled() -> bool:
    """Is boundary validation on?  True under the
    ``POSEIDON_NUMERICS_LEDGER`` hatch or inside any open
    ``NumericsLedger`` window — ``_host_read`` consults this before
    paying the array scans."""
    if _numerics_active:
        return True
    from poseidon_tpu_torch.utils.hatches import hatch_bool

    return hatch_bool("POSEIDON_NUMERICS_LEDGER")


def _validate_leaf(arr, site: str) -> None:
    import numpy as _np

    a = _np.asarray(arr)
    if a.size == 0:
        return
    if _np.issubdtype(a.dtype, _np.floating):
        bad = ~_np.isfinite(a)
        if bad.any():
            note_numeric_anomaly(
                f"{site}: non-finite {a.dtype}{list(a.shape)} "
                f"({int(bad.sum())} element(s), first at index "
                f"{tuple(int(i) for i in _np.argwhere(bad)[0])})"
            )
    elif a.dtype == _np.int32:
        lo, hi = int(a.min()), int(a.max())
        if lo < _I32_LO or hi > _I32_HI:
            note_numeric_anomaly(
                f"{site}: int32{list(a.shape)} within {I32_FETCH_HEADROOM} "
                f"of the int32 rails (min={lo}, max={hi}) — a wrapped or "
                "saturation-clamped accumulation"
            )


def maybe_validate_fetched(arr, site: str = "host_read") -> None:
    """Validate a fetched array when numerics validation is enabled:
    floats must be finite, int32 must hold the declared headroom.
    Anomalies are counted (and attributed to open ledgers), never raised
    here."""
    if not numerics_enabled():
        return
    try:
        _validate_leaf(arr, site)
    except Exception:  # noqa: BLE001 - validation must never break a read
        pass


class NumericsBudgetExceeded(AssertionError):
    """A ledger window observed more numeric anomalies than budgeted."""


class NumericsLedger:
    """Context manager asserting a numeric-anomaly budget.

    >>> with NumericsLedger(budget=0, label="warm gang round"):
    ...     planner.schedule_round()

    While the window is open, every ``_host_read`` crossing is validated
    and every ``utils.numerics`` certificate trip is attributed to the
    window.  ``budget=None`` records without asserting (telemetry mode).
    The assertion is raised from ``__exit__`` only when the body itself
    did not raise, naming each offender by array and site."""

    def __init__(self, budget: Optional[int] = 0, label: str = ""):
        self.budget = budget
        self.label = label
        self._anomalies = 0
        self.offenders: List[str] = []

    @property
    def anomalies(self) -> int:
        return self._anomalies

    def _note(self, desc: str) -> None:
        # Called under the module _lock (see note_numeric_anomaly).
        self._anomalies += 1
        if len(self.offenders) < 32:  # cap the report, not the count
            self.offenders.append(desc)

    def __enter__(self) -> "NumericsLedger":
        with _lock:
            _numerics_active.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        with _lock:
            if self in _numerics_active:
                _numerics_active.remove(self)
        if exc_type is None and self.budget is not None \
                and self._anomalies > self.budget:
            where = f" in {self.label}" if self.label else ""
            names = "; ".join(self.offenders) or "<not attributed>"
            raise NumericsBudgetExceeded(
                f"{self._anomalies} numeric anomaly(ies){where}, budget "
                f"{self.budget}: {names}.  A value wrapped, saturated, "
                "or went non-finite at the host boundary; utils.numerics "
                "carries the certified widening helpers."
            )
        return False
