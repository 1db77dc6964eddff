"""Saturation-certified int32 numerics helpers (the port's copy).

The solver substrate is int32 end to end, and int32 arithmetic wraps
silently in numpy and in torch alike.  Accumulate through these helpers
and the operation either carries a certificate that no wrap occurred or
raises ``SaturationError`` naming the offending array and site:

- ``widen_counts``: certified widening of an int32 count matrix to int64
  (the residency-count boundary);
- ``certify_i32``: a pure assertion that an int32 array sits inside its
  declared headroom;
- ``certify_i32_total``: the host-boundary certificate that the int32
  sum of an array (the solver's total supply) cannot wrap the kernels'
  int32 flow sums.
- ``checked_narrow_i32``: narrowing to int32 through a declared window,
  clamped or raising;
- ``i32_headroom``: the distance of an array's extrema from the int32
  rails, for callers that report rather than assert.

Failures raise ``SaturationError`` and are also counted as numeric
anomalies on the process-wide ``check.ledger.numeric_anomaly_count``
counter, so ``RoundMetrics.numeric_anomalies`` and the soak's budget-0
gate see certificate trips too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

I32_MAX = int(np.iinfo(np.int32).max)
I32_MIN = int(np.iinfo(np.int32).min)

# Default headroom band for count matrices: certify |count| <= 2^30, so
# a full round of single-step deltas (bounded by the int64 totals, which
# the planner keeps far below 2^30 mutations per round) cannot carry an
# in-range cell across the int32 rails before the next view certifies.
COUNT_HEADROOM = I32_MAX // 2


class SaturationError(AssertionError):
    """An int32 value left its certified headroom band (a wrap either
    happened or could no longer be ruled out).  Named by array/site."""


def _note_anomaly(desc: str) -> None:
    # Feed the process-wide anomaly counter; counting must never shadow
    # the SaturationError it accompanies.
    try:
        from poseidon_tpu_torch.check.ledger import note_numeric_anomaly

        note_numeric_anomaly(desc)
    except Exception:  # noqa: BLE001 - counting must never shadow the raise
        pass


def _extrema(arr: np.ndarray) -> Tuple[int, int]:
    return int(arr.min()), int(arr.max())


def certify_i32(arr: np.ndarray, *, site: str,
                headroom: int = COUNT_HEADROOM) -> np.ndarray:
    """Assert every element of an int32 array sits inside
    ``[I32_MIN + headroom, I32_MAX - headroom]``; returns ``arr``
    unchanged (zero-copy certificate).  Raises ``SaturationError``
    naming ``site`` and the offending extrema otherwise."""
    if arr.size == 0:
        return arr
    lo, hi = _extrema(arr)
    if lo < I32_MIN + headroom or hi > I32_MAX - headroom:
        desc = (
            f"{site}: int32{list(arr.shape)} outside certified headroom "
            f"band [{I32_MIN + headroom}, {I32_MAX - headroom}] "
            f"(min={lo}, max={hi})"
        )
        _note_anomaly(desc)
        raise SaturationError(desc)
    return arr


def widen_counts(arr: np.ndarray, *, site: str,
                 headroom: int = COUNT_HEADROOM) -> np.ndarray:
    """Certified widening of an int32 count matrix to int64.

    The returned array is an int64 copy (safe for any downstream
    reduction); the certificate is that every cell was inside the
    declared headroom band, so the int32 accumulation that produced it
    cannot have wrapped since the previous certified view."""
    certify_i32(np.asarray(arr), site=site, headroom=headroom)
    return np.asarray(arr, dtype=np.int64)


def certify_i32_total(arr: np.ndarray, *, site: str,
                      headroom: int = 1 << 20) -> int:
    """Certify that the int64 SUM of an int32 array fits int32 with
    ``headroom`` to spare, returning the total.

    The host-boundary form of the in-kernel flow-sum certificate: x64 is
    disabled on device, so kernel reductions over flows/supplies
    accumulate in int32.  Flow conservation bounds every such sum by the
    total supply — certifying the total ONCE at dispatch covers them
    all.  Raises ``SaturationError`` naming ``site`` otherwise."""
    a = np.asarray(arr)
    total = int(np.sum(a, dtype=np.int64)) if a.size else 0
    if not (I32_MIN + headroom <= total <= I32_MAX - headroom):
        desc = (
            f"{site}: total {total} of int32{list(a.shape)} outside the "
            f"certified band [{I32_MIN + headroom}, {I32_MAX - headroom}]"
            " — in-kernel int32 flow sums would wrap"
        )
        _note_anomaly(desc)
        raise SaturationError(desc)
    return total


def checked_narrow_i32(arr: np.ndarray, *, site: str,
                       lo: int = 0, hi: int = I32_MAX,
                       clamp: bool = True) -> np.ndarray:
    """Narrow a wider (int64/float) array to int32 through a declared
    ``[lo, hi]`` window.

    With ``clamp=True`` out-of-window values saturate at the window
    edges (the declared saturation bound); with ``clamp=False`` any
    out-of-window value raises ``SaturationError`` instead (use when
    clamping would silently alter semantics).  Either way the result is
    certified int32: no silent two's-complement wrap is reachable."""
    if not (I32_MIN <= lo <= hi <= I32_MAX):
        raise ValueError(
            f"{site}: narrow window [{lo}, {hi}] must sit inside int32"
        )
    a = np.asarray(arr)
    if a.size == 0:
        return a.astype(np.int32)
    amin, amax = a.min(), a.max()
    if amin < lo or amax > hi:
        if not clamp:
            desc = (
                f"{site}: {a.dtype}{list(a.shape)} outside declared "
                f"narrow window [{lo}, {hi}] (min={amin}, max={amax}) "
                "with clamping not declared legal"
            )
            _note_anomaly(desc)
            raise SaturationError(desc)
        a = np.clip(a, lo, hi)
    return a.astype(np.int32)


def i32_headroom(arr: np.ndarray) -> Optional[int]:
    """Remaining distance from the array's extrema to the int32 rails
    (``None`` for empty arrays) — the telemetry form of the headroom
    certificate, for callers that report rather than assert."""
    a = np.asarray(arr)
    if a.size == 0:
        return None
    lo, hi = _extrema(a)
    return int(min(I32_MAX - hi, lo - I32_MIN))
