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
"""

from __future__ import annotations

from typing import Tuple

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
        raise SaturationError(desc)
    return total
