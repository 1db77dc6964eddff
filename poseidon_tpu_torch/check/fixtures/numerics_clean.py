"""numerics clean fixture (torch): every hazard class from
numerics_violations.py, written the sanctioned way: int32 sums with a
declared ``dtype=torch.int32`` (the reference's int32 accumulator),
clamp-before-narrow, the certified narrow, sentinel planes consumed
through guards, index tensors drawn from a sentinel plane, and one
documented bound riding a justified suppression."""

import numpy as np
import torch

from poseidon_tpu_torch.ops import _kernels
from poseidon_tpu_torch.utils.numerics import checked_narrow_i32

INF_COST = 1 << 28
I32 = torch.int32


def declared_totals():
    counts = torch.zeros((4, 8), dtype=torch.int32)
    total = counts.sum(dtype=torch.int32)          # declared accumulator
    running = torch.cumsum(counts, 1, dtype=I32)   # declared accumulator
    wide = counts.sum(dtype=torch.int64)           # widened
    return total, running, wide


def bounded_narrows(free, req):
    big = (1 << 31) // 4
    n = torch.floor(free / torch.clamp(req, min=1))
    n = torch.clamp(n, max=big)                    # clamp before the cast
    cap = n.to(torch.int32)
    certified = checked_narrow_i32(np.asarray(free), site="fixture", hi=big)
    return cap, certified


def guarded_sentinels(base, forbidden, supply):
    plane = torch.where(forbidden, INF_COST, base)  # construction is legal
    worst = plane.amax()                            # min/max stay legal
    finite = torch.where(plane >= INF_COST, 0, plane)
    tot = torch.sum(finite)
    fin2 = torch.where(torch.isfinite(base), base, 0)
    tot2 = fin2.sum()
    # Positions drawn from a sentinel plane carry no sentinel: the
    # gathered values come from `supply`.
    order = torch.argsort(plane, dim=-1, stable=True)
    took = torch.gather(supply, -1, order)
    left = supply - took
    return worst, tot, tot2, left


def consistent_wrapper(a, b):
    x = a.to(torch.int32)
    y = b.to(torch.int32)
    z = x * 2 + y
    _kernels.lib().pt_kernel(z.data_ptr())
    return z


def documented_bound():
    counts = torch.zeros(8, dtype=torch.int32)
    # Bounded by construction: eight zero cells; the int64 is wanted.
    t = counts.sum()  # posecheck: ignore[numerics]
    return t
