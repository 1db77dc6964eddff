"""numerics violation fixture (torch): seeded hazards (never imported).

Expected findings (12):
- i32-overflow (3): `*` between two int32-tagged tensors, narrowing
  `.to(torch.int32)` of a float-ish tracked name, narrowing
  `.to(torch.int32)` directly on a `torch.floor(...)` chain.
- inf-sentinel (4): `+` through a locally seeded INF_COST plane,
  `torch.sum` over that plane, `-` through a plane returned by a
  producer (cross-function lattice), `.sum()` over that returned plane.
- promotion (5): the parity trap twice (an int32 tensor's `.sum()` and
  `torch.cumsum` without dtype=, where the reference's int32 `np.sum`
  and `.cumsum()` wrap), a Name-vs-Name dtype mix inside a kernel
  wrapper, a Python float literal against an int32-tagged operand
  inside a kernel wrapper, a Python float literal passed positionally
  to a kernel wrapper.

Two seeded hazards carry `# posecheck: ignore[numerics]` (one per-file
promotion, one finalize-path sentinel binop) and must NOT count.
"""

import torch

from poseidon_tpu_torch.ops import _kernels

INF_COST = 1 << 28


def overflowing_counts():
    counts = torch.zeros((4, 8), dtype=torch.int32)
    total = counts.sum()                    # VIOLATION: int64, not int32
    running = torch.cumsum(counts, 1)       # VIOLATION: int64, not int32
    other = torch.ones((4, 8), dtype=torch.int32)
    pairs = counts * other                  # VIOLATION: i32 * i32 product
    # Documented: the fixture wants the int64 total here.
    bounded = counts.sum()  # posecheck: ignore[numerics]
    return total, running, pairs, bounded


def narrowing_casts(free, req):
    n = torch.floor(free / torch.maximum(req, torch.ones_like(req)))
    cap = n.to(torch.int32)                 # VIOLATION: unclamped narrow
    cap2 = torch.floor(free / req).to(torch.int32)  # VIOLATION: inline
    return cap, cap2


def hot_total(base, forbidden, penalty):
    plane = torch.where(forbidden, INF_COST, base)
    tot = plane + penalty                   # VIOLATION: + through sentinels
    s = torch.sum(plane)                    # VIOLATION: sum mixes sentinels
    # Justified: the fixture pretends a downstream isfinite guard.
    t2 = plane + penalty  # posecheck: ignore[numerics]
    safe = torch.where(plane >= INF_COST, 0, plane)
    ok = torch.sum(safe)                    # clean: integer-guarded
    return tot, s, t2, ok


def _seed_plane(c):
    p = torch.where(c > 9, INF_COST, c)
    return p


def consume(c, drift):
    out = _seed_plane(c)
    bad = out - drift                       # VIOLATION: via producer
    tot = out.sum()                         # VIOLATION: via producer
    return bad, tot


def mix(a, b):
    x = a.to(torch.float32)
    y = b.to(torch.int32)
    xy = x * y                              # VIOLATION: f32 * i32 mix
    z = y * 0.5                             # VIOLATION: float vs i32
    _kernels.lib().pt_mix(xy.data_ptr(), z.data_ptr())
    return xy + z


def boundary_caller(a):
    return mix(a, 2.5)                      # VIOLATION: float literal
