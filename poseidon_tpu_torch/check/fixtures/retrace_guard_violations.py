"""retrace-guard violation fixture (torch): every per-call hazard, seeded.

Expected findings (tests/test_torch_check_selfcheck.py asserts these):
  - kernel library loaded inside a function / loop / nested def /
    class method / module-level loop (bare + if-gated)         (6)
  - solve key element derived from len() / .shape              (1)
  - unpadded len()-shaped tensor at the wrapper boundary       (1)
  - Python float literal passed to a wrapper                   (1)
  - str / bool arguments have no torch meaning: not flagged
  - the suppressed float literal does NOT count
"""

import ctypes

import torch

from poseidon_tpu_torch.check import ledger as _ledger
from poseidon_tpu_torch.ops import _kernels


def kernel(x, eps, *, scale):
    return _kernels.lib().pt_kernel(x.data_ptr(), eps, scale)


_LOADED = []
for _name in ("a.so", "b.so"):
    _LOADED.append(ctypes.CDLL(_name))        # VIOLATION: module loop

if len(_LOADED) < 4:
    for _name in ("c.so", "d.so"):
        # VIOLATION: gating the loop behind an `if` is still a load per
        # iteration.
        _LOADED.append(ctypes.cdll.LoadLibrary(_name))


class RoundDriver:
    def drive(self, xs):
        so = ctypes.CDLL("fixture.so")        # VIOLATION: per-call, method
        return so.pt_kernel(xs)


def fresh_library_per_call(xs):
    _kernels.build()                          # VIOLATION: per-call build
    return kernel(xs, 0, scale=1)


def fresh_library_in_loop(xs):
    out = []
    for x in xs:
        so = ctypes.CDLL("fixture.so")        # VIOLATION: per iteration
        out.append(so.pt_kernel(x))
    return out


def nested_loader(xs):
    def load():
        return ctypes.CDLL("fixture.so")      # VIOLATION: nested def

    return load().pt_kernel(xs)


def varying_key(xs, costs):
    _ledger.note_solve_key(("fused", len(xs), 128))   # VIOLATION: raw count
    return kernel(costs, 0, scale=2)


def str_and_bool(xs):
    # No torch meaning: a wrapper's Python arguments are no compile key.
    return kernel(xs, "fast", scale=True)


def unpadded_shape(xs):
    return kernel(torch.zeros(len(xs)), 0, scale=1)   # VIOLATION: shape


def float_operand(xs):
    return kernel(xs, 0.5, scale=2)           # VIOLATION: float operand


def suppressed_float(xs):
    return kernel(xs, 1.5, scale=2)  # posecheck: ignore[retrace-guard]
