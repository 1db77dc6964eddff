"""dispatch-budget clean fixture (torch): every kernel wrapper and every
solve key has warm-up coverage.

``precompile`` reaches the function wrapper through a host solve (the
``solve_transport`` shape), the wrapper class through its instances,
and the solve key directly.  Zero findings expected.
"""

from poseidon_tpu_torch.check import ledger as _ledger
from poseidon_tpu_torch.ops import _kernels


def kernel(x, scale):
    _kernels.LAUNCHES["kernel"] += 1
    return _kernels.lib().pt_kernel(x.data_ptr(), scale)


class Iteration:
    def __call__(self, x):
        so = _kernels.lib()
        return so.pt_iteration(x.data_ptr())


def solve(x, e_pad, m_pad):
    """Host solve around the launches (the solve_transport shape)."""
    _ledger.note_solve_key(("fused", e_pad, m_pad))
    kernel(x, 4)
    return Iteration()(x)


def precompile():
    """Warm every solve key the round paths can request."""
    return solve(None, 8, 128)
