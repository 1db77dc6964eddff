"""dispatch-budget violation fixture (torch): routes without warm-up.

Expected findings (tests/test_torch_check_selfcheck.py asserts these):
  - ``uncovered_wrapper``: a kernel wrapper precompile never reaches (1)
  - ``orphan_key``: a solve key nothing reaches                      (1)
  - ``covered_wrapper`` is reached through precompile: no finding
  - ``opted_out`` carries the explicit suppression: no finding
"""

from poseidon_tpu_torch.check import ledger as _ledger
from poseidon_tpu_torch.ops import _kernels


def covered_wrapper(x):
    return _kernels.lib().pt_covered(x.data_ptr())


def uncovered_wrapper(x, n):
    # VIOLATION: no path from precompile() reaches this wrapper — its
    # first production launch loads the library in a live round.
    so = _kernels.lib()
    return so.pt_uncovered(x.data_ptr(), n)


def orphan_key(e_pad, m_pad):  # VIOLATION: orphaned solve key
    _ledger.note_solve_key(("orphan", e_pad, m_pad))


def opted_out(x):  # posecheck: ignore[dispatch-budget]
    return _kernels.lib().pt_opted_out(x.data_ptr())


def precompile():
    return covered_wrapper(None)
