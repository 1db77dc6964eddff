"""retrace-guard clean fixture (torch): the sanctioned boundary patterns.

The library is built and loaded once, by ``lib()``; varying counts are
bucketed before they become solve keys or launch shapes; wrappers get
ints and int32 tensors.  Zero findings expected.
"""

import ctypes

import torch

from poseidon_tpu_torch.check import ledger as _ledger
from poseidon_tpu_torch.ops import _kernels

_LIB = None


def bucket_size(n: int, lo: int = 32) -> int:
    """Stand-in for the transport padding helper: quantized extents."""
    if n <= lo:
        return lo
    return 1 << (n - 1).bit_length()


def lib():
    # The one cached loader: loading here is the sanctioned pattern.
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL("libfixture.so")
    return _LIB


def kernel(x, eps, *, scale):
    so = _kernels.lib()
    return so.pt_kernel(x.data_ptr(), int(eps), scale)


def padded_call(xs):
    # len() is fine when it feeds the padding helper: the bucketed
    # extent is the launch shape, not the raw count.
    m_pad = bucket_size(len(xs))
    buf = torch.zeros(m_pad, dtype=torch.int32)
    buf[: len(xs)] = torch.as_tensor(xs, dtype=torch.int32)
    _ledger.note_solve_key(("fused", m_pad, bucket_size(len(xs), 8)))
    return kernel(buf, 0, scale=4)


def int_scalars(xs, budget):
    # Python ints go through as ints.
    return kernel(xs, budget, scale=8)
