"""transfer-discipline violation fixture (torch): seeded implicit syncs.

Expected findings (tests/test_torch_check_selfcheck.py asserts these):
  - scalar syncs on a wrapper's results: float / item / int / tolist (4)
  - np materialization of a wrapper's result outside a boundary    (1)
  - .cpu() outside a declared boundary (device_get's counterpart)  (1)
  - scalar sync on a tensor placed on CUDA                         (1)
  - donation has no torch meaning: nothing to seed
  - the suppressed np.asarray does NOT count
"""

import numpy as np
import torch

from poseidon_tpu_torch.ops import _kernels


def _kernel(x):
    out = torch.empty_like(x)
    _kernels.lib().pt_kernel(x.data_ptr(), out.data_ptr())
    return out, out.sum(dtype=torch.int32)


def leaky_wrapper(x):
    F, s = _kernel(x)
    a = float(s)                  # VIOLATION: implicit scalar sync
    b = s.item()                  # VIOLATION: implicit scalar sync
    c = int(F[0, 0])              # VIOLATION: implicit scalar sync
    lst = F.tolist()              # VIOLATION: implicit scalar sync
    host = np.asarray(F)          # VIOLATION: implicit materialization
    got = s.cpu()                 # VIOLATION: read off the boundary
    ok = np.asarray(F)            # posecheck: ignore[transfer-discipline]
    return a, b, c, lst, host, got, ok


def placed(n):
    t = torch.ones(n, dtype=torch.int32).cuda()
    return bool(t[0])             # VIOLATION: implicit scalar sync
