"""jit-purity violation fixture (torch): host reads between launches.

Expected findings (tests/test_torch_check_selfcheck.py asserts these):
  - np.asarray / np.array of a tensor between launches     (2)
  - .item() between launches                               (1)
  - float() / int() of a tensor between launches           (2)
  - .cpu() between launches (the device_get counterpart)   (1)
  - torch.cuda.synchronize() between launches              (1)
  - .tolist() in a callee the stretch calls                (1)
  - print has no torch meaning: not flagged
  - the suppressed np.asarray does NOT count
"""

import numpy as np
import torch

from poseidon_tpu_torch.ops import _kernels


def _leaky_callee(t):
    # Called between the launches: joins the scope through the closure.
    print("inside the stretch")
    return t.tolist()                     # VIOLATION: host read


def leaky_wrapper(x: torch.Tensor):
    so = _kernels.lib()
    so.pt_first(x.data_ptr())
    y = np.asarray(x)                     # VIOLATION: host materialization
    z = np.array(x + 1)                   # VIOLATION: host materialization
    h = x.cpu()                           # VIOLATION: device->host copy
    s = x.sum().item()                    # VIOLATION: .item() sync
    f = float(x[0])                       # VIOLATION: tensor cast
    i = int(x.sum())                      # VIOLATION: tensor cast
    torch.cuda.synchronize()              # VIOLATION: drains the queue
    print("shape", x.shape)               # no torch meaning
    ok = np.asarray(x)                    # posecheck: ignore[jit-purity]
    lst = _leaky_callee(x)
    so.pt_second(x.data_ptr(), int(s + f + i), len(lst))
    return y, z, h, ok


class Looped:
    def __call__(self, blocks):
        out = []
        for b in blocks:
            _kernels.lib().pt_block(b.data_ptr())
            out.append(b)
        return out
