"""transfer-discipline clean fixture (torch): the declared-boundary idiom.

A wrapper's results are read ONCE, explicitly, at a host-boundary
function (``_host_read`` / ``_host_*``); scalars ride the same read.
Zero findings.
"""

import numpy as np
import torch

from poseidon_tpu_torch.ops import _kernels


def _kernel(x):
    out = torch.empty_like(x)
    _kernels.lib().pt_kernel(x.data_ptr(), out.data_ptr())
    return out, out.sum(dtype=torch.int32)


def _host_read(t):
    # The declared boundary: the one counted device->host read.
    return t.cpu().numpy()


def _host_decode(F, s):
    # _host_* prefix: a declared boundary — reading is its job.
    return np.asarray(F.cpu()), int(s.item())


def solve(x):
    F, s = _kernel(x)
    F = _host_read(F)             # one explicit boundary read
    total = float(_host_read(s))  # host value now: no sync
    return F[:2], total


def on_card(n):
    t = torch.zeros(n, dtype=torch.int32, device="cuda")
    return _host_decode(t, t.sum())


def pure_host(costs):
    # numpy-only host work never flags.
    padded = np.asarray(costs, dtype=np.int32)
    return int(padded.sum())
