"""jit-purity clean fixture (torch): kernel wrappers whose launches run
back to back, with host reads only before the first launch, after the
last one, or on the CPU branch that runs the plain version."""

import numpy as np
import torch

from poseidon_tpu_torch.ops import _kernels


def _plain(x):
    # The CPU branch's plain version: not between launches.
    return int(x.sum().item())


def two_launches(x: torch.Tensor, eps):
    if x.device.type == "cpu":
        return _plain(x)
    n = int(x.shape[0])                   # metadata, not a host read
    so = _kernels.lib()
    ws = torch.zeros(n, dtype=torch.int32, device=x.device)
    so.pt_first(x.data_ptr(), ws.data_ptr(), n)
    out = torch.empty_like(ws)            # allocation between launches
    so.pt_second(ws.data_ptr(), out.data_ptr(), int(eps))
    return int(out[0].item())             # after the last launch


def looped(blocks):
    stats = torch.zeros(len(blocks), dtype=torch.int32)
    for j, b in enumerate(blocks):
        _kernels.lib().pt_block(b.data_ptr(), stats[j:].data_ptr())
    return np.asarray(stats.cpu())        # after the loop of launches


def host_only(arr):
    # No launch at all: numpy and reads are fine.
    a = np.asarray(arr, dtype=np.int32)
    return float(a.sum())
