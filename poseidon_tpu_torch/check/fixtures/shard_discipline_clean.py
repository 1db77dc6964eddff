"""shard-discipline clean fixture (torch): the transport_sharded idiom.

Per-shard machine-axis partials reduced through ``_Collectives``, the
machine axis padded to a mesh multiple before it is cut into blocks, and
the sharded solve key reachable from precompile.  Zero findings.
"""

import numpy as np
import torch

from poseidon_tpu_torch.check import ledger as _ledger


class _Collectives:
    def __init__(self, devices):
        self.devices = tuple(devices)

    def reduce(self, op, parts):
        s = torch.stack(parts)
        return [getattr(s, op)(0)] * len(self.devices)

    def exscan(self, parts):
        s = torch.stack(parts)
        inc = torch.cumsum(s, 0)
        return list(inc - s), inc[-1]


def _row_sums(F, *, coll):
    # Partials inside the collective's arguments.
    return coll.reduce("sum", [f.sum(1, dtype=torch.int32) for f in F])


def _push(cs_in, *, coll):
    # A local scan, then each shard's exclusive offset: the partial
    # feeds the collective, so the scan is the global one.
    cs = [torch.cumsum(c, 1) for c in cs_in]
    off, _ = coll.exscan([c[:, -1] for c in cs])
    return [c + o[:, None] for c, o in zip(cs, off)]


def _split(costs, devices):
    coll = _Collectives(devices)
    k = len(devices)
    m = costs.shape[1]
    m_pad = ((m + k - 1) // k) * k          # pad to a mesh multiple
    padded = np.zeros((costs.shape[0], m_pad), costs.dtype)
    padded[:, :m] = costs
    b = m_pad // k
    blocks = [torch.as_tensor(padded[:, j * b:(j + 1) * b]).to(d)
              for j, d in enumerate(devices)]
    return _row_sums(blocks, coll=coll)


def solve_sharded(costs, devices, e_pad, m_pad):
    _ledger.note_solve_key(("sharded", e_pad, m_pad, len(devices)))
    return _split(costs, devices)


def precompile():
    return solve_sharded(np.zeros((2, 4), np.int32), ["cpu"], 2, 4)
