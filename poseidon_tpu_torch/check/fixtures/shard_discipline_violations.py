"""shard-discipline violation fixture (torch): seeded mesh-hygiene breaks.

Expected findings (tests/test_torch_check_selfcheck.py asserts these):
  - a per-shard machine-axis reduction that reaches a result
    without a collective (the reference's collective-outside-
    shard_map counterpart)                                          (1)
  - per-shard column blocks cut with no pad-to-mesh-multiple       (1)
  - a sharded solve key unreachable from precompile                (1)
  - the axis-name sub-checks have no torch meaning: nothing to seed
  - ``covered_solve`` is precompile-reachable: no finding
  - ``opted_out_solve`` carries ignore[dispatch-budget]: no finding
"""

import torch

from poseidon_tpu_torch.check import ledger as _ledger


class _Collectives:
    def __init__(self, devices):
        self.devices = tuple(devices)

    def reduce(self, op, parts):
        return [torch.stack(parts).sum(0)] * len(self.devices)


def _row_sums(F, *, coll):
    reduced = coll.reduce("sum", [f.sum(1) for f in F])
    # VIOLATION: shard-local row maxima used as the global ones.
    local_max = [f.amax(1) for f in F]
    return reduced, local_max


def unpadded_blocks(costs, devices):
    # VIOLATION: cuts the machine axis with no pad or divisibility guard.
    coll = _Collectives(devices)
    b = costs.shape[1] // len(devices)
    blocks = [costs[:, j * b:(j + 1) * b].to(d)
              for j, d in enumerate(devices)]
    return _row_sums(blocks, coll=coll)


def covered_solve(costs, devices):
    _ledger.note_solve_key(("sharded", costs.shape[0], 8))
    return unpadded_blocks(costs, devices)


def orphan_solve(e_pad, m_pad):
    # VIOLATION: a sharded solve key precompile never reaches.
    _ledger.note_solve_key(("sharded", e_pad, m_pad))


def opted_out_solve(e_pad):  # posecheck: ignore[dispatch-budget]
    _ledger.note_solve_key(("sharded", e_pad, 8))


def precompile():
    return covered_solve(torch.zeros((2, 4)), ["cpu"])
