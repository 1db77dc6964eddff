"""The port's device-side band cost build (B7's ``device_cost_build``)
against the JAX package's program, bit for bit.

The reference builds band 2's planes inside ``jit``, where XLA's CPU
compiler contracts three multiply-adds of the float32 load cost into
fused multiply-adds.  The port's build reproduces that order, so its
planes are held bit-equal to ``jax.jit(device_cost_build)`` on the
reference test's parametrisation (seeds, observed usage, selectors,
waits), on full-width ``[32, 10240]`` planes with the model's default
weights and with weights whose products round (where an op-by-op build
differs from the jitted one), and its integer surfaces to the host twin
``int_surfaces_host`` and the host cost build.

The JAX package is imported inside the tests, so on the card the
``cuda``-marked test runs without the repository's conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_device_build.py
"""

import numpy as np
import pytest
import torch

from poseidon_tpu_torch.costmodel import device_build as DB
from poseidon_tpu_torch.costmodel.cpu_mem import CpuMemCostModel
from poseidon_tpu_torch.ops.transport import INF_COST


def _tables(rng, E, M, *, obs=False, selectors=False, waits=False):
    """The reference test's tables (tests/test_device_build.py) as the
    keyword arguments of ``ECTable`` and ``MachineTable``."""
    ec = dict(
        ec_ids=np.arange(E, dtype=np.uint64),
        cpu_request=rng.integers(0, 4000, size=E).astype(np.int64),
        ram_request=rng.integers(1 << 16, 1 << 22, size=E).astype(np.int64),
        supply=rng.integers(1, 8, size=E).astype(np.int32),
        priority=np.zeros(E, dtype=np.int32),
        task_type=np.zeros(E, dtype=np.int32),
        max_wait_rounds=(
            rng.integers(0, 40, size=E).astype(np.int32) if waits
            else np.zeros(E, dtype=np.int32)
        ),
        selectors=[
            ((0, "zone", ("a",)),) if selectors and i % 3 == 0 else ()
            for i in range(E)
        ],
    )
    cpu_cap = rng.integers(4000, 64000, size=M).astype(np.int64)
    ram_cap = rng.integers(1 << 22, 1 << 26, size=M).astype(np.int64)
    cpu_used = (cpu_cap * rng.random(M) * 0.8).astype(np.int64)
    ram_used = (ram_cap * rng.random(M) * 0.8).astype(np.int64)
    mt = dict(
        uuids=[f"m{m}" for m in range(M)],
        cpu_capacity=cpu_cap, ram_capacity=ram_cap,
        cpu_used=cpu_used, ram_used=ram_used,
        cpu_util=rng.random(M).astype(np.float32),
        mem_util=rng.random(M).astype(np.float32),
        slots_free=rng.integers(0, 64, size=M).astype(np.int32),
        labels=[{"zone": "a" if m % 2 == 0 else "b"} for m in range(M)],
    )
    if obs:
        mt["cpu_obs_used"] = (cpu_used * rng.uniform(0.5, 1.5, M)).astype(
            np.int64)
        mt["ram_obs_used"] = (ram_used * rng.uniform(0.5, 1.5, M)).astype(
            np.int64)
    return ec, mt


def _deltas(rng, M):
    return (rng.integers(0, 2000, size=M).astype(np.int32),
            rng.integers(0, 1 << 20, size=M).astype(np.int32),
            rng.integers(0, 8, size=M).astype(np.int32))


def _to_device(ops: dict, device) -> dict:
    """``extract_band_operands``' numpy dict as tensors on ``device`` (the
    float weights as float32 0-d tensors, ``anti_self`` as int32), as the
    chained program hands them to the build."""
    return {k: torch.from_numpy(np.ascontiguousarray(
                np.asarray(v).astype(np.int32) if k == "anti_self"
                else np.asarray(v))).to(device)
            for k, v in ops.items()}


def _port_build(ops, deltas):
    t = _to_device(ops, "cpu")
    out = DB.device_cost_build(t, *(torch.from_numpy(d) for d in deltas))
    return [x.numpy() for x in out]


def _jit_build(ops, deltas):
    import jax

    from poseidon_tpu.costmodel.device_build import device_cost_build

    return [np.asarray(x) for x in jax.jit(device_cost_build)(ops, *deltas)]


def _weights(weights):
    return {} if weights is None else dict(measured_weight=weights[0],
                                           cpu_weight=weights[1])


def _port_ops(seed, E, M, weights=None, **kw):
    from poseidon_tpu_torch.costmodel.base import ECTable, MachineTable

    rng = np.random.default_rng(seed)
    ec, mt = _tables(rng, E, M, **kw)
    ops = DB.extract_band_operands(ECTable(**ec), MachineTable(**mt),
                                   CpuMemCostModel(**_weights(weights)))
    return ops, _deltas(rng, M)


def _both_ops(seed, E, M, weights=None, **kw):
    from poseidon_tpu.costmodel.base import ECTable, MachineTable
    from poseidon_tpu.costmodel.cpu_mem import CpuMemCostModel as JCpuMem
    from poseidon_tpu.costmodel.device_build import (
        extract_band_operands as j_extract,
    )

    ec, mt = _tables(np.random.default_rng(seed), E, M, **kw)
    jops = j_extract(ECTable(**ec), MachineTable(**mt),
                     JCpuMem(**_weights(weights)))
    tops, deltas = _port_ops(seed, E, M, weights, **kw)
    return jops, tops, deltas


@pytest.mark.parametrize("seed,obs,selectors,waits", [
    (0, False, False, False),
    (1, True, False, True),
    (2, False, True, False),
    (3, True, True, True),
])
def test_device_build_bit_equal_to_jitted_reference(seed, obs, selectors,
                                                     waits):
    jops, tops, deltas = _both_ops(seed, 24, 60, obs=obs,
                                   selectors=selectors, waits=waits)
    assert jops.keys() == tops.keys()
    for k in jops:
        np.testing.assert_array_equal(np.asarray(jops[k]),
                                      np.asarray(tops[k]), k)
    ref = _jit_build(jops, deltas)
    got = _port_build(tops, deltas)
    for name, r, g in zip(("costs", "arc_cap", "capacity", "col_cap"),
                          ref, got):
        assert g.dtype == np.int32, name
        np.testing.assert_array_equal(g, r, name)
    if selectors:
        assert (got[0] >= INF_COST).any()


@pytest.mark.parametrize("seed,weights", [
    (0, None), (1, (0.37, 0.71)), (2, (0.1, 0.3)),
])
def test_full_width_plane_follows_the_jit_contraction(seed, weights):
    """``[32, 10240]`` planes: bit-equal to the jitted program.  With
    weights whose products round, the op-by-op (eager) reference build
    differs from the jitted one, so this plane does show the
    contraction the port reproduces."""
    from poseidon_tpu.costmodel.device_build import device_cost_build

    jops, tops, deltas = _both_ops(seed, 32, 10240, weights=weights,
                                   obs=True)
    ref = _jit_build(jops, deltas)
    got = _port_build(tops, deltas)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    if weights is not None:
        eager = np.asarray(device_cost_build(jops, *deltas)[0])
        assert (eager != ref[0]).any()


def test_fma32_rounds_once():
    """The one case a float64 sum rounded twice gets wrong: the exact
    ``a * b + c`` lies just below a float32 midpoint, and its float64
    rounding lands on the midpoint (ties to even would round up)."""
    a = torch.tensor([2.0 ** -24 * (1 + 2.0 ** -18)], dtype=torch.float32)
    b = torch.tensor([1 - 2.0 ** -18], dtype=torch.float32)
    c = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    naive = (a.double() * b.double() + c.double()).float()
    assert naive.item() == 1 + 2.0 ** -22
    assert DB._fma32(a, b, c).item() == 1 + 2.0 ** -23
    # Exact cases stay exact, and signs are honoured.
    x = torch.tensor([0.25, -0.5, 3.0], dtype=torch.float32)
    y = torch.tensor([0.5, 0.5, -2.0], dtype=torch.float32)
    z = torch.tensor([1.0, 1.0, 1.0], dtype=torch.float32)
    assert DB._fma32(x, y, z).tolist() == [1.125, 0.75, -5.0]


def test_unsched_escalator_and_host_integer_surfaces_match_reference():
    """``extract_band_operands``' unsched escalator equals the model's
    host build, and ``int_surfaces_host`` equals both the reference's
    twin and the port's device build."""
    from poseidon_tpu.costmodel.device_build import (
        int_surfaces_host as j_int_surfaces,
    )

    jops, tops, _ = _both_ops(17, 16, 40, obs=True, selectors=True,
                              waits=True)
    from poseidon_tpu_torch.costmodel.base import ECTable, MachineTable

    ec, mt = _tables(np.random.default_rng(9), 8, 10, waits=True)
    tec, tmt = ECTable(**ec), MachineTable(**mt)
    np.testing.assert_array_equal(
        DB.extract_band_operands(tec, tmt, CpuMemCostModel())["unsched"],
        CpuMemCostModel().build(tec, tmt).unsched_cost)
    rng = np.random.default_rng(17)
    d64 = (rng.integers(0, 3000, size=40).astype(np.int64),
           rng.integers(0, 1 << 21, size=40).astype(np.int64),
           rng.integers(0, 6, size=40).astype(np.int64))
    jops["anti_self"] = jops["anti_self"].astype(np.int32)
    tops["anti_self"] = tops["anti_self"].astype(np.int32)
    _c, arc_d, cap_d, col_d = _port_build(
        tops, tuple(d.astype(np.int32) for d in d64))
    host = DB.int_surfaces_host(tops, *d64)
    ref = j_int_surfaces(jops, *d64)
    for h, r, d in zip(host, ref, (arc_d, cap_d, col_d)):
        np.testing.assert_array_equal(h, r)
        np.testing.assert_array_equal(h, d)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_build_on_the_card_equals_the_cpu(cuda_device):
    """The same formula on the card: bit-equal to the CPU build."""
    tops, deltas = _port_ops(1, 32, 10240, weights=(0.37, 0.71), obs=True)
    cpu = _port_build(tops, deltas)
    t = _to_device(tops, cuda_device)
    gpu = DB.device_cost_build(
        t, *(torch.from_numpy(d).to(cuda_device) for d in deltas))
    for c, g in zip(cpu, gpu):
        np.testing.assert_array_equal(c, g.cpu().numpy())
