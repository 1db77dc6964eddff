"""The port's kernel wrappers: their contract on the CPU, and each CUDA
kernel against its plain version on the card.

This file imports neither JAX nor the JAX package, so on the card it runs
without the repository's conftest (which imports JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The ``cuda`` tests decide in a fixture whether a card is present and skip
where there is none.
"""

import numpy as np
import pytest
import torch

from poseidon_tpu_torch.ops import _kernels
from poseidon_tpu_torch.ops import transport as T


def _packed(E, M, seed):
    """Packed operands of a contended cold solve, as solve_transport
    would dispatch them."""
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 1000, size=(E, M)).astype(np.int32)
    costs[rng.random((E, M)) < 0.1] = T.INF_COST
    supply = rng.integers(20, 60, size=E).astype(np.int32)
    cap = rng.integers(1, 4, size=M).astype(np.int32)
    unsched = rng.integers(1000, 2000, size=E).astype(np.int32)
    arc = rng.integers(1, 6, size=(E, M)).astype(np.int32)
    big = np.stack([costs, arc, np.zeros_like(costs)])
    scale, eps_sched, _ = T._host_validate(costs, supply, cap, unsched,
                                           None, None, 8000)
    vec = np.concatenate([
        supply, cap, unsched, np.zeros(E + M + 1, np.int32),
        np.zeros(E, np.int32), eps_sched,
        np.asarray([8192, 4, 64, 1], np.int32),
    ]).astype(np.int32)
    return big, vec, int(scale)


@pytest.mark.parametrize("impl", ["fused", "tiled"])
def test_wrappers_run_plain_versions_on_cpu_tensors(impl):
    """On CPU tensors a route's wrapper is its plain version: same bits
    as the plain ladder, and no kernel launch counted."""
    big, vec, scale = _packed(16, 128, 1)
    before = dict(_kernels.LAUNCHES)
    F, small = T._solve_device_packed(big, vec, max_iter=8192, scale=scale,
                                      impl=impl, device="cpu")
    F0, small0 = T._solve_device_packed(big, vec, max_iter=8192,
                                        scale=scale, impl="lax",
                                        device="cpu")
    np.testing.assert_array_equal(F.numpy(), F0.numpy())
    np.testing.assert_array_equal(small, small0)
    assert _kernels.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "layout", "device"])
def test_operand_check_rejects_what_the_kernels_do_not_take(bad):
    t = torch.zeros((4, 8), dtype=torch.int32)
    if bad == "dtype":
        t, exc = t.to(torch.int64), TypeError
    elif bad == "shape":
        t, exc = t[:, :4].contiguous(), ValueError
    elif bad == "layout":
        t, exc = t.t().contiguous().t(), ValueError
    else:
        exc = ValueError
    dev = torch.device("meta") if bad == "device" else t.device
    with pytest.raises(exc):
        _kernels.check(t, "x", (4, 8), dev)


def test_failed_launch_raises():
    with pytest.raises(RuntimeError, match="cudaError 2"):
        _kernels.launch_check(2, "fused_ladder")


def test_fused_ladder_shared_memory_covers_the_gate():
    """B1 holds pe and the two Bellman-Ford distance buffers ([E] int32
    each) and its stages' segment partials (four int32 buffers with one
    slot per unit, at most one unit per thread of its 1024-thread block)
    in dynamic shared memory sized from E: at every padded shape the
    route's gate admits, that size covers them and fits one H100 block
    (227 KB).  On the card, chip_smoke.py holds this size to the one the
    kernel computes."""
    from poseidon_tpu_torch.ops import transport_fused as TF

    m_pads = sorted({T.bucket_size(n) for n in range(1, 41_000)})
    e_pads = [8 << k for k in range(10)]
    admitted = [(e, m) for e in e_pads for m in m_pads if TF.fits_vmem(e, m)]
    assert (8, 20480) in admitted and (1024, 128) in admitted
    assert max(e for e, _ in admitted) == 1024
    assert max(m for _, m in admitted) == 20480
    for e, _m in admitted:
        need = 4 * 3 * e + 4 * 4 * 1024
        assert need < TF.ladder_smem_bytes(e) <= 227 * 1024


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl,E,M", [
    ("fused", 64, 1024),
    # B1's row and column segments at their edges: E and M not multiples
    # of 32, the gate's two extremes, and the wave's coarse shape.
    ("fused", 40, 300),
    ("fused", 64, 1000),
    ("fused", 8, 20480),
    ("fused", 1024, 128),
    ("fused", 128, 256),
    ("tiled", 64, 1024),
])
def test_kernel_matches_plain_on_card(cuda_device, impl, E, M):
    """Each kernel's whole solve against the plain ladder on the card:
    every output field bit-equal, and the kernel actually launched."""
    big, vec, scale = _packed(E, M, 3)
    key = "fused_ladder" if impl == "fused" else "tiled_iteration"
    n0 = _kernels.LAUNCHES[key]
    F, small = T._solve_device_packed(big, vec, max_iter=8192, scale=scale,
                                      impl=impl, device=cuda_device)
    F0, small0 = T._solve_device_packed(big, vec, max_iter=8192,
                                        scale=scale, impl="lax",
                                        device=cuda_device)
    np.testing.assert_array_equal(F.cpu().numpy(), F0.cpu().numpy())
    np.testing.assert_array_equal(small, small0)
    assert _kernels.LAUNCHES[key] > n0

