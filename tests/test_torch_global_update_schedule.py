"""The global-update kernel's schedule (``ops/csrc/global_update.cu``) as
a numpy model, held bit-equal to the port's and the JAX package's
``_global_update`` on seeded mid-solve states.

The kernel splits the machine columns into blocks.  Each exchange runs
two Jacobi sweeps around one grid barrier: before it, every block takes
its columns' partial row minima over ``d_m^k`` and ``d_m^{k+1}`` and its
partial sink minima, and sends only those that can still lower a value;
after it, every block derives the same ``d_e^{k+1}``, ``d_t^{k+1}``,
``d_e^{k+2}`` and ``d_t^{k+2}``, then its columns' ``d_m^{k+2}`` and
``d_m^{k+3}``.  A convergence group of four sweeps is two exchanges; the
columns' part of its "changed" flag and their finite maximum go out with
the group's last exchange.  The model walks the same steps, block by
block, so a fault in that arithmetic shows here before the card runs it.
"""

import numpy as np
import pytest
import torch

from poseidon_tpu_torch.ops import transport as T

from test_torch_kernels import _late_column, _mid_solve

DINF = 1 << 24
# The kernel's length of a closed arc: any candidate at or past DINF
# loses to the old distance (at most DINF), as the plain version's DINF.
FAR = 1 << 30
INT_MIN = -(1 << 31)


def _finite(d):
    return np.where(d < DINF, d, 0)


def schedule_model(F, Ffb, Fmt, pe, pm, pt, exc_e, exc_m, exc_t, *, C, U,
                   Uem, supply, cap, adm, eps, bf_max, blocks):
    """``(pe, pm, pt, sweeps, barriers, exit)`` of one global update run
    as the kernel runs it over ``blocks`` column blocks; ``exit`` is
    "applied", "refused" (by the overflow guard) or "unconverged".
    Arrays are int64 numpy; ``pt``, ``exc_t`` shape ``[1]``."""
    E, M = C.shape
    pt, exc_t = int(pt[0]), int(exc_t[0])

    def length(x):
        return np.floor_divide(x, eps) + 1

    rc = C + pe[:, None] - pm[None, :]
    Lf = np.where(adm & (Uem - F > 0), length(rc), FAR)
    Lr = np.where(adm & (F > 0), length(-rc), FAR)
    r = U + pe - pt
    Lfb = np.where(supply - Ffb > 0, length(r), FAR)
    Ltfb = np.where(Ffb > 0, length(-r), FAR)
    Lmt = np.where(cap - Fmt > 0, length(pm - pt), FAR)
    Ltm = np.where(Fmt > 0, length(-(pm - pt)), FAR)
    cols = [c for c in np.array_split(np.arange(M), blocks) if c.size]

    def col_best(c, de):
        return (Lr[:, c] + de[:, None]).min(0)

    # Set-up, in every block: the row vectors, d_e^0, d_t^0; its columns'
    # d_m^0 and, by one column pass, d_m^1.
    de0 = np.where(exc_e < 0, 0, DINF)
    dt0 = 0 if exc_t < 0 else DINF
    dmA = [np.where(exc_m[c] < 0, 0, DINF) for c in cols]
    dmB = [np.minimum(a, np.minimum(col_best(c, de0), Lmt[c] + dt0))
           for a, c in zip(dmA, cols)]
    mvm = [bool((b != a).any()) for a, b in zip(dmA, dmB)]
    R1 = int((Ltfb + de0).min())
    sweeps = j = 0
    mve = mvt = False
    while True:
        # Before the barrier: each block's partials, sent only where they
        # can still lower the value every block derives after it.
        P1g = np.full(E, FAR)
        P2g = np.full(E, FAR)
        Q1g = Q2g = FAR
        MV, FM = False, INT_MIN
        ub1 = np.minimum(de0, Lfb + dt0)
        ubt1 = min(dt0, R1)
        for c, a, b, mv in zip(cols, dmA, dmB, mvm):
            P1 = (Lf[:, c] + a[None, :]).min(1)
            P2 = (Lf[:, c] + b[None, :]).min(1)
            P1g = np.where(P1 < ub1, np.minimum(P1g, P1), P1g)
            ub2 = np.minimum(ub1, P1)
            P2g = np.where(P2 < ub2, np.minimum(P2g, P2), P2g)
            Q1 = int((Ltm[c] + a).min())
            Q2 = int((Ltm[c] + b).min())
            if Q1 < ubt1:
                Q1g = min(Q1g, Q1)
            if Q2 < min(ubt1, Q1):
                Q2g = min(Q2g, Q2)
            if j % 2:  # the group's last exchange
                MV |= mv
                FM = max(FM, int(_finite(b).max()))
        # After the barrier: every block derives the same row and sink
        # distances two sweeps on.
        de1 = np.minimum(ub1, P1g)
        dt1 = min(ubt1, Q1g)
        de2 = np.minimum(de1, np.minimum(P2g, Lfb + dt1))
        R2 = int((Ltfb + de1).min())
        dt2 = min(dt1, Q2g, R2)
        R1 = int((Ltfb + de2).min())
        mve |= bool((de2 != de0).any())
        mvt |= dt2 != dt0
        if j % 2:
            sweeps += 4
            changed = MV or mve or mvt
            mve = mvt = False
            if not changed or sweeps > bf_max:
                break
        for i, c in enumerate(cols):
            a = np.minimum(dmB[i], np.minimum(col_best(c, de1),
                                              Lmt[c] + dt1))
            b = np.minimum(a, np.minimum(col_best(c, de2), Lmt[c] + dt2))
            moved = bool((a != dmB[i]).any())
            mvm[i] = (not j % 2 and (mvm[i] or moved)) or bool(
                (b != a).any())
            dmA[i], dmB[i] = a, b
        de0, dt0 = de2, dt2
        j += 1
    barriers = j + 1
    if changed:
        return pe, pm, np.asarray([pt]), sweeps, barriers, "unconverged"
    # Converged: the group's values held at every sweep within it, so the
    # columns' d_m^{s+3} (dmB) is the final d_m and FM its finite maximum.
    fm = max(FM, int(_finite(de2).max()), int(_finite(np.asarray(dt2))))
    if fm >= (1 << 26) // max(eps, 1):
        return pe, pm, np.asarray([pt]), sweeps, barriers, "refused"
    dm = np.concatenate(dmB)

    def apply(p, d):
        d = np.where(d >= DINF, fm + 1, d)
        return np.maximum(p - eps * d, T._NEG // 2)

    return (apply(pe, de2), apply(pm, dm),
            apply(np.asarray([pt]), np.asarray([dt2])), sweeps, barriers,
            "applied")


def _states(E, M, seed):
    """(label, eps, operands, state, excesses) covering the three exits:
    phase 0 and 1 states (applied), phase 1 cut at bf_max 0 (a group that
    still moved: unconverged), and the phase-0 state at eps 2^27, where
    the overflow guard refuses the converged update."""
    out = []
    for phase in (0, 1):
        ops, state, exc, eps = _mid_solve(E, M, seed, "cpu", phase=phase)
        out.append((f"phase {phase}", eps, ops, state, exc))
        if phase == 0:
            out.append(("phase 0 at eps 2^27", 1 << 27, ops, state, exc))
    return out


def _np(t):
    return t.numpy().astype(np.int64)


def _jax_update(ops, state, exc, eps, bf_max):
    import jax.numpy as jnp

    from poseidon_tpu.ops import transport as JT

    j = [jnp.asarray(t.numpy()) for t in (*state, *exc)]
    j[5], j[8] = j[5][0], j[8][0]  # pt, exc_t: scalars in the reference
    pe, pm, pt, sweeps = JT._global_update(
        *j, C=jnp.asarray(ops["C"].numpy()), U=jnp.asarray(ops["U"].numpy()),
        Uem=jnp.asarray(ops["Uem"].numpy()),
        supply=jnp.asarray(ops["supply"].numpy()),
        cap=jnp.asarray(ops["cap"].numpy()),
        admissible_arcs=jnp.asarray(ops["adm"].numpy()), eps=eps,
        bf_max=bf_max)
    return [np.asarray(pe), np.asarray(pm), np.asarray(pt).reshape(1),
            int(sweeps)]


@pytest.mark.parametrize("E,M,seed", [(16, 128, 1), (24, 100, 2),
                                      (1, 40, 3)])
@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_schedule_matches_plain_and_reference(E, M, seed, blocks):
    """The model against the port's ``_global_update`` and the JAX
    package's, bit for bit (pe, pm, pt, sweeps), at 1, 3 and 7 column
    blocks, with one barrier per two sweeps; the applied, refused and
    unconverged exits are all covered."""
    exits = set()
    for label, eps, ops, state, exc in _states(E, M, seed):
        for bf_max in (64, 0):
            acc = torch.zeros(1, dtype=torch.int32)
            gu = {k: ops[k] for k in ("C", "U", "Uem", "supply", "cap",
                                      "adm")}
            plain = T._global_update(*state, *exc, acc, eps=eps,
                                     bf_max=bf_max, **gu)
            want = [_np(t) for t in plain] + [int(acc[0])]
            got = schedule_model(
                *(_np(t) for t in (*state, *exc)),
                **{k: _np(v) for k, v in gu.items()}, eps=eps,
                bf_max=bf_max, blocks=blocks)
            ref = _jax_update(ops, state, exc, eps, bf_max)
            for w, g, r in zip(want, got, ref):
                np.testing.assert_array_equal(g, w, err_msg=label)
                np.testing.assert_array_equal(r, w, err_msg=label)
            assert got[4] == got[3] // 2
            exits.add(got[5])
    assert exits == {"applied", "refused", "unconverged"}, exits


@pytest.mark.parametrize("bf_max", [64, 4, 0])
@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_schedule_counts_a_column_that_falls_alone(blocks, bf_max):
    """A column whose value falls alone at sweep 5, the first of its
    group (``_late_column``): the group counts as moved, so the model, the
    port and the JAX package all run 12 sweeps and apply; cut at bf_max 4
    they stop after 8, unconverged."""
    ops, state, exc, eps = _late_column(4, 40, "cpu")
    acc = torch.zeros(1, dtype=torch.int32)
    gu = {k: ops[k] for k in ("C", "U", "Uem", "supply", "cap", "adm")}
    plain = T._global_update(*state, *exc, acc, eps=eps, bf_max=bf_max,
                             **gu)
    want = [_np(t) for t in plain] + [int(acc[0])]
    got = schedule_model(*(_np(t) for t in (*state, *exc)),
                         **{k: _np(v) for k, v in gu.items()}, eps=eps,
                         bf_max=bf_max, blocks=blocks)
    ref = _jax_update(ops, state, exc, eps, bf_max)
    for w, g, r in zip(want, got, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(r, w)
    assert got[3:] == ({64: 12, 4: 8, 0: 4}[bf_max],
                       {64: 6, 4: 4, 0: 2}[bf_max],
                       "applied" if bf_max == 64 else "unconverged")
