"""Host-side exact min-cost-flow oracle (the port of
``poseidon_tpu/solver/oracle.py``).

The placement-cost parity reference: the device solver is checked
against it on randomized instances, and the planner serves
``flow_solver="ssp"`` rounds from it.  Built on networkx's network
simplex (exact for integer data); slow but trustworthy.

networkx is imported inside each function, so the package imports
without it; a call without networkx raises ``ImportError`` naming it.
"""

from __future__ import annotations

import numpy as np

from poseidon_tpu_torch.ops.transport import INF_COST


def _nx():
    try:
        import networkx
    except ImportError as e:
        raise ImportError(
            "the ssp oracle (flow_solver='ssp') needs networkx, which is "
            "not installed"
        ) from e
    return networkx


def _transport_graph(costs, supply, capacity, unsched_cost, arc_capacity):
    """source -> EC (cap s_e) -> machine (cost C[e,m], cap
    arc_capacity[e,m] if given) -> sink (cap c_m), plus EC -> sink
    fallback arcs at the unscheduled cost.  Always feasible because of
    the fallback."""
    nx = _nx()
    costs = np.asarray(costs)
    supply = np.asarray(supply)
    capacity = np.asarray(capacity)
    unsched_cost = np.asarray(unsched_cost)
    E, M = costs.shape
    total = int(supply.sum())

    g = nx.DiGraph()
    g.add_node("src", demand=-total)
    g.add_node("sink", demand=total)
    for e in range(E):
        s = int(supply[e])
        if s == 0:
            continue
        g.add_edge("src", ("ec", e), capacity=s, weight=0)
        g.add_edge(("ec", e), "sink", capacity=s, weight=int(unsched_cost[e]))
        for m in range(M):
            c = int(costs[e, m])
            if c >= INF_COST or capacity[m] <= 0:
                continue
            acap = s if arc_capacity is None else min(s, int(arc_capacity[e, m]))
            if acap <= 0:
                continue
            g.add_edge(("ec", e), ("mach", m), capacity=acap, weight=c)
    for m in range(M):
        if capacity[m] > 0:
            g.add_edge(("mach", m), "sink", capacity=int(capacity[m]), weight=0)
    return g


def transport_objective(costs, supply, capacity, unsched_cost,
                        arc_capacity=None) -> int:
    """Exact optimal objective of the EC->machine transportation
    instance."""
    g = _transport_graph(costs, supply, capacity, unsched_cost, arc_capacity)
    cost, _flow = _nx().network_simplex(g)
    return int(cost)


def transport_solve(costs, supply, capacity, unsched_cost,
                    arc_capacity=None):
    """Exact solve returning ``(objective, flows, unsched)``: the
    verification solver the service exposes as ``flow_solver="ssp"``
    (network simplex on the host, no device).  Same graph as
    ``transport_objective``."""
    g = _transport_graph(costs, supply, capacity, unsched_cost, arc_capacity)
    cost, flow = _nx().network_simplex(g)
    E, M = np.asarray(costs).shape
    flows = np.zeros((E, M), dtype=np.int32)
    unsched = np.zeros(E, dtype=np.int32)
    for e in range(E):
        out = flow.get(("ec", e))
        if not out:
            continue
        for dst, amount in out.items():
            if dst == "sink":
                unsched[e] = amount
            else:
                flows[e, dst[1]] = amount
    return int(cost), flows, unsched


def mcmf_objective(n: int, arcs: list, supplies: dict) -> int:
    """Exact min-cost flow on a general graph.  ``arcs`` is a list of
    ``(u, v, capacity, cost)``; ``supplies`` maps node -> net supply
    (positive = source)."""
    g = _nx().DiGraph()
    for u in range(n):
        g.add_node(u, demand=-int(supplies.get(u, 0)))
    for u, v, cap, cost in arcs:
        if g.has_edge(u, v):
            # A MultiDiGraph would be needed for parallel arcs; the
            # callers never produce them.
            raise ValueError("parallel arcs not supported by oracle")
        g.add_edge(u, v, capacity=int(cap), weight=int(cost))
    cost, _ = _nx().network_simplex(g)
    return int(cost)
