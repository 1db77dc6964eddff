"""B2 (``tiled_iteration.cu``) against its roofline in burst rounds: each
iteration's bytes at its padded [E_pad, M_pad] plane (the cost, arc
capacity and flow planes read once, the flow plane written once: 16 B a
cell) at the HBM bandwidth, over the device time of the iteration's
three kernels (``pt_seg``, ``pt_push``, ``pt_final``), in percent.  The
plane of an iteration is the tiled solve route whose tile grid its
``pt_push`` launch has; an iteration whose grid matches no route adds
its time and no bytes."""

from portbench.readers import HBM_BYTES_PER_S, client_spans, rounds

KERNELS = ("pt_seg", "pt_push", "pt_final")


def b2_bytes(E: int, M: int) -> int:
    return 4 * 4 * E * M


def grid_of(E: int, M: int) -> tuple:
    return (-(-M // 256), -(-E // 16), 1)


def read(rec):
    if not rec.get("trace"):
        return None
    shapes = {}
    for r in rounds(rec, "burst"):
        for impl, E, M, _n in r["server"].get("routes", []):
            if impl == "tiled":
                g = grid_of(E, M)
                shapes[g] = min(shapes.get(g, (E, M)), (E, M))
    spans = client_spans(rec, "burst")
    secs, nbytes = 0.0, 0
    for name, a, b, grid in rec["ops"]:
        if not any(k in name for k in KERNELS):
            continue
        if not any(lo <= a and b <= hi for lo, hi in spans):
            continue
        secs += b - a
        if "pt_push" in name and grid is not None:
            shape = shapes.get(tuple(grid))
            if shape is not None:
                nbytes += b2_bytes(*shape)
    if secs <= 0 or nbytes == 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / secs
