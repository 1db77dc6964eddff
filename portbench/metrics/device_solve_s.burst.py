"""Device seconds of the solve ladder per burst round: the program's
device-timed ``solve.device.<route>`` stages (CUDA events), summed over
the routes and the coarse program's stages, which run one after
another (their ``.iterate``, ``.global_update`` and ``.other`` parts nest
inside them and are not added again)."""

from portbench.readers import mean, rounds


def solve_device(stages: dict) -> float:
    return sum(v for k, v in stages.items()
               if k.startswith("solve.device.") and k.count(".") == 2)


def read(rec):
    rs = [r for r in rounds(rec, "burst") if "device" in r["server"]]
    if not rs or not any(solve_device(r["server"]["device"]) for r in rs):
        return None
    return mean(solve_device(r["server"]["device"]) for r in rs)
