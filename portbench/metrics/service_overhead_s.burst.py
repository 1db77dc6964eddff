"""Per burst: the client's wall minus the time the planner's round (and
the harness's bookkeeping around it) took on the server: the deltas'
protobuf and the gRPC transfer."""

from portbench.readers import mean, rounds


def read(rec):
    if not rec.get("trace"):
        return None
    return mean((r["client"][1] - r["client"][0])
                - (r["server"]["t2"] - r["server"]["t0"])
                for r in rounds(rec, "burst"))
