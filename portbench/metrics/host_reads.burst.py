"""Device-to-host reads of the solve ladder (``transport.host_read_count``)
per burst round."""

from portbench.readers import mean, rounds


def read(rec):
    rs = [r for r in rounds(rec, "burst") if "host_reads" in r["server"]]
    return mean(r["server"]["host_reads"] for r in rs) if rs else None
