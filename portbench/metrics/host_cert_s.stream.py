"""The program's ``solve.host_cert`` stage (the host certificate):
seconds per stream round that took a snapshot, a round whose bands all
went another way counting 0."""

from portbench.readers import mean, rounds


def read(rec):
    rs = [r for r in rounds(rec, "stream", with_view=True)
          if "stages" in r["server"]]
    if not rs:
        return None
    return mean(r["server"]["stages"].get("solve.host_cert", 0.0)
                for r in rs)
