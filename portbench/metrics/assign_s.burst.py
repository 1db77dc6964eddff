"""The program's ``round.assign`` stage: seconds per burst round."""

from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "burst", "round.assign")
