"""The program's ``round.cost_build`` stage: seconds per burst round."""

from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "burst", "round.cost_build")
