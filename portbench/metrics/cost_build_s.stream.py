"""The program's ``round.cost_build`` stage: seconds per stream round."""

from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "stream", "round.cost_build", with_view=True)
