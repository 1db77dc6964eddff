"""The program's ``round.view_build`` stage: seconds per stream round."""

from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "stream", "round.view_build", with_view=True)
