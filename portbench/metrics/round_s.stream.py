"""The program's ``round`` span: seconds per stream round that took a
snapshot of the cluster."""

from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, "stream", "round", with_view=True)
