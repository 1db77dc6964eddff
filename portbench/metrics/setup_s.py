"""Seconds from the process's start to the window's start: imports, the
device, kernel loads, the cluster's and backlog's in-process build, and
the cell's warm-up."""


def read(rec):
    return rec["setup_s"]
