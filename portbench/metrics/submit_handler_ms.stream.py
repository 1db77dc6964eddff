"""Mean time in the ``TaskSubmitted`` handler, from its start to its
return (the program's ``rpc.TaskSubmitted``), over the calls that start
in the window (milliseconds)."""

from portbench.spans import mean_in_window_ms


def read(rec):
    return mean_in_window_ms(rec, "rpc.TaskSubmitted")
