"""Mean wait of a ``TaskSubmitted`` call in the server's thread pool, from
grpc's submission of the call to its handler's start (the program's
``rpc.TaskSubmitted.queued``), over the calls that start in the window
(milliseconds)."""

from portbench.spans import mean_in_window_ms


def read(rec):
    return mean_in_window_ms(rec, "rpc.TaskSubmitted.queued")
