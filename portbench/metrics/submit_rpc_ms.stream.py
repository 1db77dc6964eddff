"""Mean ``TaskSubmitted`` round trip in the window, on the client's clock
(milliseconds)."""

import numpy as np


def read(rec):
    rtt = rec.get("submit_rtt")
    if rtt is None or not rtt.size:
        return None
    return 1e3 * float(np.mean(rtt))
