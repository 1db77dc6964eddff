"""Median of the window's pods' latency: from the time the pod's
``TaskSubmitted`` was due to the reply of the ``Schedule()`` that placed
it (a pod never placed counts until the client gave up)."""

import numpy as np


def read(rec):
    lat = rec.get("latency")
    return float(np.percentile(lat, 50)) if lat is not None and lat.size \
        else None
