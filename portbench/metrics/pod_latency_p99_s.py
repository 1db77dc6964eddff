"""99th percentile of the window's pods' latency (see
``pod_latency_p50_s``)."""

import numpy as np


def read(rec):
    lat = rec.get("latency")
    return float(np.percentile(lat, 99)) if lat is not None and lat.size \
        else None
