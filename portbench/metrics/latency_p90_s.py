"""The 90th percentile, by nearest rank, of every window request's seconds
from the call into the program to its images on the host."""

import math


def read(run):
    lat = sorted(r["latency_s"] for r in run.requests)
    if not lat:
        return None
    return lat[max(math.ceil(0.9 * len(lat)), 1) - 1]
