"""Seconds from the process's start to the end of the warm-up request:
imports, weights made on the device, their conversion, kernel builds and
loads, one request of the cell's shape."""


def read(run):
    return run.setup_s
