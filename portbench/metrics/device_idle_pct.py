"""The share of the profiled requests' wall (host clock) in which no
device operation ran: one minus the union of the operations' intervals
on the timeline over the wall."""

from portbench import profiles


def read(run):
    p = run.profile
    if not p or p["wall_s"] <= 0:
        return None
    busy = profiles.busy_ns(p["events"]) / 1e9
    if busy <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - busy / p["wall_s"])
