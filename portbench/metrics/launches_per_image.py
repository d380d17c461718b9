"""Device kernels launched in the profiled requests, over their images."""

from portbench import profiles


def read(run):
    p = run.profile
    if not p or not p["images"]:
        return None
    n = sum(1 for name, _, _ in p["events"] if profiles.is_kernel(name))
    return n / p["images"] if n else None
