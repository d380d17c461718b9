"""Pipeline and sampler: ``inference()``'s ``sample`` phase (the solver's
UNet calls and the VAE decode under it) over the window's images."""


def read(run):
    vals = [r["phases"]["sample"] for r in run.requests
            if "sample" in r["phases"]]
    return 1e3 * sum(vals) / run.images if vals and run.images else None
