"""The app layer's host time a request (app/api.py ``inference()``,
``ModelManager.get_variant``): its wall on the benchmark's clock minus the
sum of its ``timings`` phases, averaged over the window's requests."""


def read(run):
    rows = [r for r in run.requests if r["phases"]]
    if not rows:
        return None
    return 1e3 * sum(r["latency_s"] - sum(r["phases"].values())
                     for r in rows) / len(rows)
