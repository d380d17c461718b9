"""Prompt and region encoding: ``inference()``'s ``encode`` phase (the A1111
parser, the tokenizer, the text encoder, the region map), averaged over the
window's requests."""


def read(run):
    vals = [r["phases"]["encode"] for r in run.requests
            if "encode" in r["phases"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
