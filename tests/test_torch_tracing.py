"""The port's spans and counters (``utils/profiling.py``) on the CPU.

A tiny HED (widths 8-24) on a 48 x 64 picture through the manager's
preprocessor: nothing is recorded without a profiler; under a CPU
``torch.profiler`` the spans form the request's tree, count its resize
matrices, hold the profiler's events of their own torch ops on its clock,
and add no event of their own to the profile. ``inference()``'s phases
are spans under one root (its pipeline replaced by a stub, so nothing is
sampled), and ``timings`` keeps its keys in their order.
"""

import collections
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffusionspatialcontrol_tpu_torch.app import api
from diffusionspatialcontrol_tpu_torch.models import hed
from diffusionspatialcontrol_tpu_torch.utils import profiling

torch.set_num_threads(1)

NAME = "Soft Edge (HED)"
HED_CHILDREN = (["hed.prepare", "hed.net"] + ["resize", "to_host"] * 5
                + ["hed.fuse"])


@pytest.fixture(scope="module")
def detect(tmp_path_factory):
    path = tmp_path_factory.mktemp("hed") / "ControlNetHED.pth"
    sd = hed.random_state_dict(hed.HEDConfig((8, 12, 16, 16, 24)), seed=0)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    m = api.ModelManager(device="cpu")
    m.register_preprocessor(NAME, str(path))
    return m.get_preprocessor(NAME)


@pytest.fixture(scope="module")
def picture():
    return np.random.default_rng(0).integers(0, 256, (48, 64, 3), np.uint8)


def _new_spans(before):
    return [s for s in profiling.recorded_spans() if s.id > before]


def _last_id():
    spans = profiling.recorded_spans()
    return max((s.id for s in spans), default=0)


def test_nothing_is_recorded_without_a_profiler(detect, picture):
    before = _last_id()
    detect(picture)
    profiling.count("resize.weights_built")  # no open span: dropped
    assert _new_spans(before) == []


def _inside(events, spans):
    """Whether each event lies within one of the spans."""
    return all(any(s.start_ns <= e.start_ns()
                   and e.start_ns() + e.duration_ns() <= s.end_ns
                   for s in spans) for e in events)


def test_a_profiled_request_is_a_tree_on_the_profilers_clock(detect,
                                                             picture):
    with profile(activities=[ProfilerActivity.CPU]):
        detect(picture)  # the profiler's first events cost more
    before = _last_id()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        edges = detect(picture)
    assert edges.shape == (48, 64, 3)
    spans = _new_spans(before)
    root = spans[-1]  # a span is kept when it ends: the root last
    assert (root.name, root.parent) == ("preprocess", None)
    assert {s.root for s in spans} == {root.id}
    children = spans[:-1]
    assert [s.name for s in children] == HED_CHILDREN
    assert all(s.parent == root.id for s in children)
    assert len({s.id for s in spans}) == len(spans)
    for a, b in zip(children, children[1:]):
        assert root.start_ns <= a.start_ns <= a.end_ns <= b.start_ns
    assert children[-1].end_ns <= root.end_ns
    builds = [s.counters.get("resize.weights_built", 0) for s in children
              if s.name == "resize"]
    assert builds == [0, 2, 2, 2, 2]  # the stride-1 map is not resized

    # the profiler's events of the spans' own torch ops lie inside them,
    # on its clock: one einsum a weight matrix in the resizes; and the
    # copy of a map (``cpu()``, ``numpy()``) in each to_host span, which
    # opens just before its first op and closes just after its last
    events = [e for e in prof.profiler.kineto_results.events()
              if root.start_ns <= e.start_ns() <= root.end_ns]
    assert not {s.name for s in spans} & {e.name() for e in events}
    einsums = [e for e in events if e.name() == "aten::einsum"]
    assert len(einsums) == 8
    assert _inside(einsums, [s for s in children if s.name == "resize"])
    offsets = []
    for s in children:
        if s.name == "to_host":
            ops = [e for e in events if s.start_ns <= e.start_ns() <= s.end_ns]
            assert "aten::to" in {e.name() for e in ops}
            assert _inside(ops, [s])
            offsets += [min(e.start_ns() for e in ops) - s.start_ns,
                        s.end_ns - max(e.start_ns() + e.duration_ns()
                                       for e in ops)]
    assert len(offsets) == 10
    assert statistics.median(offsets) < 50_000  # ns


def test_the_buffer_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(profiling, "_DONE", collections.deque(maxlen=4))
    spans = [profiling.Span(f"s{i}") for i in range(10)]
    with profile(activities=[ProfilerActivity.CPU]):
        for s in spans:
            with s:
                pass
    names = [r.name for r in profiling.recorded_spans()]
    assert names == ["s6", "s7", "s8", "s9"]
    assert len(profiling.recorded_spans()) == 4  # read again: kept


class _StubPipe:
    """What ``inference()`` calls of a pipeline on a plain txt2img."""

    def __init__(self, *args, **kw):
        pass

    def encode_prompt(self, prompts, negatives, **kw):
        return torch.zeros(2, 4, 8), None

    def txt2img(self, context, gen, **kw):
        return torch.zeros(1, 8, 8, 3)

    @staticmethod
    def to_uint8(images):
        return images.to(torch.uint8)


class _StubManager:
    device, attn_impl, conv_impl, mesh = "cpu", "xla", "xla", None

    def get_variant(self, model, loras=None, ti_embeddings=None):
        return None, {}, None


TIMINGS = ["total_s", "encode_s", "conditioning_s", "sample_s", "to_host_s",
           "model", "sampler", "steps"]


def test_inference_phases_are_spans_under_one_root(monkeypatch):
    import json

    monkeypatch.setattr(api, "StableDiffusionTorch", _StubPipe)
    plain = api.inference(_StubManager(), "a cat", "stub", steps=2)
    assert list(json.loads(plain["timings"])) == TIMINGS
    before = _last_id()
    with profile(activities=[ProfilerActivity.CPU]):
        out = api.inference(_StubManager(), "a cat", "stub", steps=2)
    assert list(json.loads(out["timings"])) == TIMINGS
    spans = _new_spans(before)
    root = spans[-1]
    assert (root.name, root.parent) == ("inference", None)
    assert [(s.name, s.parent, s.root) for s in spans[:-1]] == [
        (n, root.id, root.id)
        for n in ("encode", "conditioning", "sample", "to_host")]
