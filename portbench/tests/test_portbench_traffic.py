"""The traffic generator: the same seed gives the same requests, every seed
the same work, prompts within one chunk, maps that the program can match,
pictures of the mix's size, and the check's sample (CPU)."""

import numpy as np
import pytest

from portbench import spec, traffic
from portbench.reference import stable_diffusion as ref

BENCH = spec.load()
# every mix in the tree: those of the cells, and those kept for the Stable
# Diffusion cells (out of BENCHMARK.json until the program pads as
# published)
MIXES = sorted(p.stem for p in (spec.HERE / "traffic").glob("*.json"))
TXT2IMG = [m for m in MIXES
           if traffic.load_mix(m).get("kind", "txt2img") == "txt2img"]
IMAGE = [m for m in MIXES if m not in TXT2IMG]
SEEDS = [0, 7, 2 ** 31 - 1, 2 ** 31 + 12345, 3_000_000_019]


def _same(a, b):
    if a.keys() != b.keys():
        return False
    for k in a:
        if k == "image":
            if not np.array_equal(a[k], b[k]):
                return False
        elif k == "region_state":
            if (a[k] is None) != (b[k] is None):
                return False
            if a[k] is None:
                continue
            if a[k].keys() != b[k].keys():
                return False
            for p in a[k]:
                sa, sb = a[k][p], b[k][p]
                if (sa["weight"], sa["mask_outsides"]) != (
                        sb["weight"], sb["mask_outsides"]):
                    return False
                if not np.array_equal(sa["mask"], sb["mask"]):
                    return False
        elif a[k] != b[k]:
            return False
    return True


@pytest.mark.parametrize("mix_name", MIXES)
def test_same_seed_same_requests_other_seed_others(mix_name):
    mix = traffic.load_mix(mix_name)
    for seed in SEEDS[1:]:
        a = [traffic.request(mix, seed, i) for i in range(4)]
        b = [traffic.request(mix, seed, i) for i in range(4)]
        c = [traffic.request(mix, seed + 1, i) for i in range(4)]
        assert all(_same(x, y) for x, y in zip(a, b))
        assert not all(_same(x, y) for x, y in zip(a, c))
        if mix_name in TXT2IMG:
            assert not any(_same(x, y) for x, y in zip(a, c))
    warm = [traffic.request(mix, 7, i, traffic.WARMUP) for i in range(4)]
    assert not all(_same(x, traffic.request(mix, 7, i))
                   for i, x in enumerate(warm))


@pytest.mark.parametrize("mix_name", TXT2IMG)
def test_every_seed_gives_the_same_work(mix_name):
    mix = traffic.load_mix(mix_name)
    shape = None
    for seed in SEEDS:
        for i in range(6):
            r = traffic.request(mix, seed, i)
            s = (r["height"], r["width"], r["num_images_per_prompt"],
                 r["steps"], r["sampler"], r["cfg_scale"],
                 None if r["region_state"] is None
                 else len(r["region_state"]))
            assert shape in (None, s)
            shape = s
            assert 0 <= r["seed"] < 2 ** 31 - 64


@pytest.mark.parametrize("mix_name", TXT2IMG)
def test_prompts_fit_one_chunk_and_maps_match(mix_name):
    mix = traffic.load_mix(mix_name)
    lo, hi = mix["weight"]
    olo, ohi = mix["mask_outsides"]
    for seed in SEEDS:
        for i in range(8):
            r = traffic.request(mix, seed, i)
            ids, _ = ref.a1111_chunk(r["prompt"])  # raises past 75 tokens
            ref.a1111_chunk(r["negative_prompt"])
            if not mix["region_map"]:
                assert r["region_state"] is None
                continue
            n = len(r["region_state"])
            assert mix["phrases"]["min"] <= n <= mix["phrases"]["max"]
            for phrase, st in r["region_state"].items():
                want = ref.hash_tokenize(phrase)
                assert any(ids[j:j + len(want)] == want
                           for j in range(len(ids)))
                assert st["mask"].shape == (r["height"], r["width"])
                assert st["mask"].dtype == np.float32
                share = float(st["mask"].mean())
                assert 0.05 < share < 0.5
                assert lo <= st["weight"] <= hi
                assert olo <= st["mask_outsides"] <= ohi


@pytest.mark.parametrize("mix_name", IMAGE)
def test_pictures_are_the_mix_size_and_differ(mix_name):
    mix = {**traffic.load_mix(mix_name), "height": 48, "width": 64,
           "pool": 4}
    for seed in SEEDS:
        reqs = [traffic.request(mix, seed, i) for i in range(12)]
        pics = {r["picture"] for r in reqs}
        assert len(pics) > 1
        for r in reqs:
            img = r["image"]
            assert img.shape == (48, 64, 3) and img.dtype == np.uint8
            assert (r["height"], r["width"]) == (48, 64)
            assert float(img.std()) > 5.0


@pytest.mark.parametrize("done", [1, 3, 17, 400])
def test_check_sample_is_drawn_from_the_completed(done):
    mix = traffic.load_mix(MIXES[0])
    picks = []
    for _ in range(2):
        s = traffic.CheckSample(mix, 5)
        kept = set()
        for i in range(done):
            keep, dropped = s.offer(i)
            if keep:
                kept.add(i)
            kept.discard(dropped)
        assert sorted(kept) == s.indices()
        picks.append(s.indices())
    assert picks[0] == picks[1]
    assert len(picks[0]) == min(mix["check_requests"], done)
    assert all(0 <= i < done for i in picks[0])


def test_check_sample_is_uniform_over_the_window():
    mix = {"check_requests": 2}
    counts = np.zeros(10)
    for seed in range(2000):
        s = traffic.CheckSample(mix, seed)
        for i in range(10):
            s.offer(i)
        counts[s.indices()] += 1
    assert np.all(np.abs(counts / 4000 - 0.1) < 0.02)


def test_rasterize_shapes():
    m = traffic.rasterize({"kind": "rect", "cx": 0.5, "cy": 0.5, "rx": 0.25,
                           "ry": 0.25}, 8, 8)
    assert m.sum() == 16 and m[2:6, 2:6].all()
    e = traffic.rasterize({"kind": "ellipse", "cx": 0.5, "cy": 0.5,
                           "rx": 0.5, "ry": 0.5}, 64, 64)
    assert abs(e.mean() - np.pi / 4) < 0.02
    with pytest.raises(ValueError):
        traffic.rasterize({"kind": "star", "cx": 0, "cy": 0, "rx": 1,
                           "ry": 1}, 4, 4)
