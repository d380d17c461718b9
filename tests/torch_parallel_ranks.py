"""The ranks of ``tests/test_torch_parallel.py``: the port's data parallelism
on gloo ranks on the CPU.

    python -m tests.torch_parallel_ranks DIR RANK WORLD

run from the root of the checkout, one process a rank, WORLD = 4. The ranks
import the port and not JAX (the test process has JAX loaded, so they start
as fresh interpreters), share a ``file://`` store in DIR, and write what
they computed to ``DIR/rank<RANK>.pt`` (or the traceback, under "error").
All four ranks take the std over four ranks and make a group of ranks 0
and 1; ranks 2 and 3 then end, and ranks 0 and 1 run every other case on
that group's mesh. The last case is a rank 1 that fails during sampling:
it leaves the mesh and ends its process group, as a follower's process
does, and rank 0 runs the next grid alone. The test process imports the input functions below for
its references, so both sides build the same inputs.
"""

from __future__ import annotations

import collections
import datetime
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from diffusionspatialcontrol_tpu_torch import config as tcfg
from diffusionspatialcontrol_tpu_torch.app import api as tapi
from diffusionspatialcontrol_tpu_torch.app import server as tserver
from diffusionspatialcontrol_tpu_torch.models import controlnet as tcn
from diffusionspatialcontrol_tpu_torch.models import factory as tfactory
from diffusionspatialcontrol_tpu_torch.models import ip_adapter as ipa
from diffusionspatialcontrol_tpu_torch.ops.attention import (
    logits_std_gram_nlhd,
)
from diffusionspatialcontrol_tpu_torch.parallel import batched, mesh as tmesh
from diffusionspatialcontrol_tpu_torch.parallel import spmd
from diffusionspatialcontrol_tpu_torch.pipeline import pipeline as tpipeline
from diffusionspatialcontrol_tpu_torch.text import tokenizer as ttok

TIMEOUT = datetime.timedelta(seconds=60)  # any collective; a hang fails
TINY = tcfg.tiny_config()
PROMPTS = ["a red cat sitting on a wooden bench",
           "a blue bird flying over a red cat"]
SEEDS = [3, 8]  # a grid: 2 prompts x 2 seeds, one prompt a rank
SPMD_SEEDS = [5, 6, 7, 8]
NEG = "bad quality"


def masks(side: int = 64):
    m1 = np.zeros((side, side), np.float32)
    m1[:, : side // 2] = 1.0
    m2 = np.zeros((side, side), np.float32)
    m2[: side // 3, side // 2:] = 1.0
    return {"red cat": {"mask": m1, "weight": 0.8, "mask_outsides": 0.2},
            "blue bird": {"mask": m2, "weight": 0.7, "mask_outsides": 0.1}}


def std_inputs():
    """q (8, 16, 2, 8) and k (8, 7, 2, 8): a batch of 8 over 2 or 4 ranks,
    with means away from zero so that the between-group term counts."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((8, 16, 2, 8)).astype(np.float32) + 0.3
    k = rng.standard_normal((8, 7, 2, 8)).astype(np.float32) - 0.2
    q[4:] *= 1.7  # the ranks' shards differ in their statistics
    return q, k


def pipeline(params=None):
    if params is None:
        params = tfactory.init_pipeline_params(0, TINY, torch.float32,
                                               device="cpu")
    return tpipeline.StableDiffusionTorch(
        TINY, params, tokenizer=ttok.HashTokenizer(), device="cpu")


def gen(sampler="euler_ancestral", **kw):
    return tcfg.GenerationConfig(height=64, width=64, num_inference_steps=3,
                                 sampler=sampler, dtype=torch.float32, **kw)


def spmd_inputs(pipe):
    """The sampler cases' batch: one prompt four times, its map, and the
    JAX runner's injected inputs for dpmpp_2m (scaled latents, the context
    and biases as (B, 2, ...) pairs)."""
    ctx, ids = pipe.encode_prompt([PROMPTS[0]] * 4, [NEG] * 4)
    biases = pipe.encode_region([masks()] * 4, ids, height=64, width=64)
    g = gen("dpmpp_2m")
    sigmas, _ = pipe._schedule(g)
    lat = np.random.default_rng(4).standard_normal((4, 8, 8, 4)).astype(
        np.float32) * np.float32(np.sqrt(sigmas[0] ** 2 + 1.0))
    pairs = spmd._pairs(ctx, 4)
    bias_pairs = tuple(spmd._pairs(b, 4) for b in biases)
    return ctx, biases, lat, pairs, bias_pairs


def random_heads(params, seed: int, rms: float = 0.05):
    """A ControlNet's zero-initialized heads drawn at ``rms`` (as
    tests/test_torch_controlnet.py draws them), so that it moves the
    image."""
    g = torch.Generator().manual_seed(seed)
    for conv in ([params["cond_embedding"]["conv_out"]] + params["zero_convs"]
                 + [params["mid_zero_conv"]]):
        for key in ("kernel", "bias"):
            t = conv[key]
            conv[key] = (rms * torch.randn(t.shape, generator=g)).contiguous(
                memory_format=torch.channels_last if t.dim() == 4
                else torch.contiguous_format)
    return params


def unit_pipeline_and_extras(params, g):
    """A pipeline whose UNet carries an IP-Adapter, and the grid's extras:
    a ControlNet with random heads and that IP-Adapter (masked), batched
    to the grid's 4 samples with CFG."""
    unet = ipa.copy_tree_containers(params["unet"])
    ads = ipa.load_ip_adapter(unet, TINY.unet,
                              [ipa.random_state_dict(TINY.unet)],
                              dtype=torch.float32, device="cpu")
    pipe = pipeline({**params, "unet": unet})
    cn = random_heads(tcn.controlnet_init(
        torch.Generator().manual_seed(1), TINY.unet, dtype=torch.float32,
        device="cpu"), 101)
    rng = np.random.default_rng(7)
    image = rng.random((4, 64, 64, 3)).astype(np.float32)
    extras = pipe.build_controlnet_extras(g, [cn], [image], scales=[1.0])
    embeds = torch.from_numpy(rng.standard_normal((4, 1024)).astype(
        np.float32))
    mask = np.zeros((4, 64, 64), np.float32)
    mask[:, :, :40] = 1.0
    extras = pipe.build_ip_extras(ads, [embeds], scales=[0.8], masks=[mask],
                                  base=extras)
    return pipe, extras


def grid_cases():
    """name -> (generation config, generate_grid keywords but the pipe)."""
    inits = [torch.from_numpy(np.random.default_rng(s).uniform(
        -1, 1, (64, 64, 3)).astype(np.float32)) for s in (21, 22)]
    return {
        "mapped": (gen(), {"region_states": [masks(), None]}),
        "cfg_off": (gen(guidance_scale=1.0), {"region_states": [masks()] * 2}),
        "img2img": (gen(), {"region_states": [masks(), None],
                            "init_images": inits, "strength": 0.5}),
        "units": (gen(), {"region_states": [masks(), None]}),
    }


def grid(pipe, name, mesh, extras=None):
    g, kw = grid_cases()[name]
    return batched.generate_grid(pipe, PROMPTS, SEEDS, g, negative_prompt=NEG,
                                 mesh=mesh, decode=False, extras=extras, **kw)


def payload():
    """The grid request of the app cases, as the server's JSON."""
    m = masks()
    state = {k: {**v, "mask": v["mask"].astype(int).tolist()}
             for k, v in m.items()}
    return {"prompt": PROMPTS, "model": "tiny", "steps": 3, "width": 64,
            "height": 64, "seed": SEEDS, "sampler": "Euler a",
            "encoding_mode": "short", "region_state": [state, None]}


class Draws:
    """While entered, records the initial latents and solver noise each
    sampling call draws (``initial_noise`` where ``module`` calls it, and
    ``pipe._solver_noise``)."""

    def __init__(self, module, pipe):
        self.module, self.pipe, self.out = module, pipe, []

    def __enter__(self):
        noise, solver = self.module.initial_noise, self.pipe._solver_noise
        self._noise = noise

        def record_noise(seeds, *a, **k):
            self.out.append(("latents", list(seeds), noise(seeds, *a, **k)))
            return self.out[-1][2]

        def record_solver(seeds, *a, **k):
            self.out.append(("solver", list(seeds), solver(seeds, *a, **k)))
            return self.out[-1][2]

        self.module.initial_noise = record_noise
        self.pipe._solver_noise = record_solver
        return self

    def __exit__(self, *exc):
        self.module.initial_noise = self._noise
        del self.pipe._solver_noise


def _sub_cases(mesh):
    """Ranks 0 and 1 of the group made from ranks 0 and 1."""
    out = {}
    pipe = pipeline()
    # the sampler against the JAX runner: each rank its injected rows
    _, _, lat, pairs, bias_pairs = spmd_inputs(pipe)
    rows = mesh.rows(4)
    local = spmd.sample_local(
        pipe, torch.from_numpy(lat[rows]), pairs[rows],
        tuple(b[rows] for b in bias_pairs), None, gen("dpmpp_2m"), mesh)
    out["sample_local"] = mesh.all_gather(local)

    # sample_spmd against one process, with and without the map; the
    # draws and the collectives
    ctx, biases, _, _, _ = spmd_inputs(pipe)
    with Draws(spmd, pipe) as draws:
        for name, b in (("spmd_map", biases), ("spmd_nomap", None)):
            before = collections.Counter(mesh.counts)
            out[name] = spmd.sample_spmd(pipe, ctx, gen(), SPMD_SEEDS, mesh,
                                         region_biases=b,
                                         check_collectives=True)
            out[name + "_counts"] = dict(mesh.counts - before)
    out["spmd_draws"] = draws.out
    out["cross_attentions"] = spmd.cross_attention_count(pipe.params["unet"])

    # grids on the mesh
    with Draws(tpipeline, pipe) as draws:
        for name in ("mapped", "cfg_off", "img2img"):
            before = collections.Counter(mesh.counts)
            out["grid_" + name] = grid(pipe, name, mesh)
            out["grid_" + name + "_counts"] = dict(mesh.counts - before)
    out["grid_draws"] = draws.out
    upipe, extras = unit_pipeline_and_extras(pipe.params, grid_cases()[
        "units"][0])
    out["grid_units"] = grid(upipe, "units", mesh, extras)

    # replicate: rank 0's values of a tree the ranks built differently
    tree = {"w": torch.full((2, 3, 1, 1), float(mesh.rank)).contiguous(
                memory_format=torch.channels_last),
            "t": [torch.arange(6.0).reshape(2, 3).t() + mesh.rank, None]}
    before = collections.Counter(mesh.counts)
    out["replicated"] = tmesh.replicate(mesh, tree)
    out["replicate_counts"] = dict(mesh.counts - before)

    # inference() through the request channel; a request on rank 0 alone;
    # a follower's error before sampling, then one during sampling
    manager = tapi.ModelManager(dtype=torch.float32, device="cpu", mesh=mesh)
    manager.register_random("tiny", TINY, seed=0)
    if mesh.rank == 0:
        kwargs = tserver._inference_kwargs(payload())
        out["inference"] = tapi.inference(manager, **kwargs)["images"]
        before = collections.Counter(mesh.counts)
        one = tapi.inference(manager, **{**kwargs, "prompt": PROMPTS[0],
                                         "seed": 3, "region_state": None})
        out["solo_shape"] = one["images"].shape
        out["solo_counts"] = dict(mesh.counts - before)
        manager.register_random("only_on_rank_0", TINY, seed=0)
        t0 = time.perf_counter()
        try:
            tapi.inference(manager, **{**kwargs, "model": "only_on_rank_0"})
        except tmesh.RankError as e:
            out["failure"] = (str(e), time.perf_counter() - t0)
        tapi.stop_followers(manager)
        t0 = time.perf_counter()
        try:
            tapi.inference(manager, **kwargs)
        except tmesh.RankError as e:
            out["lost"] = (str(e), time.perf_counter() - t0)
        before = collections.Counter(mesh.counts)
        out["after_lost"] = tapi.inference(manager, **kwargs)["images"]
        out["after_lost_counts"] = dict(mesh.counts - before)
    else:
        out["followed"] = tapi.follow_requests(manager)
        # the next grid fails on this rank after 20 of its all-reduces
        inner, calls = mesh.all_reduce, [0]

        def failing(t):
            calls[0] += 1
            if calls[0] > 20:
                raise RuntimeError("out of memory (a test's failure)")
            return inner(t)

        mesh.all_reduce = failing
        try:
            tapi.follow_requests(manager)
        except RuntimeError as e:
            out["left"] = str(e)
    return out


def main(argv) -> int:
    path, rank, world = argv[0], int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    out = {}
    try:
        mesh = tmesh.init_data_parallel(
            device="cpu", init_method=f"file://{path}/store", rank=rank,
            world_size=world, timeout=TIMEOUT)
        out["backend"] = mesh.backend
        q, k = (torch.from_numpy(a) for a in std_inputs())
        r = mesh.rows(8)
        out["std4"] = logits_std_gram_nlhd(q[r], k[r], 8 ** -0.5, mesh=mesh)
        sub = dist.new_group([0, 1])
        out["auto_indivisible"] = tmesh.resolve_mesh("auto", 3, "cpu")
        out["auto_world"] = tmesh.resolve_mesh("auto", 8, "cpu").world_size
        if rank < 2:
            mesh2 = tmesh.data_parallel_mesh("cpu", group=sub,
                                             store=mesh.store)
            r = mesh2.rows(8)
            out["std2"] = logits_std_gram_nlhd(q[r], k[r], 8 ** -0.5,
                                               mesh=mesh2)
            out.update(_sub_cases(mesh2))
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - reported to the test
        out["error"] = traceback.format_exc()
    torch.save(out, f"{path}/rank{rank}.pt")
    return 1 if "error" in out else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
