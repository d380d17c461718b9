"""The port's data parallelism on gloo ranks on the CPU, against the JAX
package's ``shard_map`` runners and against the port on one process.

Two process groups serve the whole file, started together by one
module-scoped fixture, each rank a fresh interpreter that imports the port
and not JAX (``tests/torch_parallel_ranks.py``; every collective has a 60 s
timeout and every process is waited for with one, so a mismatch fails and
never hangs):

1. four ranks on a ``file://`` store: the region std over four ranks, then
   ranks 0 and 1 run every other case on a group of their own (the std
   over two, the sampler, grids, ``inference()``);
2. the HTTP server as ``torchrun`` starts it (``RANK``, ``WORLD_SIZE``,
   ``MASTER_ADDR``, ...; two ranks, gloo): rank 0 serves one grid POST
   with rank 1 following, then stops on SIGINT and stops rank 1.

Meanwhile this process computes the references: JAX's std under
``shard_map`` over 2 and 4 of the 8 virtual CPU devices (within 1e-6
relative), JAX ``_sample_spmd`` on 2 devices from the same injected
latents (the pipeline parity bound, rtol 1e-4 and atol 1e-4 of max abs),
and the port's one-process runs (JAX's own mesh bound, 2e-3; the draws bit
for bit).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from diffusionspatialcontrol_tpu import config as jcfg
from diffusionspatialcontrol_tpu.ops import attention as jattn
from diffusionspatialcontrol_tpu.parallel import spmd as jspmd
from diffusionspatialcontrol_tpu_torch.app import api as tapi
from diffusionspatialcontrol_tpu_torch.app import server as tserver
from diffusionspatialcontrol_tpu_torch.parallel import mesh as tmesh
from diffusionspatialcontrol_tpu_torch.pipeline import pipeline as tpipeline
from tests import torch_parallel_ranks as R
from tests.test_torch_controlnet import to_jax

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 240  # the longest any rank may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return {**env, "OMP_NUM_THREADS": "1", **extra}


def _http(port, path, payload=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _jax_std(q, k, devices):
    mesh = Mesh(np.asarray(jax.devices()[:devices]), ("data",))
    fn = jax.jit(jspmd.shard_map(
        lambda a, b: jattn.logits_std_gram_nlhd(a, b, 8 ** -0.5,
                                                axis_name="data")[None],
        mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P("data")))
    return float(np.asarray(fn(jnp.asarray(q), jnp.asarray(k)))[0])


def _jax_sample_spmd(pipe):
    _, _, lat, pairs, bias_pairs = R.spmd_inputs(pipe)
    g = R.gen("dpmpp_2m")
    sigmas, defaults = pipe._schedule(g)
    return np.asarray(jspmd._sample_spmd(
        to_jax(pipe.params), jnp.asarray(lat), jnp.asarray(pairs.numpy()),
        tuple(jnp.asarray(b.numpy()) for b in bias_pairs), None,
        model_cfg=jcfg.tiny_config(), solver_name="dpmpp_2m",
        sigmas_key=tuple(float(s) for s in sigmas), guidance_scale=7.5,
        guidance_rescale=0.0, attn_impl="xla",
        solver_opts=tuple(sorted(pipe._solver_opts(g, defaults).items())),
        mesh=Mesh(np.asarray(jax.devices()[:2]), ("data",)),
        compute_dtype=jnp.float32))


def _references():
    """Everything this process holds the ranks to."""
    pipe = R.pipeline()
    q, k = R.std_inputs()
    ref = {"std2": _jax_std(q, k, 2), "std4": _jax_std(q, k, 4),
           "jax_sample_spmd": _jax_sample_spmd(pipe)}
    ctx, biases, _, _, _ = R.spmd_inputs(pipe)
    for name, b in (("spmd_map", biases), ("spmd_nomap", None)):
        ref[name] = pipe.txt2img(ctx, R.gen(), seed=R.SPMD_SEEDS,
                                 region_biases=b, decode=False)
    for name in ("mapped", "cfg_off", "img2img"):
        ref["grid_" + name] = R.grid(pipe, name, None)
    upipe, extras = R.unit_pipeline_and_extras(pipe.params,
                                               R.grid_cases()["units"][0])
    ref["grid_units"] = R.grid(upipe, "units", None, extras)
    manager = tapi.ModelManager(dtype=torch.float32, device="cpu")
    manager.register_random("tiny", R.TINY, seed=0)
    ref["inference"] = tapi.inference(
        manager, **tserver._inference_kwargs(R.payload()))["images"]
    ref["pipe"] = pipe
    return ref


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(rank results of group 1, the server's POST and exit codes, this
    process's references)."""
    path = tmp_path_factory.mktemp("ranks")

    def log(name):  # a file, not a pipe that could fill and block a rank
        return open(path / f"{name}.log", "w")

    group1 = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_ranks", str(path),
         str(r), "4"], cwd=ROOT, env=_env(), stdout=subprocess.DEVNULL,
        stderr=log(f"rank{r}")) for r in range(4)]
    http_port, master = _free_port(), _free_port()
    group2 = [subprocess.Popen(
        [sys.executable, "-m", "diffusionspatialcontrol_tpu_torch.app.server",
         "--random-model", "tiny:tiny", "--device", "cpu", "--dtype", "f32",
         "--port", str(http_port)], cwd=ROOT, env=_env(
            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master)),
        stdout=subprocess.DEVNULL, stderr=log(f"server{r}"))
        for r in range(2)]
    try:
        ref = _references()
        deadline = time.monotonic() + WAIT_S
        for p in group1:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        out = [torch.load(path / f"rank{r}.pt", weights_only=False)
               for r in range(4)]
        for r, o in enumerate(out):
            assert "error" not in o, f"rank {r}: {o['error']}"
        while True:  # the server binds its port after building its model
            try:
                _http(http_port, "/health")
                break
            except OSError:
                if time.monotonic() > deadline or group2[0].poll() is not None:
                    raise
                time.sleep(0.2)
        served = _http(http_port, "/generate", R.payload())
        group2[0].send_signal(signal.SIGINT)  # serve() ends; rank 1 stops
        codes = [p.wait(timeout=60) for p in group2]
        yield out, served, codes, ref
    finally:
        _stop(group1 + group2)


@pytest.mark.parametrize("world", [2, 4])
def test_std_over_ranks_matches_jax_shard_map(ranks, world):
    out, _, _, ref = ranks
    stds = [float(o[f"std{world}"]) for o in out[:world]]
    assert len(set(stds)) == 1  # every rank has the global value
    np.testing.assert_allclose(stds[0], ref[f"std{world}"], rtol=1e-6)


def test_sample_local_matches_jax_sample_spmd(ranks):
    out, _, _, ref = ranks
    got, want = out[0]["sample_local"].numpy(), ref["jax_sample_spmd"]
    assert torch.equal(out[0]["sample_local"], out[1]["sample_local"])
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", ["spmd_map", "spmd_nomap"])
def test_sample_spmd_matches_one_process(ranks, name):
    out, _, _, ref = ranks
    assert torch.equal(out[0][name], out[1][name])
    np.testing.assert_allclose(out[0][name].numpy(), ref[name].numpy(),
                               atol=2e-3)


@pytest.mark.parametrize("name", ["mapped", "cfg_off", "img2img", "units"])
def test_grid_on_two_ranks_matches_one_process(ranks, name):
    out, _, _, ref = ranks
    got = out[0]["grid_" + name]
    assert got.shape == (4, 8, 8, 4)
    assert torch.equal(got, out[1]["grid_" + name])
    np.testing.assert_allclose(got.numpy(), ref["grid_" + name].numpy(),
                               atol=2e-3)


@pytest.mark.parametrize("case", ["spmd", "grid"])
def test_per_rank_draws_are_the_single_draws_rows(ranks, case):
    """Each rank's initial latents and solver noise equal the rows of the
    one-process draw for the whole batch, bit for bit."""
    out, _, _, ref = ranks
    pipe = ref["pipe"]
    seeds = R.SPMD_SEEDS if case == "spmd" else [3, 8, 3, 8]
    g = R.gen()
    shape = (len(seeds), 8, 8, 4)
    whole = {"latents": tpipeline.initial_noise(seeds, shape[1:], "cpu"),
             "solver": pipe._solver_noise(seeds, pipe._schedule(g)[0], shape,
                                          g.sampler)}
    for r in (0, 1):
        rows = slice(2 * r, 2 * r + 2)
        draws = out[r][case + "_draws"]
        kinds = [k for k, _, _ in draws]
        assert kinds[:2] == ["latents", "solver"] and len(draws) >= 4
        for kind, got_seeds, got in draws[:2]:
            assert got_seeds == seeds[rows]
            want = whole[kind][rows] if kind == "latents" else \
                whole[kind][:, :, rows]
            assert torch.equal(got, want)


def test_collectives_inside_sampling(ranks):
    """One all-reduce per mapped cross-attention per UNet call (16 a call,
    3 calls of Euler a; 1 of img2img at strength 0.5), none without a map,
    one all-gather for the result, nothing on a request rank 0 runs
    alone."""
    out, _, _, _ = ranks
    for o in out[:2]:
        assert o["cross_attentions"] == 16
        assert o["spmd_map_counts"] == {"all_reduce": 48, "all_gather": 1}
        assert o["spmd_nomap_counts"] == {"all_gather": 1}
        for name, calls in (("mapped", 3), ("cfg_off", 3), ("img2img", 1)):
            assert o[f"grid_{name}_counts"] == {"all_reduce": 16 * calls,
                                                "all_gather": 1}
    assert out[0]["solo_counts"] == {}
    assert out[0]["solo_shape"] == (1, 64, 64, 3)


def test_auto_resolves_to_no_mesh_when_the_batch_does_not_split(ranks):
    out, _, _, _ = ranks
    for o in out:
        assert o["backend"] == "gloo"
        assert o["auto_indivisible"] is None and o["auto_world"] == 4
    assert tmesh.resolve_mesh("auto", 4, "cpu") is None  # no group here


def test_inference_grid_through_the_request_channel(ranks):
    """rank 0's images against one process's, within one uint8 step (the
    fp32 latents agree to 2e-3 above); rank 1 ran the one grid request."""
    out, _, _, ref = ranks
    got, want = out[0]["inference"], ref["inference"]
    assert got.shape == want.shape == (4, 64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert out[1]["followed"] == 1


def test_a_follower_error_reaches_rank_0(ranks):
    """rank 1 lacks the model: both ranks raise before sampling, rank 0 with
    rank 1's message, at once (no timeout)."""
    out, _, _, _ = ranks
    message, seconds = out[0]["failure"]
    assert "rank 1: KeyError" in message and "only_on_rank_0" in message
    assert seconds < 10


def test_a_follower_failing_during_sampling_leaves_the_mesh(ranks):
    """rank 1 fails after 20 of a grid's all-reduces: it leaves the mesh and
    its process group ends; rank 0's request raises with rank 1's message
    as soon as the group is gone, not at the 60 s timeout, and rank 0 runs
    the next grid alone (no collective), equal to one process's."""
    out, _, _, ref = ranks
    assert "out of memory" in out[1]["left"]
    message, seconds = out[0]["lost"]
    assert "rank 1: RuntimeError: out of memory" in message
    assert seconds < 30
    assert out[0]["after_lost_counts"] == {}
    got, want = out[0]["after_lost"], ref["inference"]
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_replicate_broadcasts_rank_0s_tree(ranks):
    """Every tensor of the tree takes rank 0's values, in place, its layout
    kept (a channels_last kernel, a transposed matrix), one broadcast a
    tensor; None stays None."""
    out, _, _, _ = ranks
    want = torch.arange(6.0).reshape(2, 3).t()
    for o in out[:2]:
        w, (t, none) = o["replicated"]["w"], o["replicated"]["t"]
        assert torch.equal(w, torch.zeros(2, 3, 1, 1))
        assert w.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(t, want) and t.stride() == want.stride()
        assert none is None
        assert o["replicate_counts"] == {"broadcast": 2}


def test_server_under_torchrun_serves_a_grid_on_two_ranks(ranks):
    """The POST's PNGs are group 1's mesh inference() images (the same
    request on the same two-rank computation), bit for bit; rank 1 follows
    and ends when rank 0's server stops."""
    out, (status, body), codes, _ = ranks
    assert status == 200
    assert body["images"] == tserver._encode_images(out[0]["inference"])
    assert codes[1] == 0
