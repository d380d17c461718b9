"""The port's FaceID face models against the JAX package's, on the CPU, fp32,
at the tiny presets: the stub embedder (``ops/face_embed.py``), ArcFace
(``models/arcface.py``) and the SCRFD detector with its decode and
alignment (``models/face_detect.py``).

* ``embed_face``/``embed_faces`` (numpy in both): bit for bit;
* ``scrfd_apply`` and ``arcface_apply`` on random torch-layout state
  dicts converted by the JAX package's converters (its ``*_init`` compile
  an op a shape: half a minute on the CPU), through ``params_from_jax``:
  rtol/atol 1e-5; the port's own inits build the same trees;
* the numpy decode, NMS, Umeyama, ``warp_affine`` and ``norm_crop``: bit
  for bit on the same inputs (``decode_scrfd``'s scores within 1e-6: its
  sigmoid is numpy's in the port, XLA's in the JAX package);
* ``detect_faces`` and ``make_arcface_embedder`` end to end on the same
  weights and photo: boxes and landmarks to 1e-5 relative, the unit
  embedding to 1e-5;
* ``convert_arcface`` and ``convert_scrfd`` on one torch-layout state dict
  each: the trees of ``params_from_jax`` of the JAX package's conversion,
  bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu.convert.hf import StateDict
from diffusionspatialcontrol_tpu.models import arcface as jaf
from diffusionspatialcontrol_tpu.models import face_detect as jfd
from diffusionspatialcontrol_tpu.ops import face_embed as jfe
from diffusionspatialcontrol_tpu_torch.convert.from_jax import params_from_jax
from diffusionspatialcontrol_tpu_torch.models import arcface as taf
from diffusionspatialcontrol_tpu_torch.models import face_detect as tfd
from diffusionspatialcontrol_tpu_torch.ops import face_embed as tfe

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)


def _photo(seed, shape=(96, 80, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def test_configs_equal_jax():
    for t, j in ((taf.ArcFaceConfig(), jaf.ArcFaceConfig()),
                 (taf.ARCFACE_TINY, jaf.ARCFACE_TINY),
                 (tfd.FaceDetectConfig(), jfd.FaceDetectConfig()),
                 (tfd.FACEDETECT_TINY, jfd.FACEDETECT_TINY)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert np.array_equal(tfd.ARCFACE_DST, jfd.ARCFACE_DST)


@pytest.mark.parametrize("kind", ["uint8", "unit", "over_one", "zeros"])
def test_stub_embedder_is_bitwise_jax(kind):
    img = _photo(3, (40, 36, 3))
    img = {"uint8": img, "unit": img.astype(np.float32) / 255.0,
           "over_one": img.astype(np.float32),
           "zeros": np.zeros((20, 20, 3), np.float32)}[kind]
    got, want = tfe.embed_face(img), jfe.embed_face(img)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    imgs = [img, _photo(4, (17, 33, 3))]
    assert np.array_equal(tfe.embed_faces(imgs), jfe.embed_faces(imgs))
    with pytest.raises(ValueError, match="face crop"):
        tfe.embed_face(np.zeros((8, 8)))


# -- the networks --------------------------------------------------------------

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# the networks' JAX references jitted: one compile a network, not one an op
_jax_scrfd = jax.jit(jfd.scrfd_apply, static_argnums=(2,))
_jax_arcface = jax.jit(jaf.arcface_apply, static_argnums=(1,))


@pytest.fixture(scope="module")
def nets():
    """(JAX SCRFD, the port's, JAX ArcFace, the port's) at the tiny
    presets, from random state dicts (BatchNorm statistics drawn too)."""
    rng = np.random.default_rng(1)
    jdet = _np(jfd.convert_scrfd(_scrfd_sd(jfd.FACEDETECT_TINY, rng),
                                 jfd.FACEDETECT_TINY, jnp.float32))
    jarc = _np(jaf.convert_arcface(StateDict(
        _arcface_sd(jaf.ARCFACE_TINY, rng)), jaf.ARCFACE_TINY, jnp.float32))
    return (jdet, params_from_jax(jdet, device="cpu"),
            jarc, params_from_jax(jarc, device="cpu"))


def test_scrfd_apply_matches_jax(nets):
    jdet, tdet, _, _ = nets
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    want = _jax_scrfd(jdet, jnp.asarray(x), jfd.FACEDETECT_TINY)
    got = tfd.scrfd_apply(tdet, torch.from_numpy(x), tfd.FACEDETECT_TINY)
    assert len(got) == len(want) == 3
    for g3, w3 in zip(got, want):
        for g, w in zip(g3, w3):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def test_arcface_apply_matches_jax(nets):
    _, _, jarc, tarc = nets
    x = np.random.default_rng(6).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(_jax_arcface(jarc, jaf.ARCFACE_TINY,
                                        jnp.asarray(x)))
    got = taf.arcface_apply(tarc, taf.ARCFACE_TINY, torch.from_numpy(x))
    assert got.shape == want.shape == (2, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_port_inits_have_the_jax_trees(nets):
    """The port's random inits build the trees (names, shapes, dtypes) of
    the JAX package's converted ones, which its inits build too."""
    jdet, _, jarc, _ = nets
    for t_init, tc, jtree in (
            (tfd.scrfd_init, tfd.FACEDETECT_TINY, jdet),
            (taf.arcface_init, taf.ARCFACE_TINY, jarc)):
        tp = t_init(torch.Generator().manual_seed(0), tc, torch.float32,
                    "cpu")
        conv = params_from_jax(jtree, device="cpu")
        assert jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, tp)) == \
            jax.tree_util.tree_structure(
                jax.tree_util.tree_map(lambda t: 0, conv))
        for a, b in zip(jax.tree_util.tree_leaves(tp),
                        jax.tree_util.tree_leaves(conv)):
            assert a.shape == b.shape and a.dtype == b.dtype


# -- decode and alignment (numpy) --------------------------------------------

def test_numpy_decode_and_alignment_are_bitwise_jax():
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 64, (50, 2)).astype(np.float32)
    dist = rng.uniform(0, 20, (50, 4)).astype(np.float32)
    kd = rng.standard_normal((50, 10)).astype(np.float32) * 5
    assert np.array_equal(tfd.distance2bbox(pts, dist),
                          jfd.distance2bbox(pts, dist))
    assert np.array_equal(tfd.distance2kps(pts, kd), jfd.distance2kps(pts, kd))
    boxes = tfd.distance2bbox(pts, dist)
    dets = np.concatenate([boxes, rng.random((50, 1), np.float32)], axis=1)
    for thresh in (0.1, 0.4, 0.9):
        assert tfd.nms(dets, thresh) == jfd.nms(dets, thresh)
    lmk = (jfd.ARCFACE_DST * 1.7 + rng.standard_normal((5, 2)) * 3 +
           20).astype(np.float32)
    for size in (112, 224, 128):
        assert np.array_equal(tfd.estimate_norm(lmk, size),
                              jfd.estimate_norm(lmk, size))
    src = rng.standard_normal((5, 2))
    assert np.array_equal(tfd.umeyama_similarity(src, src[::-1] * 2),
                          jfd.umeyama_similarity(src, src[::-1] * 2))
    photo = _photo(8)
    m = tfd.estimate_norm(lmk)
    assert np.array_equal(tfd.warp_affine(photo, m, 112),
                          jfd.warp_affine(photo, m, 112))
    crop = tfd.norm_crop(photo.astype(np.float32), lmk)
    assert crop.shape == (112, 112, 3)
    assert np.array_equal(crop, jfd.norm_crop(photo.astype(np.float32), lmk))


@pytest.mark.parametrize("thresh,top1", [(0.5, False), (2.0, True),
                                         (2.0, False)])
def test_decode_scrfd_matches_jax(nets, thresh, top1):
    """The same raw outputs through both decodes: scores within 1e-6, the
    boxes and landmarks bit for bit (a threshold nothing clears, with and
    without the fallback)."""
    jdet, _, _, _ = nets
    x = np.random.default_rng(9).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    outs = [tuple(np.asarray(t) for t in o) for o in
            _jax_scrfd(jdet, jnp.asarray(x), jfd.FACEDETECT_TINY)]
    kw = dict(det_scale=0.8, score_thresh=thresh, top1_fallback=top1)
    gd, gk = tfd.decode_scrfd(outs, tfd.FACEDETECT_TINY, **kw)
    wd, wk = jfd.decode_scrfd(outs, jfd.FACEDETECT_TINY, **kw)
    assert gd.shape == wd.shape and gk.shape == wk.shape
    assert len(gd) == (1 if thresh > 1 and top1 else
                       0 if thresh > 1 else len(wd))
    assert np.array_equal(gd[:, :4], wd[:, :4]) and np.array_equal(gk, wk)
    np.testing.assert_allclose(gd[:, 4], wd[:, 4], rtol=0, atol=1e-6)


def test_detect_and_embed_end_to_end_match_jax(nets):
    """A raw 96 x 80 photo: resized onto the 64^2 canvas, detected,
    aligned and embedded by a 32^2 ArcFace; with a threshold nothing clears
    the top-1 fallback gives the best anchor, without it no crop."""
    jdet, tdet, jarc, tarc = nets
    photo = _photo(10)
    want = jfd.detect_faces(jdet, photo, jfd.FACEDETECT_TINY,
                            top1_fallback=True)
    got = tfd.detect_faces(tdet, photo, tfd.FACEDETECT_TINY,
                           top1_fallback=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(g) >= 1
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    high = dataclasses.replace(tfd.FACEDETECT_TINY, score_thresh=2.0)
    top1 = tfd.detect_faces(tdet, photo, high, top1_fallback=True)
    assert len(top1[0]) == 1
    assert np.array_equal(top1[0][0, :4], got[0][0, :4])  # the best anchor
    crop = tfd.make_face_aligner(tdet, high, top1_fallback=True)(photo)
    assert crop.shape == (112, 112, 3) and crop.dtype == np.float32
    assert np.array_equal(crop, tfd.norm_crop(photo.astype(np.float32),
                                              got[1][0]))
    assert tfd.make_face_aligner(tdet, high)(photo) is None
    for img in (crop, photo, photo.astype(np.float32) / 255.0):
        e_t = taf.make_arcface_embedder(tarc, taf.ARCFACE_TINY)(img)
        e_j = jaf.make_arcface_embedder(jarc, jaf.ARCFACE_TINY)(img)
        assert e_t.shape == (32,) and abs(np.linalg.norm(e_t) - 1) < 1e-5
        np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-5)


# -- converters ----------------------------------------------------------------

def _bn(sd, key, c, rng):
    sd[f"{key}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sd[f"{key}.bias"] = rng.standard_normal(c).astype(np.float32)
    sd[f"{key}.running_mean"] = rng.standard_normal(c).astype(np.float32)
    sd[f"{key}.running_var"] = rng.uniform(0.5, 2, c).astype(np.float32)


def _conv(sd, key, cin, cout, k, rng, bias=False):
    sd[f"{key}.weight"] = (rng.standard_normal((cout, cin, k, k))
                           / np.sqrt(cin * k * k)).astype(np.float32)
    if bias:
        sd[f"{key}.bias"] = rng.standard_normal(cout).astype(np.float32)


def _arcface_sd(cfg, rng):
    sd = {}
    _conv(sd, "conv1", 3, cfg.stem_channels, 3, rng)
    _bn(sd, "bn1", cfg.stem_channels, rng)
    sd["prelu.weight"] = rng.random(cfg.stem_channels).astype(np.float32)
    cin = cfg.stem_channels
    for li, (w, reps) in enumerate(zip(cfg.widths, cfg.layers), 1):
        for i in range(reps):
            b = f"layer{li}.{i}"
            _bn(sd, f"{b}.bn1", cin, rng)
            _conv(sd, f"{b}.conv1", cin, w, 3, rng)
            _bn(sd, f"{b}.bn2", w, rng)
            sd[f"{b}.prelu.weight"] = rng.random(w).astype(np.float32)
            _conv(sd, f"{b}.conv2", w, w, 3, rng)
            _bn(sd, f"{b}.bn3", w, rng)
            if i == 0:
                _conv(sd, f"{b}.downsample.0", cin, w, 1, rng)
                _bn(sd, f"{b}.downsample.1", w, rng)
            cin = w
    _bn(sd, "bn2", cin, rng)
    fc_in = cin * cfg.final_spatial ** 2
    sd["fc.weight"] = (rng.standard_normal((cfg.embed_dim, fc_in))
                       / np.sqrt(fc_in)).astype(np.float32)
    sd["fc.bias"] = rng.standard_normal(cfg.embed_dim).astype(np.float32)
    _bn(sd, "features", cfg.embed_dim, rng)
    return sd


def _scrfd_sd(cfg, rng):
    sd = {}
    sc = cfg.stem_channels
    for i, cin in enumerate((3, sc, sc)):
        _conv(sd, f"backbone.stem.{i}.conv", cin, sc, 3, rng)
        _bn(sd, f"backbone.stem.{i}.bn", sc, rng)
    cin = sc
    for si, (n, w) in enumerate(zip(cfg.stage_blocks, cfg.stage_widths)):
        for bi in range(n):
            pre = f"backbone.layer{si + 1}.{bi}"
            _conv(sd, f"{pre}.conv1", cin, w, 3, rng)
            _bn(sd, f"{pre}.bn1", w, rng)
            _conv(sd, f"{pre}.conv2", w, w, 3, rng)
            _bn(sd, f"{pre}.bn2", w, rng)
            if cin != w or (bi == 0 and si > 0):
                _conv(sd, f"{pre}.downsample.0", cin, w, 1, rng)
                _bn(sd, f"{pre}.downsample.1", w, rng)
            cin = w
    nc = cfg.neck_channels
    for i, w in enumerate(cfg.stage_widths[1:]):
        _conv(sd, f"neck.lateral_convs.{i}.conv", w, nc, 1, rng, bias=True)
        _conv(sd, f"neck.fpn_convs.{i}.conv", nc, nc, 3, rng, bias=True)
    hin = nc
    for i in range(cfg.head_convs):
        _conv(sd, f"bbox_head.cls_convs.{i}.conv", hin, cfg.head_channels,
              3, rng, bias=True)
        hin = cfg.head_channels
    a = cfg.num_anchors
    for name, c in (("cls_pred", a), ("reg_pred", 4 * a),
                    ("kps_pred", 10 * a)):
        _conv(sd, f"bbox_head.{name}", hin, c, 3, rng, bias=True)
    return sd


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, got)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0,
                                                            want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_converters_match_jax():
    rng = np.random.default_rng(11)
    sd = _arcface_sd(taf.ARCFACE_TINY, rng)
    got = taf.convert_arcface(sd, taf.ARCFACE_TINY, torch.float32, "cpu")
    want = jaf.convert_arcface(StateDict(dict(sd)), jaf.ARCFACE_TINY,
                               jnp.float32)
    _assert_trees_equal(got, params_from_jax(
        jax.tree_util.tree_map(np.asarray, want), device="cpu"))
    x = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        taf.arcface_apply(got, taf.ARCFACE_TINY, torch.from_numpy(x)).numpy(),
        np.asarray(_jax_arcface(want, jaf.ARCFACE_TINY, jnp.asarray(x))),
        rtol=1e-5, atol=1e-4)
    sd = _scrfd_sd(tfd.FACEDETECT_TINY, rng)
    got = tfd.convert_scrfd(sd, tfd.FACEDETECT_TINY, torch.float32, "cpu")
    want = jfd.convert_scrfd(sd, jfd.FACEDETECT_TINY, jnp.float32)
    _assert_trees_equal(got, params_from_jax(
        jax.tree_util.tree_map(np.asarray, want), device="cpu"))
