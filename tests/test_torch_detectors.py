"""The port's control-preprocessor networks and their detectors against the
JAX package's, on the CPU.

Weights: each port module's ``random_state_dict`` draws a state dict in the
published layout (numpy), and both packages' converters take it (the JAX
side through its ``convert.hf.StateDict``), so both compute on the same
weights; the JAX init is never compiled. Networks are held at small widths
on 64-256 pixel inputs, with the JAX package's own tolerances
(tests/test_preprocess.py), absolute as there: HED and lineart 2e-5, MLSD
3e-4, the openpose nets 3e-4 with rtol 3e-4, ZoeDepth 1e-4 with rtol 1e-3,
PidiNet 2e-4 with rtol 2e-4, NormalBae 2e-4; DPT's 3e-5 and UperNet's 5e-5
are taken relative to the output's largest value, as there. The JAX networks run
jitted at XLA backend optimization level 0 (2-4 s to compile the largest;
eager they take 10-20 s).

The thresholded tails (HED/PidiNet thinning, MLSD decoding and line
drawing, openpose peaks, pairing, assembly, boxes and drawing, the
segmentation palette, ZoeDepth's percentiles) are numpy: each detector
runs in both packages with its network replaced by one that returns the
same map, at the size the detector resizes to, so that both tails see the
same numbers, and their outputs must be equal bit for bit. Where a
detector resizes between the network and the tail, the outputs are held
to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu.convert import hf as jhf
from diffusionspatialcontrol_tpu.models import dpt as jdpt
from diffusionspatialcontrol_tpu.models import hed as jhed
from diffusionspatialcontrol_tpu.models import lineart as jla
from diffusionspatialcontrol_tpu.models import lineart_anime as jlaa
from diffusionspatialcontrol_tpu.models import mlsd as jmlsd
from diffusionspatialcontrol_tpu.models import normalbae as jnb
from diffusionspatialcontrol_tpu.models import openpose as jop
from diffusionspatialcontrol_tpu.models import pidinet as jpid
from diffusionspatialcontrol_tpu.models import upernet as jup
from diffusionspatialcontrol_tpu.models import zoedepth as jzoe
from diffusionspatialcontrol_tpu.ops import preprocess as jpp
from diffusionspatialcontrol_tpu_torch.models import dpt as tdpt
from diffusionspatialcontrol_tpu_torch.models import hed as thed
from diffusionspatialcontrol_tpu_torch.models import lineart as tla
from diffusionspatialcontrol_tpu_torch.models import lineart_anime as tlaa
from diffusionspatialcontrol_tpu_torch.models import mlsd as tmlsd
from diffusionspatialcontrol_tpu_torch.models import normalbae as tnb
from diffusionspatialcontrol_tpu_torch.models import openpose as top
from diffusionspatialcontrol_tpu_torch.models import pidinet as tpid
from diffusionspatialcontrol_tpu_torch.models import upernet as tup
from diffusionspatialcontrol_tpu_torch.models import zoedepth as tzoe
from diffusionspatialcontrol_tpu_torch.ops import preprocess as tpp

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

_FAST = {"xla_backend_optimization_level": 0}


def jjit(fn, static=()):
    return jax.jit(fn, static_argnums=static, compiler_options=_FAST)


def close(got, want, atol, rtol=0.0, scaled=False):
    """``got`` (torch or numpy) within ``atol`` and ``rtol`` of ``want``;
    with ``scaled``, ``atol`` is a fraction of ``want``'s largest value."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    if scaled:
        atol *= max(peak, 1e-6)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=f"max |want| {peak:.6g}")


def image(h, w, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def jcfg(jcls, tcfg):
    """The JAX package's config with the port config's fields."""
    return jcls(**{f.name: getattr(tcfg, f.name)
                   for f in dataclasses.fields(tcfg)})


def fake_nets(monkeypatch, jmod, tmod, name, make):
    """Replace the network ``name`` of both modules by one that returns
    ``make(pixels_shape)`` (a numpy array, or a tuple of them) for any
    parameters."""
    def as_j(a):
        if isinstance(a, tuple):
            return tuple(None if x is None else jnp.asarray(x) for x in a)
        return jnp.asarray(a)

    def as_t(a):
        if isinstance(a, tuple):
            return tuple(None if x is None else torch.from_numpy(x)
                         for x in a)
        return torch.from_numpy(a)

    def jnet(params, *args):
        return as_j(make(args[-1].shape))

    def tnet(params, *args, **kw):
        return as_t(make(tuple(args[-1].shape)))

    monkeypatch.setattr(jmod, name, jnet)
    monkeypatch.setattr(tmod, name, tnet)


# the port's detectors take the device from their parameters
TP = {"w": torch.zeros(1)}


# -- HED and PidiNet ---------------------------------------------------------

HED_TINY = thed.HEDConfig((8, 12, 16, 16, 24))


def test_hed_network_matches_jax():
    sd = thed.random_state_dict(HED_TINY, seed=1)
    x = image(48, 64)[None].astype(np.float32)
    want = jjit(jhed.hed_apply)(jhed.convert_hed(jhf.StateDict(sd)),
                                jnp.asarray(x))
    got = thed.hed_apply(thed.convert_hed(sd, "cpu"), torch.from_numpy(x))
    for g, w in zip(got, want):
        close(g, w, 2e-5)


@pytest.mark.parametrize("scribble", [False, True])
def test_hed_detector_matches_jax(scribble):
    """``detect_edges`` on the same weights: the side outputs' upsampling
    and sigmoid within 1e-6; the scribble tail (thinning, binarizing) on
    the JAX package's soft map bit for bit."""
    sd = thed.random_state_dict(HED_TINY, seed=1)
    jp, tp = jhed.convert_hed(jhf.StateDict(sd)), thed.convert_hed(sd, "cpu")
    img = image(50, 70, seed=2)
    soft = jhed.detect_edges(jp, img)
    close(thed.detect_edges(tp, img), soft, 2e-5)
    if scribble:
        np.testing.assert_array_equal(
            thed._nms_thin(soft[..., 0]), jpid._nms_thin(soft[..., 0]))
        assert set(np.unique(thed.detect_edges(tp, img, scribble=True))) \
            <= {0.0, 1.0}


def test_pidinet_fold_pdc_matches_jax():
    w = np.random.RandomState(0).randn(6, 4, 3, 3).astype(np.float32)
    for pdc in ("cv", "cd", "ad", "rd"):
        np.testing.assert_array_equal(tpid.fold_pdc(w, pdc),
                                      jpid.fold_pdc(w, pdc))
    with pytest.raises(ValueError, match="unknown pdc type"):
        tpid.fold_pdc(w, "xx")


def test_pidinet_network_matches_jax():
    """The published width (the JAX apply takes its groups from it)."""
    sd = tpid.random_state_dict(seed=3)
    x = np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32)
    want = jjit(jpid.pidinet_apply)(jpid.convert_pidinet(sd),
                                    jnp.asarray(x))
    got = tpid.pidinet_apply(tpid.convert_pidinet(sd, "cpu"),
                             torch.from_numpy(x))
    close(got, want, 2e-4, rtol=2e-4)


@pytest.mark.parametrize("scribble,safe", [(False, False), (False, True),
                                           (True, False)])
def test_pidinet_detector_tail_matches_jax(monkeypatch, scribble, safe):
    edge = np.random.RandomState(4).rand(1, 56, 72, 1).astype(np.float32)
    fake_nets(monkeypatch, jpid, tpid, "pidinet_apply", lambda s: edge)
    img = image(50, 70, seed=5)
    np.testing.assert_array_equal(
        tpid.detect_soft_edge(TP, img, scribble, safe),
        jpid.detect_soft_edge(None, img, scribble, safe))


def test_gauss_blur_matches_jax():
    y = np.random.RandomState(6).rand(40, 33).astype(np.float32)
    for sigma in (1.0, 3.0):
        np.testing.assert_array_equal(tpid._gauss_blur(y, sigma),
                                      jpid._gauss_blur(y, sigma))


# -- Lineart -----------------------------------------------------------------


def test_conv_transpose_s2_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 7, 4).astype(np.float32)
    w = rng.randn(4, 3, 3, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    want = jla.conv_transpose_s2(
        {"kernel": jnp.asarray(w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)),
         "bias": jnp.asarray(b)}, jnp.asarray(x))
    got = tla.conv_transpose_s2(
        {"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)},
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, want, 1e-6)


def test_lineart_matches_jax(monkeypatch):
    sd = tla.random_state_dict(tla.LineartConfig(8), seed=1)
    jp, tp = jla.convert_lineart(jhf.StateDict(sd)), \
        tla.convert_lineart(sd, "cpu")
    x = np.random.RandomState(1).rand(1, 32, 48, 3).astype(np.float32)
    close(tla.lineart_apply(tp, torch.from_numpy(x)),
          jjit(jla.lineart_apply)(jp, jnp.asarray(x)), 2e-5)
    line = np.random.RandomState(2).rand(1, 32, 48, 1).astype(np.float32)
    fake_nets(monkeypatch, jla, tla, "lineart_apply", lambda s: line)
    img = image(30, 46, seed=2)
    np.testing.assert_array_equal(tla.detect_lineart(TP, img),
                                  jla.detect_lineart(None, img))


def test_lineart_anime_matches_jax(monkeypatch):
    """UnetGenerator at ngf 4 on 256^2 (eight stride-2 levels); the
    detector's two resizes within 1e-6."""
    sd = tlaa.random_state_dict(tlaa.LineartAnimeConfig(4), seed=1)
    jp = jlaa.convert_lineart_anime(jhf.StateDict(sd))
    tp = tlaa.convert_lineart_anime(sd, "cpu")
    x = (np.random.RandomState(1).rand(1, 256, 256, 3) * 2 - 1).astype(
        np.float32)
    close(tlaa.lineart_anime_apply(tp, torch.from_numpy(x)),
          jjit(jlaa.lineart_anime_apply)(jp, jnp.asarray(x)), 2e-5)
    out = np.tanh(np.random.RandomState(3).randn(1, 256, 256, 1)).astype(
        np.float32)
    fake_nets(monkeypatch, jlaa, tlaa, "lineart_anime_apply",
              lambda s: out)
    img = image(100, 80, seed=2)
    close(tlaa.detect_lineart_anime(TP, img),
          jlaa.detect_lineart_anime(None, img), 1e-6)


# -- MLSD --------------------------------------------------------------------

MLSD_TINY = tmlsd.MLSDConfig(stem=8, stage_widths=(4, 6, 8, 8, 12),
                             decoder=8)


def test_mlsd_network_matches_jax():
    """Narrow widths, the published block structure; BatchNorm statistics
    drawn at random, so the folding is exercised."""
    sd = tmlsd.random_state_dict(MLSD_TINY, seed=1)
    x = (np.random.RandomState(1).rand(1, 64, 64, 4) * 2 - 1).astype(
        np.float32)
    want = jjit(jmlsd.mlsd_apply)(jmlsd.convert_mlsd(jhf.StateDict(sd)),
                                  jnp.asarray(x))
    got = tmlsd.mlsd_apply(tmlsd.convert_mlsd(sd, "cpu"),
                           torch.from_numpy(x))
    assert got.shape == (1, 32, 32, 9)
    close(got, want, 3e-4)


def test_mlsd_input_and_tail_match_jax(monkeypatch):
    """``detect_mlsd`` with both networks returning the same tpMap: the
    input (OpenCV's INTER_AREA resize and the ones plane in the JAX
    package, ``ops/cv.py`` here) and the drawn segments (``cv2.line``
    there) bit for bit, at a non-integer resize factor."""
    cv2 = pytest.importorskip("cv2")
    img = image(90, 70, seed=3)
    f = img.astype(np.float32)
    ones = np.ones((128, 128, 1), np.float32)
    want = (np.concatenate([cv2.resize(f, (128, 128),
                                       interpolation=cv2.INTER_AREA), ones],
                           -1)[None] / 127.5) - 1.0
    np.testing.assert_array_equal(tmlsd.mlsd_input(img, 128), want)
    rng = np.random.RandomState(4)
    tp = np.concatenate([rng.randn(64, 64, 1) * 3,
                         rng.randn(64, 64, 4) * 20,
                         rng.randn(64, 64, 4)], -1).astype(np.float32)
    fake_nets(monkeypatch, jmlsd, tmlsd, "mlsd_apply", lambda s: tp[None])
    got = tmlsd.detect_mlsd(TP, img, detect_res=128)
    np.testing.assert_array_equal(
        got, jmlsd.detect_mlsd(None, img, detect_res=128))
    assert got.sum() > 100  # segments were drawn
    np.testing.assert_array_equal(tmlsd.decode_lines(tp, 0.2, 15.0),
                                  jmlsd.decode_lines(tp, 0.2, 15.0))


# -- DPT ---------------------------------------------------------------------


def test_dpt_fallback_config_is_jax_managers():
    assert dataclasses.asdict(tdpt.DPT_FALLBACK) == dataclasses.asdict(
        jdpt.DPTConfig(image_size=256, patch_size=16, hidden_size=64,
                       num_layers=4, num_heads=4, intermediate_size=128,
                       backbone_out_indices=(0, 1, 2, 3),
                       neck_hidden_sizes=(32, 48, 64, 64),
                       fusion_hidden_size=32))
    assert dataclasses.asdict(tdpt.DPTConfig()) == dataclasses.asdict(
        jdpt.DPTConfig())


@pytest.mark.parametrize("hw", [(64, 96), (256, 256)])
def test_dpt_network_matches_jax(hw):
    """The fallback config at its own 256^2 grid and at another grid
    (the position table resized)."""
    cfg = tdpt.DPT_FALLBACK
    sd = tdpt.random_state_dict(cfg, seed=1)
    jc = jcfg(jdpt.DPTConfig, cfg)
    x = (np.random.RandomState(1).rand(1, *hw, 3) * 2 - 1).astype(np.float32)
    want = jjit(jdpt.dpt_apply, (1,))(jdpt.convert_dpt(jhf.StateDict(sd), jc),
                                      jc, jnp.asarray(x))
    got = tdpt.dpt_apply(tdpt.convert_dpt(sd, cfg, "cpu"), cfg,
                         torch.from_numpy(x))
    close(got, want, 3e-5, scaled=True)
    close(tdpt.depth_to_control_image(got),
          jdpt.depth_to_control_image(jnp.asarray(got.numpy())), 1e-6)


@pytest.mark.parametrize("kind", ["depth", "normal"])
def test_depth_and_normal_closures_match_jax(monkeypatch, kind):
    """The "Depth" and the weightless "Normal Map" closures around the same
    depth map, their resizes (antialiased in, back out) within 1e-6 (the
    normals 1e-5); the normals' tail (OpenCV's Sobel in the JAX package,
    ``ops/cv.py`` here, the mask and the normalization) on one depth map
    bit for bit."""
    cfg = tdpt.DPT_FALLBACK
    depth = np.random.RandomState(5).rand(1, 256, 256).astype(np.float32)
    fake_nets(monkeypatch, jdpt, tdpt, "dpt_apply", lambda s: depth * 3)
    img = image(80, 112, seed=6)
    make = ("make_depth_preprocessor" if kind == "depth"
            else "make_normal_map_preprocessor")
    got = getattr(tpp, make)(TP, cfg)(img)
    want = getattr(jpp, make)(None, jcfg(jdpt.DPTConfig, cfg))(img)
    close(got, want, 1e-5 if kind == "normal" else 1e-6)
    if kind == "normal":
        pytest.importorskip("cv2")
        import cv2

        d = np.random.RandomState(7).rand(37, 45).astype(np.float32)
        out = tpp.normal_from_depth(d)
        gx = cv2.Sobel(d, cv2.CV_32F, 1, 0, ksize=3)
        gy = cv2.Sobel(d, cv2.CV_32F, 0, 1, ksize=3)
        dn = (d - d.min()) / max((d - d.min()).max(), 1e-8)
        gx[dn < 0.1] = 0.0
        gy[dn < 0.1] = 0.0
        n = np.stack([gx, gy, np.ones_like(gx) * 2.0 * np.pi], axis=2)
        n /= np.sqrt((n ** 2).sum(axis=2, keepdims=True))
        np.testing.assert_array_equal(
            out, (n * 0.5 + 0.5).clip(0.0, 1.0)[:, :, ::-1])


# -- Openpose ----------------------------------------------------------------

OP_TINY = top.OpenposeConfig(div=8)


@pytest.mark.parametrize("net", ["body", "hand", "face"])
def test_openpose_networks_match_jax(net):
    draw = {"body": top.random_state_dict,
            "hand": top.random_hand_state_dict,
            "face": top.random_face_state_dict}[net]
    sd = draw(OP_TINY, seed=1)
    x = (np.random.RandomState(1).rand(1, 64, 48, 3) - 0.5).astype(
        np.float32)
    jconv = getattr(jop, f"convert_openpose_{net}")
    japply = getattr(jop, f"openpose_{net}_apply")
    want = jjit(japply)(jconv(jhf.StateDict(sd)), jnp.asarray(x))
    got = getattr(top, f"openpose_{net}_apply")(
        getattr(top, f"convert_openpose_{net}")(sd, "cpu"),
        torch.from_numpy(x))
    for g, w in zip(got if net == "body" else [got],
                    want if net == "body" else [want]):
        close(g, w, 3e-4, rtol=3e-4)


_POSE = {1: (48, 20), 2: (30, 28), 3: (26, 48), 4: (24, 66), 0: (50, 8),
         14: (44, 4)}
_LIMBS = ((0, (1, 2)), (2, (2, 3)), (3, (3, 4)), (12, (1, 0)),
          (13, (0, 14)))


def pose_maps(h, w):
    """A person's heat and PAF maps (h, w, 19), (h, w, 38): neck, right arm
    and the head (nose, right eye), the limbs painted as unit fields."""
    heat = np.zeros((h, w, 19), np.float32)
    paf = np.zeros((h, w, 38), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for part, (x0, y0) in _POSE.items():
        heat[:, :, part] = np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                                  / (2 * 4.0 ** 2))
    for k, (a, b) in _LIMBS:
        (ax, ay), (bx, by) = _POSE[a], _POSE[b]
        vec = np.array([bx - ax, by - ay], np.float64)
        vec /= np.sqrt((vec ** 2).sum())
        on = (np.abs((xx - ax) * vec[1] - (yy - ay) * vec[0]) < 6) & (
            ((xx - ax) * vec[0] + (yy - ay) * vec[1]) > -4) & (
            ((xx - bx) * vec[0] + (yy - by) * vec[1]) < 4)
        ch = jop.MAP_IDX[k][0] - 19
        paf[:, :, ch][on] = vec[0]
        paf[:, :, ch + 1][on] = vec[1]
    return heat, paf


def test_openpose_tail_functions_match_jax():
    heat, paf = pose_maps(96, 96)
    peaks = top.find_peaks(heat)
    assert peaks == jop.find_peaks(heat)
    conns, special = top.pair_limbs(paf, peaks, orig_h=96)
    assert (conns, special) == jop.pair_limbs(paf, peaks, orig_h=96)
    subset, cand = top.assemble_subsets(peaks, conns, special)
    jsub, jcand = jop.assemble_subsets(peaks, conns, special)
    np.testing.assert_array_equal(subset, jsub)
    np.testing.assert_array_equal(cand, jcand)
    assert len(subset) == 1
    np.testing.assert_array_equal(top.draw_bodypose(96, 96, cand, subset),
                                  jop.draw_bodypose(96, 96, cand, subset))
    big = cand.copy()
    big[:, :2] *= 3.0
    assert top.hand_boxes_from_body(big, subset, 300, 300) == \
        jop.hand_boxes_from_body(big, subset, 300, 300) != []
    assert top.face_box_from_body(big, subset, 300, 300) == \
        jop.face_box_from_body(big, subset, 300, 300) != []
    rng = np.random.RandomState(8)
    hm = rng.rand(40, 40, 21).astype(np.float32) * 0.3
    for sigma in (3.0, 0.0):
        pk = top.peaks_from_heatmaps(hm, sigma=sigma)
        np.testing.assert_array_equal(pk, jop.peaks_from_heatmaps(
            hm, sigma=sigma))
        c1, c2 = np.zeros((60, 60, 3), np.float32), \
            np.zeros((60, 60, 3), np.float32)
        top.draw_handpose(c1, pk)
        jop.draw_handpose(c2, pk)
        top.draw_facepose(c1, pk)
        jop.draw_facepose(c2, pk)
        np.testing.assert_array_equal(c1, c2)


def test_openpose_detector_matches_jax(monkeypatch):
    """``detect_pose`` with the body, hand and face nets replaced by maps
    at the sizes the detector resizes to: the whole tail, the hand and
    face crops included, bit for bit."""
    heat, paf = pose_maps(96, 96)
    fake_nets(monkeypatch, jop, top, "openpose_body_apply",
              lambda s: (paf[None], heat[None]))

    def blobs(n):
        def make(shape):
            side = shape[1]
            yy, xx = np.mgrid[0:side, 0:side]
            out = np.zeros((1, side, side, n), np.float32)
            for c in range(n):
                cx, cy = (c * 7) % side, (c * 11) % side
                out[0, :, :, c] = 0.5 * np.exp(
                    -((xx - cx) ** 2 + (yy - cy) ** 2) / 8.0)
            return out
        return make

    for mod in (jop, top):
        monkeypatch.setattr(mod, "HAND_SCALES", (1.0,))
        monkeypatch.setattr(mod, "HAND_BOXSIZE", 48)
        monkeypatch.setattr(mod, "FACE_BOXSIZE", 48)
    fake_nets(monkeypatch, jop, top, "openpose_hand_apply", blobs(22))
    fake_nets(monkeypatch, jop, top, "openpose_face_apply", blobs(71))
    img = image(96, 96, seed=9)
    kw = dict(detect_resolution=96, include_hand=True, include_face=True)
    got = top.detect_pose(TP, img, hand_params=TP, face_params=TP, **kw)
    want = jop.detect_pose(None, img, hand_params={}, face_params={}, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got == np.array([0.0, 0.0, 1.0], np.float32)).all(-1).any()
    got = top.detect_pose(TP, img.astype(np.float32), include_body=False,
                          detect_resolution=96)
    np.testing.assert_array_equal(got, jop.detect_pose(
        None, img.astype(np.float32), include_body=False,
        detect_resolution=96))


# -- UperNet -----------------------------------------------------------------


def test_upernet_fallback_config_is_jax_managers():
    assert dataclasses.asdict(tup.UPERNET_FALLBACK) == dataclasses.asdict(
        jup.UperNetConfig(hidden_sizes=(32, 48, 64, 96),
                          depths=(1, 1, 2, 1), head_channels=64))


def test_upernet_network_matches_jax():
    cfg = tup.UperNetConfig(hidden_sizes=(8, 12, 16, 24),
                            depths=(1, 1, 2, 1), head_channels=16,
                            num_labels=10)
    sd = tup.random_state_dict(cfg, seed=1)
    jc = jcfg(jup.UperNetConfig, cfg)
    x = np.random.RandomState(1).randn(1, 64, 96, 3).astype(np.float32)
    want = jjit(jup.upernet_apply, (1,))(
        jup.convert_upernet(jhf.StateDict(sd), jc), jc, jnp.asarray(x))
    got = tup.upernet_apply(tup.convert_upernet(sd, cfg, "cpu"), cfg,
                            torch.from_numpy(x))
    close(got, want, 5e-5, scaled=True)


def test_segmentation_closure_matches_jax(monkeypatch):
    """Argmax, the palette and the nearest resize on the same logits bit
    for bit (the input's antialiased resize feeds only the network)."""
    logits = np.random.RandomState(10).randn(1, 32, 64, 150).astype(
        np.float32)
    fake_nets(monkeypatch, jup, tup, "upernet_apply", lambda s: logits)
    img = image(30, 40, seed=11)
    cfg = tup.UPERNET_FALLBACK
    np.testing.assert_array_equal(
        tpp.make_segmentation_preprocessor(TP, cfg)(img),
        jpp.make_segmentation_preprocessor(
            None, jcfg(jup.UperNetConfig, cfg))(img))


# -- NormalBae ---------------------------------------------------------------


def test_nnet_tiny_is_jax():
    assert dataclasses.asdict(tnb.NNET_TINY) == dataclasses.asdict(
        jnb.NNET_TINY)
    assert dataclasses.asdict(tnb.NormalBaeConfig()) == dataclasses.asdict(
        jnb.NormalBaeConfig())


def jax_draws(seed, b, sizes):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    return [np.asarray(jax.random.uniform(k, (b, n)))
            for k, n in zip(keys, sizes)]


def test_nnet_network_matches_jax():
    """NNET_TINY on 64^2 with the JAX package's own coverage draws."""
    cfg = tnb.NNET_TINY
    sd = tnb.random_state_dict(cfg, seed=1)
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    want = jjit(jnb.nnet_apply, (1,))(
        jnb.convert_nnet(jhf.StateDict(sd), jnb.NNET_TINY), jnb.NNET_TINY,
        jnp.asarray(x), jax.random.PRNGKey(3))
    got = tnb.nnet_apply(tnb.convert_nnet(sd, cfg, "cpu"), cfg,
                         torch.from_numpy(x),
                         draws=jax_draws(3, 1, (256, 1024, 4096)))
    close(got, want, 2e-4)


def test_normalbae_detector_tail_matches_jax(monkeypatch):
    out = np.random.RandomState(12).randn(1, 128, 192, 4).astype(np.float32)
    fake_nets(monkeypatch, jnb, tnb, "nnet_apply", lambda s: out)
    monkeypatch.setattr(jnb, "_nnet_apply_jit",
                        lambda p, c, x, k: jnp.asarray(out))
    img = image(60, 90, seed=13)
    close(tnb.detect_normalbae(TP, img, tnb.NNET_TINY, detect_res=128),
          jnb.detect_normalbae(None, img, jnb.NNET_TINY, detect_res=128),
          1e-6)


# -- ZoeDepth ----------------------------------------------------------------


def test_zoe_tiny_is_jax():
    assert dataclasses.asdict(tzoe.ZOE_TINY) == dataclasses.asdict(
        jzoe.ZOE_TINY)
    assert dataclasses.asdict(tzoe.ZoeDepthConfig()) == dataclasses.asdict(
        jzoe.ZoeDepthConfig())


@pytest.mark.parametrize("multi", [True, False])
def test_zoedepth_network_matches_jax(multi):
    """ZOE_TINY on 64 x 96 (the relative position bias resized to the 4 x 6
    window): the NYU/KITTI router with both bin heads, and the single
    head."""
    cfg = tzoe.ZOE_TINY if multi else dataclasses.replace(
        tzoe.ZOE_TINY, bin_configurations=(tzoe.ZoeBinConfig("nyu", 8),))
    jc = jzoe.ZOE_TINY if multi else dataclasses.replace(
        jzoe.ZOE_TINY, bin_configurations=(jzoe.ZoeBinConfig("nyu", 8),))
    sd = tzoe.random_state_dict(cfg, seed=1)
    x = (np.random.RandomState(1).rand(1, 64, 96, 3) * 2 - 1).astype(
        np.float32)
    jd, jl = jjit(jzoe.zoedepth_apply, (1,))(
        jzoe.convert_zoedepth(jhf.StateDict(sd), jc), jc, jnp.asarray(x))
    td, tl = tzoe.zoedepth_apply(tzoe.convert_zoedepth(sd, cfg, "cpu"), cfg,
                                 torch.from_numpy(x))
    close(td, jd, 1e-4, rtol=1e-3)
    if multi:
        close(tl, jl, 1e-4, rtol=1e-3)
    else:
        assert tl is None and jl is None


def test_zoedepth_detector_tail_matches_jax(monkeypatch):
    """The flip average, the resize to the image and the percentile
    normalization on the same depth: at the image's own size bit for
    bit."""
    depth = np.random.RandomState(14).rand(1, 64, 96).astype(np.float32)
    fake_nets(monkeypatch, jzoe, tzoe, "zoedepth_apply",
              lambda s: (depth, None))
    img = image(64, 96, seed=15)
    np.testing.assert_array_equal(
        tzoe.detect_zoedepth(TP, img, tzoe.ZOE_TINY, target=(64, 96)),
        jzoe.detect_zoedepth(None, img, jzoe.ZOE_TINY, target=(64, 96)))
