"""The port's control preprocessors on the CPU: the pure-image detectors,
the OpenCV replacements, ``resize_bilinear_align_corners``,
``ModelManager.register_preprocessor`` / ``get_preprocessor``, the
server's ``/preprocessors`` and ``/preprocess``, and ``inference()`` with
preprocessed ControlNet units, against the JAX package and OpenCV.

  * The pure-image detectors are numpy in both packages: equal bit for bit
    on uint8, [0, 1] and 0..255 float inputs.
  * ``ops/cv.py`` against ``cv2`` itself (installed here, not on the card's
    machine): ``resize_area`` (INTER_AREA at integer, non-integer,
    growing and mixed factors), ``draw_line`` (8-connected, clipped) and
    ``sobel`` (ksize 3, BORDER_REFLECT_101) bit for bit, on numpy arrays
    and on tensors.
  * The manager: each name's branch (NNET or DPT for "Normal Map", HED
    weights under "Soft Edge", the sub-net invalidation, the weightless
    configs, the unknown name's ``KeyError``) against the JAX manager's.
    The JAX manager's random weights are its ``PRNGKey(0)`` init, so only a
    weight file gives both packages one detector: "Depth" from one file
    runs in both within 1e-5.
  * ``inference()`` with a "Canny" and a "Depth" ControlNet unit: both
    packages with their pipeline class replaced by the recorder of
    tests/test_torch_app.py (no sampling program compiled; the units'
    sampling is held to the JAX package's in tests/test_torch_units.py)
    make the same calls, and the control images they hand the pipeline
    agree (Canny bit for bit, Depth within 1e-5).
"""

import base64
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu.app import api as japi
from diffusionspatialcontrol_tpu.models import dpt as jdpt
from diffusionspatialcontrol_tpu.models import normalbae as jnb
from diffusionspatialcontrol_tpu.models import openpose as jop
from diffusionspatialcontrol_tpu.ops import preprocess as jpp
from diffusionspatialcontrol_tpu.ops import resize as jresize
from diffusionspatialcontrol_tpu_torch import tiny_config
from diffusionspatialcontrol_tpu_torch.app import api as tapi
from diffusionspatialcontrol_tpu_torch.app import server as tserver
from diffusionspatialcontrol_tpu_torch.convert.safetensors import save_file
from diffusionspatialcontrol_tpu_torch.models import dpt as tdpt
from diffusionspatialcontrol_tpu_torch.models import hed as thed
from diffusionspatialcontrol_tpu_torch.models import lineart as tla
from diffusionspatialcontrol_tpu_torch.models import normalbae as tnb
from diffusionspatialcontrol_tpu_torch.models import openpose as top
from diffusionspatialcontrol_tpu_torch.ops import cv as tcv
from diffusionspatialcontrol_tpu_torch.ops import preprocess as tpp
from diffusionspatialcontrol_tpu_torch.ops import resize as tresize
from diffusionspatialcontrol_tpu_torch.runtime import native
from tests.test_torch_app import _CFG, PROMPT, _recorder

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)

_RNG = np.random.RandomState(0)
IMAGES = {
    "uint8": (_RNG.rand(48, 64, 3) * 255).astype(np.uint8),
    "float01": _RNG.rand(48, 64, 3).astype(np.float32),
    "float255": (_RNG.rand(48, 64, 3) * 255).astype(np.float32),
}


# -- the pure-image detectors ------------------------------------------------


def test_tables_equal_jax():
    assert list(tpp.NATIVE_PREPROCESSORS) == list(jpp.NATIVE_PREPROCESSORS)
    assert tpp.MODEL_BASED_PREPROCESSORS == jpp.MODEL_BASED_PREPROCESSORS
    assert tpp.NATIVE_MODEL_PREPROCESSORS == jpp.NATIVE_MODEL_PREPROCESSORS


@pytest.mark.parametrize("kind", sorted(IMAGES))
@pytest.mark.parametrize("name", sorted(jpp.NATIVE_PREPROCESSORS))
def test_pure_image_detectors_equal_jax(name, kind):
    img = IMAGES[kind]
    got = tpp.NATIVE_PREPROCESSORS[name](img)
    want = jpp.NATIVE_PREPROCESSORS[name](img)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_detector_options_equal_jax():
    square = np.zeros((40, 52, 3), np.uint8)
    square[10:30, 14:40] = 200
    for kw in ({}, {"low": 20.0, "high": 60.0}, {"sigma": 2.0}):
        np.testing.assert_array_equal(tpp.canny(square, **kw),
                                      jpp.canny(square, **kw))
    assert tpp.canny(square).max() == 1.0  # the square's border
    img = IMAGES["uint8"]
    for block in (8, 64, 100):
        np.testing.assert_array_equal(tpp.color_blocks(img, block),
                                      jpp.color_blocks(img, block))
    for f, seed in ((16, 0), (256, 3)):
        np.testing.assert_array_equal(tpp.content_shuffle(img, f, seed),
                                      jpp.content_shuffle(img, f, seed))
    for hw in ((17, 90), (96, 30)):
        np.testing.assert_array_equal(tpp.resize_nearest(img, *hw),
                                      jpp.resize_nearest(img, *hw))


# -- the OpenCV replacements -------------------------------------------------


@pytest.mark.parametrize("shape", [
    (64, 64, 64, 64), (128, 96, 64, 48), (100, 130, 64, 64),
    (513, 333, 128, 96), (40, 56, 96, 96), (64, 40, 48, 60),
    (37, 91, 64, 48)])
def test_resize_area_equals_cv2(shape):
    """Equal size, integer factors, non-integer shrinking, growing and
    mixed, on (H, W, 3) and (H, W)."""
    cv2 = pytest.importorskip("cv2")
    h, w, oh, ow = shape
    img = (np.random.RandomState(h + w).rand(h, w, 3) * 255).astype(
        np.float32)
    for x in (img, img[..., 0].copy()):
        want = cv2.resize(x, (ow, oh), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(tcv.resize_area(x, ow, oh), want)
        np.testing.assert_array_equal(
            tcv.resize_area(torch.from_numpy(x), ow, oh).numpy(), want)


def test_draw_line_equals_cv2():
    """Segments inside, across and outside the image, every direction."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(1)
    for _ in range(1500):
        h, w = rng.randint(4, 48, 2)
        p = [int(v) for v in rng.randint(-70, 120, 4)]
        want = np.zeros((h, w), np.float32)
        cv2.line(want, (p[0], p[1]), (p[2], p[3]), 1.0, 1)
        got = np.zeros((h, w), np.float32)
        tcv.draw_line(got, (p[0], p[1]), (p[2], p[3]))
        np.testing.assert_array_equal(got, want)
        t = torch.zeros((h, w))
        tcv.draw_line(t, (p[0], p[1]), (p[2], p[3]))
        np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("w", [3, 8, 13, 31, 64, 91])
def test_sobel_equals_cv2(w):
    """Widths with and without a scalar tail after the 8-lane body."""
    cv2 = pytest.importorskip("cv2")
    d = ((np.random.RandomState(w).rand(21, w) - 0.3) * 10).astype(
        np.float32)
    for dx, dy in ((1, 0), (0, 1)):
        want = cv2.Sobel(d, cv2.CV_32F, dx, dy, ksize=3)
        np.testing.assert_array_equal(tcv.sobel(d, dx, dy), want)
        np.testing.assert_array_equal(
            tcv.sobel(torch.from_numpy(d), dx, dy).numpy(), want)
    with pytest.raises(ValueError, match="dx, dy"):
        tcv.sobel(d, 1, 1)


@pytest.mark.parametrize("shape", [(8, 12, 16, 24), (5, 7, 20, 9),
                                   (9, 9, 9, 9), (1, 6, 4, 11)])
def test_resize_bilinear_align_corners_matches_jax(shape):
    h, w, oh, ow = shape
    x = np.random.RandomState(h).randn(2, h, w, 3).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear_align_corners(
        jnp.asarray(x), oh, ow))
    got = tresize.resize_bilinear_align_corners(torch.from_numpy(x), oh, ow)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -- the manager -------------------------------------------------------------


@pytest.fixture()
def manager():
    return tapi.ModelManager(dtype=torch.bfloat16, device="cpu")


def test_unknown_preprocessor_raises_as_jax(manager):
    with pytest.raises(KeyError) as t:
        manager.get_preprocessor("Depht")
    with pytest.raises(KeyError) as j:
        japi.ModelManager().get_preprocessor("Depht")
    assert str(t.value) == str(j.value)
    assert japi.ModelManager().get_preprocessor("Canny") is \
        jpp.NATIVE_PREPROCESSORS["Canny"]
    assert manager.get_preprocessor("Canny") is \
        tpp.NATIVE_PREPROCESSORS["Canny"]


def _small(m, d):
    """Small random weights, as files in the directory ``d``, for the
    names that build their published width without weights."""
    op = top.OpenposeConfig(8)
    for i, (name, sd) in enumerate((
            ("Openpose", top.random_state_dict(op, seed=0)),
            ("Openpose (hand)", top.random_hand_state_dict(op, seed=0)),
            ("Openpose (face)", top.random_face_state_dict(op, seed=0)),
            ("Soft Edge (HED)", thed.random_state_dict(
                thed.HEDConfig((4, 8, 8, 16, 16)), seed=0)),
            ("Lineart", tla.random_state_dict(tla.LineartConfig(8),
                                              seed=0)))):
        path = str(d / f"detector{i}.safetensors")
        save_file({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        m.register_preprocessor(name, path=path, detect_resolution=64)


@pytest.mark.parametrize("name", tpp.NATIVE_MODEL_PREPROCESSORS)
def test_every_model_based_name_builds_its_detector(manager, name,
                                                    tmp_path):
    """Each name runs its detector in fp32 on the manager's device (the
    manager is bf16), gives an (H, W, 3) image in [0, 1], and is built
    once."""
    _small(manager, tmp_path)
    fn = manager.get_preprocessor(name)
    assert manager.get_preprocessor(name) is fn
    out = fn(IMAGES["uint8"])
    assert out.shape == (48, 64, 3) and out.dtype == np.float32
    assert out.min() >= 0.0 and out.max() <= 1.0
    if name == "Instruct Pix2Pix":
        assert fn is tpp.NATIVE_PREPROCESSORS["None"]


def test_normal_map_branches_as_jax(manager, monkeypatch):
    """Without weights or an NNET config, "Normal Map" is the depth-gradient
    closure over the weightless DPT (or over what "Depth" registered);
    with an NNET config, NNET at 512 (the detect resolution of the
    registration otherwise); in both packages."""
    calls = []
    # the JAX manager's random inits would compile their draws (~40 s)
    monkeypatch.setattr(jdpt, "dpt_init", lambda *a, **k: {})
    monkeypatch.setattr(jnb, "nnet_init", lambda *a, **k: {})
    for mod, api in ((tpp, tapi), (jpp, japi)):
        for fn in ("make_normal_map_preprocessor",
                   "make_normalbae_preprocessor"):
            monkeypatch.setattr(mod, fn, lambda *a, _f=fn, _m=mod, **k:
                                calls.append((_m.__name__.split(".")[0], _f,
                                              k.get("detect_res"),
                                              type(a[1]).__name__)))
    jm = japi.ModelManager()
    for m, nb in ((manager, tnb), (jm, jnb)):
        m.get_preprocessor("Normal Map")
        m.register_preprocessor("Normal Map", cfg=nb.NNET_TINY)
        m.get_preprocessor("Normal Map")
        m.register_preprocessor("Normal Map", cfg=nb.NNET_TINY,
                                detect_resolution=128)
        m.get_preprocessor("Normal Map")
    t, j = calls[:3], calls[3:]
    assert [c[1:] for c in t] == [c[1:] for c in j] == [
        ("make_normal_map_preprocessor", None, "DPTConfig"),
        ("make_normalbae_preprocessor", 512, "NormalBaeConfig"),
        ("make_normalbae_preprocessor", 128, "NormalBaeConfig")]


def test_hed_weights_under_soft_edge_route_to_hed(manager, tmp_path):
    """A ControlNetHED file registered under "Soft Edge" runs HED in both
    packages: the same map as "Soft Edge (HED)" from that file, and the
    JAX manager's within 2e-5."""
    path = str(tmp_path / "hed.safetensors")
    save_file({k: torch.from_numpy(v) for k, v in thed.random_state_dict(
        thed.HEDConfig((4, 8, 8, 16, 16)), seed=2).items()}, path)
    manager.register_preprocessor("Soft Edge", path=path)
    manager.register_preprocessor("Soft Edge (HED)", path=path)
    img = IMAGES["uint8"]
    got = manager.get_preprocessor("Soft Edge")(img)
    np.testing.assert_array_equal(
        got, manager.get_preprocessor("Soft Edge (HED)")(img))
    jm = japi.ModelManager()
    jm.register_preprocessor("Soft Edge", path=path)
    np.testing.assert_allclose(got, jm.get_preprocessor("Soft Edge")(img),
                               rtol=0, atol=2e-5)


def test_detector_runs_without_tf32_at_its_published_width(manager,
                                                           monkeypatch):
    """A served detector runs with TF32 off and cuDNN deterministic
    whatever the process-wide settings say, and leaves them as they were;
    a name whose JAX branch reads no config draws its published width
    whatever ``cfg`` says."""
    seen = []
    small = tla.random_state_dict(tla.LineartConfig(8), seed=0)
    monkeypatch.setattr(tla, "random_state_dict",
                        lambda *a, **k: seen.append((a, k)) or small)
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(tla, "detect_lineart", lambda p, img: seen.append((
        cudnn.allow_tf32, cudnn.deterministic,
        torch.get_float32_matmul_precision())) or img)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    matmul = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        manager.register_preprocessor("Lineart", cfg=tla.LineartConfig(8))
        manager.get_preprocessor("Lineart")(IMAGES["uint8"])
        after = (cudnn.allow_tf32, cudnn.deterministic,
                 torch.get_float32_matmul_precision())
    finally:
        torch.set_float32_matmul_precision(matmul)
    assert seen == [((), {"seed": 0}), (False, True, "highest")]
    assert after == (True, False, "high")


def test_subnet_registration_rebuilds_the_parent(manager, tmp_path,
                                                 monkeypatch):
    """Registering "Openpose (hand)" drops a built "Openpose" closure in
    both packages, and the port's next one loads the hand file."""
    monkeypatch.setattr(jop, "openpose_body_init", lambda *a, **k: {})
    jm = japi.ModelManager()
    jfirst = jm.get_preprocessor("Openpose")
    assert jm.get_preprocessor("Openpose") is jfirst
    jm.register_preprocessor("Openpose (hand)", path="hand.pth")
    assert jm.get_preprocessor("Openpose") is not jfirst
    _small(manager, tmp_path)
    first = manager.get_preprocessor("Openpose")
    assert manager.get_preprocessor("Openpose") is first
    path = str(tmp_path / "hand.safetensors")
    save_file({k: torch.from_numpy(v) for k, v in
               top.random_hand_state_dict(top.OpenposeConfig(8), 5).items()},
              path)
    manager.register_preprocessor("Openpose (hand)", path=path)
    second = manager.get_preprocessor("Openpose")
    assert second is not first
    out = second(IMAGES["uint8"], include_hand=True, include_face=True)
    assert out.shape == (48, 64, 3)


def _dpt_file(tmp_path):
    path = str(tmp_path / "dpt.safetensors")
    save_file({k: torch.from_numpy(v) for k, v in tdpt.random_state_dict(
        tdpt.DPT_FALLBACK, seed=3).items()}, path)
    return path


def _jax_fallback():
    return jdpt.DPTConfig(**{f: getattr(tdpt.DPT_FALLBACK, f)
                             for f in tdpt.DPT_FALLBACK.__dataclass_fields__})


def test_depth_from_one_file_matches_jax(manager, tmp_path):
    path = _dpt_file(tmp_path)
    manager.register_preprocessor("Depth", path=path, cfg=tdpt.DPT_FALLBACK)
    jm = japi.ModelManager()
    jm.register_preprocessor("Depth", path=path, cfg=_jax_fallback())
    img = IMAGES["uint8"]
    got = manager.get_preprocessor("Depth")(img)
    want = jm.get_preprocessor("Depth")(img)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _units_run(package, monkeypatch, units, path):
    """(calls, unit images) of one inference() with ``units`` in
    ``package``, the pipeline class replaced by the recorder and the
    ControlNets by names."""
    log, arrays = [], []
    if package == "jax":
        api, m = japi, japi.ModelManager(dtype=jnp.float32)
        monkeypatch.setattr(api, "StableDiffusionTPU",
                            _recorder(log, np, arrays))
        m.register_preprocessor("Depth", path=path, cfg=_jax_fallback())
    else:
        api, m = tapi, tapi.ModelManager(dtype=torch.float32, device="cpu")
        monkeypatch.setattr(api, "StableDiffusionTorch",
                            _recorder(log, torch, arrays))
        m.register_preprocessor("Depth", path=path, cfg=tdpt.DPT_FALLBACK)
    m._dirs["tiny"] = ("", _CFG)
    m._cache["tiny"] = {}
    m._tokenizers["tiny"] = None
    m.get_controlnet = lambda name, cfg: f"controlnet {name}"
    out = api.inference(
        m, prompt=PROMPT, model="tiny", steps=4, width=64, height=64,
        dtype=jnp.float32 if package == "jax" else torch.float32,
        controlnet_units=[api.ControlNetUnit(**u) for u in units])
    assert out["images"].shape == (1, 64, 64, 3)
    return log, arrays


def test_inference_with_canny_and_depth_units_as_jax(monkeypatch, tmp_path):
    path = _dpt_file(tmp_path)
    photo = IMAGES["uint8"][:, :48]
    units = [
        {"model": "Canny", "image": photo, "preprocessor": "Canny",
         "preprocessor_options": {"low": 50.0, "high": 120.0}},
        {"model": "Depth", "image": photo, "preprocessor": "Depth",
         "scale": 0.7, "guidance_end": 0.8}]
    jlog, jarr = _units_run("jax", monkeypatch, units, path)
    tlog, tarr = _units_run("torch", monkeypatch, units, path)
    assert tlog == jlog
    assert len(tarr) == len(jarr) == 2
    np.testing.assert_array_equal(tarr[0], jarr[0])
    np.testing.assert_allclose(tarr[1], jarr[1], rtol=0, atol=1e-5)
    assert tarr[0].max() == 1.0  # Canny found edges


# -- the server --------------------------------------------------------------


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    m = tapi.ModelManager(dtype=torch.float32, device="cpu")
    m.register_random("tiny", tiny_config(), seed=0)
    _small(m, tmp_path_factory.mktemp("detectors"))
    m.register_preprocessor("Zoedepth", path="/nonexistent/zoe.safetensors")
    srv = tserver.serve(m, port=0, block=False)
    yield srv, m
    srv.shutdown()
    srv.server_close()


def _call(srv, path, payload=None):
    url = f"http://127.0.0.1:{srv.server_address[1]}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None
                                 else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_preprocessors_endpoint_is_jax_payload(server):
    srv, _ = server
    status, out = _call(srv, "/preprocessors")
    assert status == 200
    assert out == {
        "pure_image": sorted(jpp.NATIVE_PREPROCESSORS),
        "model_based_native": list(jpp.NATIVE_MODEL_PREPROCESSORS),
        "model_based_unavailable": [
            n for n in jpp.MODEL_BASED_PREPROCESSORS
            if n not in jpp.NATIVE_MODEL_PREPROCESSORS]}


@pytest.mark.parametrize("kind", ["float01", "uint8"])
def test_preprocess_endpoint_returns_the_detector_map(server, kind):
    """A nested-list image in [0, 1] or 0..255 is normalized to uint8 as
    the JAX server does; the PNG is the detector's map, rounded."""
    srv, m = server
    img = IMAGES[kind]
    status, out = _call(srv, "/preprocess", {
        "image": img.tolist(), "preprocessor": "Canny",
        "options": {"low": 60, "high": 150}})
    assert status == 200
    u8 = img * 255.0 if img.max() <= 1.0 else img
    u8 = np.clip(np.round(u8), 0, 255).astype(np.uint8)
    want = np.round(tpp.canny(u8, low=60, high=150) * 255).astype(np.uint8)
    assert base64.b64decode(out["image"]) == native.encode_png(want)
    status, out = _call(srv, "/preprocess", {
        "image": u8[..., 0].tolist(), "preprocessor": "Openpose",
        "options": {"include_hand": True}})
    assert status == 200
    gray = np.stack([np.clip(np.round(u8[..., 0]), 0, 255)] * 3, -1)
    want = np.round(m.get_preprocessor("Openpose")(
        gray.astype(np.uint8), include_hand=True) * 255).astype(np.uint8)
    assert base64.b64decode(out["image"]) == native.encode_png(want)


@pytest.mark.parametrize("case", [
    ("unknown name", {"image": [[0.5]], "preprocessor": "Dept"}, 400,
     "KeyError"),
    ("no image", {"preprocessor": "Canny"}, 400, "KeyError: 'image'"),
    ("bad option", {"image": [[0.5]], "preprocessor": "Canny",
                    "options": {"lo": 1}}, 400, "TypeError"),
    ("missing weights", {"image": [[0.5]], "preprocessor": "Zoedepth"}, 500,
     "FileNotFoundError"),
], ids=lambda c: c[0])
def test_preprocess_endpoint_errors(server, case):
    srv, _ = server
    _, payload, code, text = case
    status, out = _call(srv, "/preprocess", payload)
    assert status == code and text in out["error"]
