"""The port's Gradio front-end on the CPU, without ``gradio``.

``app/gradio_ui.py`` imports ``gradio`` in ``build_ui`` only, so its
helpers are held to the JAX package's (tests/test_app.py's mask and option
cases, and more inputs), and ``build_ui`` is built over a stub ``gradio``
module (components that take any arguments, layout blocks that are context
managers, a ``Button.click`` that records its callback), whose Generate
callback then runs once on the tiny model with a ControlNet unit whose
preprocessor is "Canny": the UI's wiring into the port's ``inference()``.
Without ``gradio``, ``build_ui`` raises ``ImportError``.
"""

import sys
import types

import numpy as np
import pytest
import torch

from diffusionspatialcontrol_tpu.app import gradio_ui as jgu
from diffusionspatialcontrol_tpu_torch import tiny_config
from diffusionspatialcontrol_tpu_torch.app import api as tapi
from diffusionspatialcontrol_tpu_torch.app import gradio_ui as tgu

# One intra-op thread per xdist worker: the workers share the CPU's cores.
torch.set_num_threads(1)


def test_tables_equal_jax():
    assert tgu._PREPROCESSORS == jgu._PREPROCESSORS
    assert tgu.N_CONTROLNET_UNITS == jgu.N_CONTROLNET_UNITS


@pytest.mark.parametrize("text", ["", None, "0.5", "1, 2.5,, 3 ", " ,"])
def test_to_float_list_equals_jax(text):
    assert tgu._to_float_list(text) == jgu._to_float_list(text)


def test_image_helpers_equal_jax():
    gray_u8 = np.zeros((8, 8), np.uint8)
    gray_u8[:4] = 255
    rgb = np.stack([gray_u8] * 3, -1)
    for img in (rgb, gray_u8, gray_u8.astype(np.float32) / 255.0,
                (rgb * 0.3).astype(np.float32)):
        for fn in ("_gray", "_mask01"):
            np.testing.assert_array_equal(getattr(tgu, fn)(img),
                                          getattr(jgu, fn)(img))
        np.testing.assert_array_equal(tgu._img_or_none(img),
                                      jgu._img_or_none(img))
    assert tgu._img_or_none(None) is None and jgu._img_or_none(None) is None
    m = tgu._mask01(rgb)
    assert m.max() <= 1.0 and m[0, 0] == 1.0 and m[7, 0] == 0.0


@pytest.mark.parametrize("args", [
    ("Canny", 50, 150), ("HED", 50, 150), ("None", 50, 150),
    ("Openpose", 50, 150), ("Openpose", 50, 150, True, True, False),
    ("Openpose", 50, 150, False, False, True), ("Canny", 1, 255, False)])
def test_pre_opts_equal_jax(args):
    assert tgu._pre_opts(*args) == jgu._pre_opts(*args)


class _Component:
    """A stub gradio component or layout block: keeps its keyword
    arguments, and is a context manager."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Button(_Component):
    clicks = []

    def click(self, fn, inputs=None, outputs=None):
        _Button.clicks.append((fn, inputs, outputs))


class _Blocks(_Component):
    def queue(self):
        return self

    def launch(self, **kwargs):
        return kwargs


def _stub_gradio():
    gr = types.ModuleType("gradio")
    for name in ("Markdown", "Row", "Column", "Accordion", "Textbox",
                 "Dropdown", "Slider", "Checkbox", "Number", "Image",
                 "Gallery"):
        setattr(gr, name, type(name, (_Component,), {}))
    gr.Button, gr.Blocks = _Button, _Blocks
    return gr


def test_build_ui_needs_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    m = tapi.ModelManager(dtype=torch.float32, device="cpu")
    with pytest.raises(ImportError):
        tgu.build_ui(m)


def test_generate_callback_runs_inference_with_a_canny_unit(monkeypatch):
    """The Generate button's callback with the components' defaults, a
    64^2 two-step request on the tiny model and the first ControlNet unit
    on, its preprocessor "Canny": the gallery holds the image that
    ``inference()`` returns for the same request."""
    monkeypatch.setitem(sys.modules, "gradio", _stub_gradio())
    monkeypatch.setattr(_Button, "clicks", [])
    m = tapi.ModelManager(dtype=torch.float32, device="cpu")
    m.register_random("tiny", tiny_config(), seed=0)
    demo = tgu.build_ui(m)
    assert isinstance(demo, _Blocks)
    assert demo.queue().launch(server_port=1) == {"server_port": 1}
    (fn, inputs, outputs), = _Button.clicks
    assert len(outputs) == 3
    photo = (np.random.RandomState(0).rand(64, 64, 3) * 255).astype(np.uint8)
    values = [c.kwargs.get("value") for c in inputs]
    labels = [c.kwargs.get("label") for c in inputs]

    def put(label, value, nth=0):
        idx = [i for i, lab in enumerate(labels) if lab == label][nth]
        values[idx] = value

    values[0] = "a red cat"
    put("Model", "tiny")
    put("Steps", 2)
    put("Width", 64)
    put("Height", 64)
    put("Prompt encoding", "Short Prompt Encoding")
    put("Enable", True)
    put("Conditioning image", photo)
    put("Preprocessor", "Canny")
    images, previews, timings = fn(*values)
    assert len(images) == 1 and images[0].shape == (64, 64, 3)
    assert previews == [] and "total_s" in timings
    want = tapi.inference(
        m, prompt="a red cat", model="tiny", steps=2, width=64, height=64,
        encoding_mode="short", controlnet_units=[tapi.ControlNetUnit(
            "Canny", photo, preprocessor="Canny",
            preprocessor_options={"low": 100.0, "high": 200.0})])
    np.testing.assert_array_equal(images[0], want["images"][0])
