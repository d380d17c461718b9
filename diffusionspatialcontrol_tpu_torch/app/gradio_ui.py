"""The Gradio front-end (port of ``app/gradio_ui.py``; ``gradio`` is an
optional dependency, imported by ``build_ui`` only).

A Blocks UI over ``app.api.inference`` with the reference app's
interactions (source/app.py:2171-3063): prompt and negative prompt, model
and sampler, steps, CFG, size, seed, clip-skip, prompt encoding, batch,
guidance rescale, the region-map editor (a comma-separated phrase list, a
mask per phrase or one clustered colour map, the strengths S and S'),
img2img with an inpaint mask, hires fix, the ControlNet / T2I-Adapter /
IP-Adapter unit editors with each unit's preprocessor and its options
(Canny thresholds, the Openpose body / hand / face boxes), LoRA and
textual-inversion files, latent previews, and the output gallery with the
timings.

This module imports without ``gradio`` (the JSON server is the serving
path where it is missing); ``launch`` needs it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .. import registry
from ..ops import preprocess as pp
from ..ops.resize import UPSCALE_MODES
from ..utils import region_ui
from .api import ControlNetUnit, IPAdapterUnit, ModelManager, T2IAdapterUnit
from .api import inference

N_CONTROLNET_UNITS = 2  # reference UI ships a multi-unit editor

_PREPROCESSORS = ("None",) + tuple(
    sorted((set(pp.NATIVE_PREPROCESSORS)
            | set(pp.MODEL_BASED_PREPROCESSORS)) - {"None"})
)


def _to_float_list(text: str) -> List[float]:
    return [float(w) for w in (text or "").split(",") if w.strip()]


def _img_or_none(img):
    return np.asarray(img) if img is not None else None


def _gray(img) -> np.ndarray:
    a = np.asarray(img, np.float32)
    return a.mean(-1) if a.ndim == 3 else a


def _pre_opts(pre, low, high, body=True, hand=False, face=False):
    """preprocessor_options for a unit: Canny low/high thresholds (the
    reference UI's per-unit threshold sliders, app.py:857-858/882-883 ->
    cv2.Canny at app.py:662/709) and the Openpose body/hand/face
    checkboxes (app.py:860-861 -> include_* at app.py:666/715). Other
    preprocessors get no options."""
    if pre == "Canny":
        return {"low": float(low), "high": float(high)}
    if pre == "Openpose" and (hand or face or not body):
        return {"include_body": bool(body), "include_hand": bool(hand),
                "include_face": bool(face)}
    return None


def _mask01(img) -> np.ndarray:
    """Grayscale mask -> [0, 1] float (gradio may hand back either a
    0..255 uint8 array or an already-normalized float one)."""
    m = _gray(img)
    return m / 255.0 if m.max() > 1.5 else m


def build_ui(manager: ModelManager):
    import gradio as gr

    model_names = sorted(manager._dirs)
    sampler_names = sorted(registry.SAMPLERS)

    def parse_phrases(text: str) -> List[str]:
        return [p.strip() for p in (text or "").split(",") if p.strip()]

    def parse_loras(text: str):
        """"path" or "path:scale", comma separated (reference LoRA upload +
        per-file scale, app.py:532-597)."""
        out = []
        for item in (text or "").split(","):
            item = item.strip()
            if not item:
                continue
            if ":" in item and not item.endswith(":"):
                path, scale = item.rsplit(":", 1)
                try:
                    out.append((path.strip(), float(scale)))
                    continue
                except ValueError:
                    pass
            out.append(item)
        return out

    def build_region_state(phrases_text, mask_files, weights_text,
                           outsides_text, color_map) -> Optional[Dict]:
        phrases = parse_phrases(phrases_text)
        masks: List[np.ndarray] = []
        if phrases and color_map is not None:
            masks = region_ui.extract_color_masks(
                np.asarray(color_map), max_colors=len(phrases)
            )
        elif phrases and mask_files:
            for f in mask_files[: len(phrases)]:
                img = np.asarray(f)
                if img.ndim == 3:
                    img = img.mean(-1)
                masks.append(region_ui.mask_from_grayscale_map(img))
        if not (phrases and masks):
            return None
        return region_ui.build_region_state(
            phrases[: len(masks)], masks,
            _to_float_list(weights_text) or None,
            _to_float_list(outsides_text) or None,
        )

    def generate(
        prompt, neg_prompt, model, sampler, steps, cfg_scale, width,
        height, seed, batch, clip_skip, encoding_mode, guidance_rescale,
        latent_preview,
        phrases_text, mask_files, weights_text, outsides_text, color_map,
        init_image, strength, inpaint_mask, invert_mask,
        hires_scale, hires_strength, hires_mode, hires_steps,
        hires_sampler, hires_region,
        *unit_inputs,
    ):
        region_state = build_region_state(
            phrases_text, mask_files, weights_text, outsides_text, color_map
        )

        it = iter(unit_inputs)
        controlnet_units = []
        for _ in range(N_CONTROLNET_UNITS):
            (cn_on, cn_model, cn_image, cn_pre, cn_low, cn_high, cn_body,
             cn_hand, cn_face, cn_scale, cn_start, cn_end,
             cn_guess) = (next(it) for _ in range(13))
            if cn_on and cn_image is not None:
                controlnet_units.append(ControlNetUnit(
                    model=cn_model, image=np.asarray(cn_image),
                    scale=float(cn_scale),
                    guidance_start=float(cn_start),
                    guidance_end=float(cn_end), guess_mode=bool(cn_guess),
                    preprocessor=None if cn_pre == "None" else cn_pre,
                    preprocessor_options=_pre_opts(cn_pre, cn_low, cn_high,
                                                   cn_body, cn_hand,
                                                   cn_face),
                ))
        (t2i_on, t2i_model, t2i_image, t2i_pre, t2i_low, t2i_high,
         t2i_body, t2i_hand, t2i_face, t2i_scale,
         t2i_factor) = (next(it) for _ in range(11))
        t2i_units = []
        if t2i_on and t2i_image is not None:
            t2i_units.append(T2IAdapterUnit(
                model=t2i_model, image=np.asarray(t2i_image),
                scale=float(t2i_scale),
                preprocessor=None if t2i_pre == "None" else t2i_pre,
                preprocessor_options=_pre_opts(t2i_pre, t2i_low, t2i_high,
                                               t2i_body, t2i_hand,
                                               t2i_face),
                conditioning_factor=float(t2i_factor),
            ))
        (ip_on, ip_model, ip_image, ip_scale,
         ip_mask, ip_invert) = (next(it) for _ in range(6))
        ip_units = []
        if ip_on and ip_image is not None:
            mask = None
            if ip_mask is not None:
                mask = _mask01(ip_mask)
            ip_units.append(IPAdapterUnit(
                model=ip_model, image=np.asarray(ip_image),
                scale=float(ip_scale), mask=mask,
                invert_mask=bool(ip_invert),
            ))
        loras_text, ti_text = next(it), next(it)

        result = inference(
            manager,
            prompt=prompt,
            model=model,
            neg_prompt=neg_prompt,
            sampler=sampler,
            steps=int(steps),
            cfg_scale=float(cfg_scale),
            width=int(width),
            height=int(height),
            seed=int(seed),
            num_images_per_prompt=int(batch),
            clip_skip=int(clip_skip),
            encoding_mode=registry.ENCODING_MODES.get(
                encoding_mode, "a1111"
            ),
            guidance_rescale=float(guidance_rescale),
            region_state=region_state,
            init_image=_img_or_none(init_image),
            strength=float(strength),
            inpaint_mask=(
                # white = regenerate (the UI label's and the HTTP
                # server's convention; mask_from_grayscale_map is the
                # REGION-map convention, drawn = <255, i.e. inverted)
                None if inpaint_mask is None else
                (_gray(inpaint_mask) > 127.5).astype(np.float32)
            ),
            invert_mask=bool(invert_mask),
            hires_scale=float(hires_scale or 0.0),
            hires_strength=float(hires_strength),
            hires_mode=hires_mode,
            hires_steps=int(hires_steps) if hires_steps else None,
            hires_sampler=(None if hires_sampler in (None, "Same as base")
                           else hires_sampler),
            hires_region=bool(hires_region),
            controlnet_units=controlnet_units,
            t2i_units=t2i_units,
            ip_adapter_units=ip_units,
            loras=parse_loras(loras_text),
            ti_embeddings=parse_phrases(ti_text),
            latent_preview=bool(latent_preview),
        )
        previews = [p for p in result.get("previews", [])]
        return ([img for img in result["images"]], previews,
                result["timings"])

    def _controlnet_unit(gr, i: int):
        with gr.Accordion(f"ControlNet unit {i + 1}", open=False):
            on = gr.Checkbox(label="Enable", value=False)
            model = gr.Dropdown(
                sorted(registry.CONTROLNET_MODELS), label="Model",
                value="Canny",
            )
            image = gr.Image(label="Conditioning image")
            pre = gr.Dropdown(_PREPROCESSORS, value="None",
                              label="Preprocessor")
            scale = gr.Slider(0.0, 2.0, value=1.0, label="Scale")
            with gr.Row():
                low = gr.Slider(1, 255, value=100,
                                label="Canny low threshold")
                high = gr.Slider(1, 255, value=200,
                                 label="Canny high threshold")
            with gr.Row():
                body = gr.Checkbox(label="Openpose body", value=True)
                hand = gr.Checkbox(label="Openpose hand", value=False)
                face = gr.Checkbox(label="Openpose face", value=False)
            with gr.Row():
                start = gr.Slider(0.0, 1.0, value=0.0,
                                  label="Guidance start")
                end = gr.Slider(0.0, 1.0, value=1.0, label="Guidance end")
            guess = gr.Checkbox(label="Guess mode", value=False)
        return [on, model, image, pre, low, high, body, hand, face, scale,
                start, end, guess]

    with gr.Blocks(title="DiffusionSpatialControl-TPU") as demo:
        gr.Markdown("## DiffusionSpatialControl-TPU")
        with gr.Row():
            with gr.Column():
                prompt = gr.Textbox(label="Prompt", lines=2)
                neg_prompt = gr.Textbox(
                    label="Negative prompt",
                    value="bad quality, low quality, jpeg artifact, cropped",
                )
                model = gr.Dropdown(
                    model_names, label="Model",
                    value=model_names[0] if model_names else None,
                )
                sampler = gr.Dropdown(
                    sampler_names, label="Sampler",
                    value=registry.DEFAULT_SAMPLER,
                )
                with gr.Row():
                    steps = gr.Slider(1, 100, value=25, step=1,
                                      label="Steps")
                    cfg_scale = gr.Slider(1.0, 20.0, value=7.5,
                                          label="CFG scale")
                    guidance_rescale = gr.Slider(
                        0.0, 1.0, value=0.0, label="Guidance rescale")
                with gr.Row():
                    width = gr.Slider(256, 1920, value=512, step=64,
                                      label="Width")
                    height = gr.Slider(256, 1920, value=512, step=64,
                                       label="Height")
                with gr.Row():
                    seed = gr.Number(value=0, label="Seed", precision=0)
                    batch = gr.Slider(1, 8, value=1, step=1,
                                      label="Images per prompt")
                    clip_skip = gr.Slider(1, 4, value=2, step=1,
                                          label="Clip skip")
                    encoding_mode = gr.Dropdown(
                        list(registry.ENCODING_MODES),
                        value="Automatic111 Encoding",
                        label="Prompt encoding",
                    )
                latent_preview = gr.Checkbox(
                    label="Latent preview (per-step gallery)", value=False)
                with gr.Accordion("Region control", open=False):
                    phrases_text = gr.Textbox(
                        label="Controlled phrases (comma separated)"
                    )
                    mask_files = gr.Gallery(label="Per-phrase masks "
                                            "(grayscale: drawn = region)")
                    color_map = gr.Image(
                        label="...or one color region map (clustered)"
                    )
                    weights_text = gr.Textbox(
                        label="Strengths S (comma separated)", value=""
                    )
                    outsides_text = gr.Textbox(
                        label="Anti-strengths S' (comma separated)", value=""
                    )
                with gr.Accordion("img2img / inpaint", open=False):
                    init_image = gr.Image(label="Init image")
                    strength = gr.Slider(0.0, 1.0, value=0.8,
                                         label="Denoising strength")
                    inpaint_mask = gr.Image(
                        label="Inpaint mask (white = regenerate)")
                    invert_mask = gr.Checkbox(
                        label="Black areas are used", value=False)
                with gr.Accordion("Hires fix", open=False):
                    hires_scale = gr.Slider(0.0, 4.0, value=0.0,
                                            label="Upscale (0 = off)")
                    hires_strength = gr.Slider(0.0, 1.0, value=0.6,
                                               label="Hires strength")
                    hires_mode = gr.Dropdown(
                        list(UPSCALE_MODES), label="Upscale mode",
                        value=UPSCALE_MODES[0],
                    )
                    hires_steps = gr.Number(
                        value=0, precision=0,
                        label="Hires steps (0 = same as base)")
                    hires_sampler = gr.Dropdown(
                        ["Same as base"] + sorted(registry.SAMPLERS),
                        value="Same as base", label="Hires sampler")
                    hires_region = gr.Checkbox(
                        label="Enable region condition upscaler",
                        value=False)
                unit_inputs: List = []
                for i in range(N_CONTROLNET_UNITS):
                    unit_inputs += _controlnet_unit(gr, i)
                with gr.Accordion("T2I-Adapter", open=False):
                    t2i_on = gr.Checkbox(label="Enable", value=False)
                    t2i_model = gr.Dropdown(
                        sorted(registry.T2I_ADAPTER_MODELS), label="Model",
                        value="Canny",
                    )
                    t2i_image = gr.Image(label="Conditioning image")
                    t2i_pre = gr.Dropdown(_PREPROCESSORS, value="None",
                                          label="Preprocessor")
                    with gr.Row():
                        t2i_low = gr.Slider(1, 255, value=100,
                                            label="Canny low threshold")
                        t2i_high = gr.Slider(1, 255, value=200,
                                             label="Canny high threshold")
                    with gr.Row():
                        t2i_body = gr.Checkbox(label="Openpose body",
                                               value=True)
                        t2i_hand = gr.Checkbox(label="Openpose hand",
                                               value=False)
                        t2i_face = gr.Checkbox(label="Openpose face",
                                               value=False)
                    t2i_scale = gr.Slider(0.0, 2.0, value=1.0,
                                          label="Scale")
                    t2i_factor = gr.Slider(
                        0.0, 1.0, value=1.0, label="Conditioning factor")
                unit_inputs += [t2i_on, t2i_model, t2i_image, t2i_pre,
                                t2i_low, t2i_high, t2i_body, t2i_hand,
                                t2i_face, t2i_scale, t2i_factor]
                with gr.Accordion("IP-Adapter", open=False):
                    ip_on = gr.Checkbox(label="Enable", value=False)
                    ip_model = gr.Dropdown(
                        sorted(registry.IP_ADAPTER_MODELS),
                        label="Variant", value="IP-Adapter",
                    )
                    ip_image = gr.Image(label="Reference image")
                    ip_scale = gr.Slider(0.0, 2.0, value=1.0, label="Scale")
                    ip_mask = gr.Image(label="Spatial mask (optional)")
                    # default True matches the reference's IP-adapter mask
                    # checkbox (source/app.py:2370); the inpaint checkbox
                    # above defaults False like the reference's (:2281).
                    ip_invert = gr.Checkbox(
                        label="Black areas are used", value=True)
                unit_inputs += [ip_on, ip_model, ip_image, ip_scale,
                                ip_mask, ip_invert]
                with gr.Accordion("LoRA / Textual inversion", open=False):
                    loras_text = gr.Textbox(
                        label="LoRA files (path or path:scale, comma "
                              "separated)")
                    ti_text = gr.Textbox(
                        label="Textual-inversion embedding files (comma "
                              "separated)")
                unit_inputs += [loras_text, ti_text]
                btn = gr.Button("Generate", variant="primary")
            with gr.Column():
                gallery = gr.Gallery(label="Output")
                preview_gallery = gr.Gallery(label="Latent previews")
                timings = gr.Textbox(label="Timings", interactive=False)

        btn.click(
            generate,
            inputs=[prompt, neg_prompt, model, sampler, steps, cfg_scale,
                    width, height, seed, batch, clip_skip, encoding_mode,
                    guidance_rescale, latent_preview,
                    phrases_text, mask_files, weights_text, outsides_text,
                    color_map, init_image, strength, inpaint_mask,
                    invert_mask, hires_scale, hires_strength, hires_mode,
                    hires_steps, hires_sampler, hires_region]
                   + unit_inputs,
            outputs=[gallery, preview_gallery, timings],
        )
    return demo


def launch(manager: ModelManager, **launch_kwargs):
    demo = build_ui(manager)
    demo.queue()  # serialize generations like the reference (app.py:3063)
    return demo.launch(**launch_kwargs)
