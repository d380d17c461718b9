"""JSON HTTP serving layer (port of ``app/server.py``).

A stdlib HTTP server exposing ``app.api.inference`` as JSON endpoints:

  POST /generate   — inference() parameters as JSON. Image-valued fields
                     (init_image, inpaint_mask, region masks, unit images)
                     take nested number lists or base64 PNG/JPEG strings
                     (decoded with PIL, imported only for such strings).
                     Output images are base64 PNG (the native codec).
  POST /jobs             — same payload, asynchronous: returns a job_id
  GET  /jobs             — queue listing (id, status, progress)
  GET  /jobs/<id>        — status and progress; the full result when done
  POST /jobs/<id>/cancel — drop a queued job, or stop a running one at the
                           next chunk boundary (pass cancel_check_steps in
                           the payload for live progress and cancellation)
  POST /warmup     — run shape buckets once ({"configs": [...]} or
                     {"model": name} for the default 512²/768² x batch 1/4
                     x with and without a map); returns per-bucket seconds
  GET  /models     — registered checkpoints
  GET  /samplers   — sampler names of the app's table
  GET  /preprocessors — the control preprocessors' names
  POST /preprocess — {"image", "preprocessor", "options"}: one detector
                     run on its own; returns the control image as base64
                     PNG
  GET  /health

Every field of the JAX server's ``/generate`` runs here, the speed modes
(``cfg_tail_frac``, ``deepcache_interval``, ``bottleneck_low_scale``,
``tgate_gate_frac``) and the units' ``preprocessor`` included. One worker
thread owns the device: ``/generate``, ``/warmup``, ``/preprocess`` and
the job queue share one lock, so requests run one at a time in arrival
order. A request that fails answers an error (400 for a caller's mistake,
501 for a path not ported yet, 500 otherwise); none is answered 200
without its images.

CLI: ``python -m diffusionspatialcontrol_tpu_torch.app.server
--model NAME=DIR | --zoo ROOT | --random-model NAME[:FAMILY[:SEED]]
[--preprocessor NAME=WEIGHTS] [--device cuda|cpu] [--gradio]``.

Under ``torchrun --nproc-per-node N -m
diffusionspatialcontrol_tpu_torch.app.server ...`` the ranks form a
data-parallel mesh (``parallel.mesh.init_data_parallel``; NCCL with a card a
rank, ``--backend gloo`` for ranks that share a card). Rank 0 binds the port
and serves; a grid request whose samples split equally over the ranks runs
on all of them (``api.inference``), every other request on rank 0 alone.
The other ranks follow rank 0's grid requests (``api.follow_requests``)
until rank 0's server stops, which sends them a stop. Without ``torchrun``
the server is one process, as above.
"""

from __future__ import annotations

import base64
import io
import itertools
import json
import os
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .. import registry
from .api import (
    ModelManager,
    default_warmup_configs,
    follow_requests,
    inference,
    stop_followers,
    warmup,
)

class GenerationCancelled(RuntimeError):
    """Raised out of a progress callback to abort a running generation."""


def _encode_images(images: np.ndarray):
    """base64 PNG per image (the native codec)."""
    from ..runtime import native

    return [
        base64.b64encode(native.encode_png(img)).decode() for img in images
    ]


def _decode_b64_image(s: str) -> np.ndarray:
    """base64 PNG/JPEG string -> float32 HWC (or HW) array in 0..255."""
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(s)))
    if img.mode not in ("RGB", "L"):
        img = img.convert("RGB")
    return np.asarray(img, np.float32)


def _image_field(v):
    """JSON image field: nested lists, a base64 image string, or null."""
    if v is None:
        return None
    if isinstance(v, str):
        return _decode_b64_image(v)
    return np.asarray(v, np.float32)


def _inference_kwargs(req: dict) -> dict:
    """JSON /generate payload -> inference() kwargs (shared with /jobs)."""

    def _parse_state(state):
        if not state:
            return None

        def _mask(v):
            if isinstance(v, str):  # b64 grayscale map: drawn = value<255
                from ..utils.region_ui import mask_from_grayscale_map

                m = _decode_b64_image(v)
                if m.ndim == 3:
                    m = m.mean(-1)
                return mask_from_grayscale_map(m)
            return np.asarray(v, np.float32)  # nested lists: already 0/1

        return {
            phrase: {
                "mask": _mask(spec["mask"]),
                "weight": float(spec.get("weight", 1.0)),
                "mask_outsides": float(spec.get("mask_outsides", 0.0)),
            }
            for phrase, spec in state.items()
        }

    raw_state = req.get("region_state")
    if isinstance(raw_state, list):
        # multi-prompt batch: one region dict (or null) per prompt
        region_state = [_parse_state(s) for s in raw_state]
    else:
        region_state = _parse_state(raw_state)
    kwargs = {
        k: req[k]
        for k in (
            "neg_prompt", "sampler", "steps", "cfg_scale", "width",
            "height", "seed", "num_images_per_prompt", "clip_skip",
            "encoding_mode", "guidance_rescale", "strength",
            "hires_scale", "hires_strength", "hires_mode",
            "hires_steps", "hires_sampler", "hires_region", "invert_mask",
            "eta", "cancel_check_steps", "timeout",
            "latent_preview", "cfg_tail_frac", "deepcache_interval",
            "bottleneck_low_scale",
            "tgate_gate_frac",
        )
        if k in req
    }
    kwargs["prompt"] = req["prompt"]
    kwargs["model"] = req["model"]
    kwargs["region_state"] = region_state

    def _img(v):
        # unit images and masks use the [0, 1] convention; base64 uploads
        # decode to 0..255 and are rescaled here
        if isinstance(v, str):
            return _decode_b64_image(v) / 255.0
        return None if v is None else np.asarray(v, np.float32)

    if req.get("init_image") is not None:
        # the HTTP convention for init_image is 0..255 (base64 or JSON
        # lists), always cast to uint8 so that inference's _to_pm1 maps it
        # to [-1, 1] (an all-black 0..255 upload is not taken for [-1, 1])
        def _init_img(v):
            arr = _image_field(v)
            return np.clip(np.round(arr), 0, 255).astype(np.uint8)

        ii = req["init_image"]
        # per-prompt list (grid img2img): a list of base64 strings, or a
        # list of (H, W, 3) nested arrays (vs one image, itself a nested
        # list of rows)
        is_multi = isinstance(ii, list) and len(ii) > 0 and (
            isinstance(ii[0], str)
            or (isinstance(ii[0], (list, tuple))
                and np.asarray(ii[0], dtype=np.float32).ndim == 3)
        )
        kwargs["init_image"] = (
            [_init_img(v) for v in ii] if is_multi else _init_img(ii)
        )
    if req.get("inpaint_mask") is not None:
        m = _image_field(req["inpaint_mask"])
        if m.ndim == 3:
            m = m.mean(-1)
        if m.max() > 1.5:  # 0..255 grayscale upload -> 0/1 mask
            m = (m > 127.5).astype(np.float32)
        kwargs["inpaint_mask"] = m

    if req.get("loras"):
        kwargs["loras"] = [
            (u, 1.0) if isinstance(u, str) else (u[0], float(u[1]))
            for u in req["loras"]
        ]
    if req.get("ti_embeddings"):
        kwargs["ti_embeddings"] = list(req["ti_embeddings"])
    if req.get("controlnet_units"):
        from .api import ControlNetUnit

        kwargs["controlnet_units"] = [
            ControlNetUnit(
                model=u["model"], image=_img(u["image"]),
                scale=float(u.get("scale", 1.0)),
                guidance_start=float(u.get("guidance_start", 0.0)),
                guidance_end=float(u.get("guidance_end", 1.0)),
                guess_mode=bool(u.get("guess_mode", False)),
                preprocessor=u.get("preprocessor"),
                preprocessor_options=u.get("preprocessor_options"),
            )
            for u in req["controlnet_units"]
        ]
    if req.get("t2i_units"):
        from .api import T2IAdapterUnit

        kwargs["t2i_units"] = [
            T2IAdapterUnit(
                model=u["model"], image=_img(u["image"]),
                scale=float(u.get("scale", 1.0)),
                preprocessor=u.get("preprocessor"),
                preprocessor_options=u.get("preprocessor_options"),
                conditioning_factor=float(
                    u.get("conditioning_factor", 1.0)
                ),
            )
            for u in req["t2i_units"]
        ]
    if req.get("ip_adapter_units"):
        from .api import IPAdapterUnit

        kwargs["ip_adapter_units"] = [
            IPAdapterUnit(
                model=u["model"], image=_img(u.get("image")),
                image_embeds=_img(u.get("image_embeds")),
                scale=float(u.get("scale", 1.0)),
                mask=_img(u.get("mask")),
                invert_mask=bool(u.get("invert_mask", False)),
            )
            for u in req["ip_adapter_units"]
        ]
    return kwargs


def _result_payload(result: dict) -> dict:
    payload = {
        "images": _encode_images(result["images"]),
        "timings": result["timings"],
    }
    if result.get("previews") is not None:
        # per-step galleries; spans base + hires passes
        payload["previews"] = [
            _encode_images(p) for p in result["previews"]
        ]
    return payload


def _error_code(e: Exception) -> int:
    """400 for a caller's mistake (bad parameter combinations, unknown
    model or sampler names), 501 for a path not ported yet, else 500."""
    if isinstance(e, (ValueError, KeyError, TypeError)):
        return 400
    if isinstance(e, NotImplementedError):
        return 501
    return 500


class _Job:
    __slots__ = ("id", "req", "status", "progress", "result", "error",
                 "cancel", "created")

    def __init__(self, job_id: str, req: dict):
        self.id = job_id
        self.req = req
        self.status = "queued"  # queued|running|done|error|cancelled
        self.progress = (0, 0)
        self.result: Optional[dict] = None
        self.error: Optional[str] = None
        self.cancel = threading.Event()
        self.created = time.time()

    def brief(self) -> dict:
        return {
            "job_id": self.id,
            "status": self.status,
            "progress": {"done": self.progress[0],
                         "total": self.progress[1]},
        }


class _JobQueue:
    """FIFO job queue with one worker thread owning the device: clients
    poll status and progress and can cancel. Only the last ``keep``
    finished jobs are kept."""

    def __init__(self, manager: ModelManager, lock: threading.Lock,
                 keep: int = 64):
        self.manager = manager
        self.lock = lock  # shared with /generate: one device owner at a time
        self.keep = keep
        self.jobs: "OrderedDict[str, _Job]" = OrderedDict()
        self._ids = itertools.count(1)
        self._cond = threading.Condition()
        self._pending = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, req: dict) -> _Job:
        job = _Job(f"job-{next(self._ids)}", req)
        with self._cond:
            self.jobs[job.id] = job
            self._trim()
            self._pending.append(job)
            self._cond.notify()
        return job

    def get(self, job_id: str) -> Optional[_Job]:
        return self.jobs.get(job_id)

    def snapshot(self) -> list:
        # under the condition lock: submit()/_trim() mutate the OrderedDict
        # from other handler threads
        with self._cond:
            return list(self.jobs.values())

    def _trim(self):
        done = [j for j in self.jobs.values()
                if j.status in ("done", "error", "cancelled")]
        for j in done[: max(0, len(done) - self.keep)]:
            self.jobs.pop(j.id, None)

    def _run(self):
        while True:
            with self._cond:
                while not self._pending:
                    self._cond.wait()
                job = self._pending.pop(0)
            if job.cancel.is_set():
                job.status = "cancelled"
                continue
            job.status = "running"
            steps = int(job.req.get("steps", 25))
            job.progress = (0, steps)

            def _cb(done, total, job=job):
                job.progress = (done, total)
                if job.cancel.is_set():
                    raise GenerationCancelled(job.id)

            try:
                kwargs = _inference_kwargs(job.req)
                with self.lock:
                    result = inference(self.manager, progress_cb=_cb,
                                       **kwargs)
                job.result = _result_payload(result)
                job.progress = (job.progress[1], job.progress[1])
                job.status = "done"
            except GenerationCancelled:
                job.status = "cancelled"
            except Exception as e:  # noqa: BLE001 - surface to the client
                job.error = f"{type(e).__name__}: {e}"
                job.status = "error"


class _Handler(BaseHTTPRequestHandler):
    manager: ModelManager = None  # set by serve()
    lock = threading.Lock()  # serialize generations
    job_queue: Optional[_JobQueue] = None  # set by serve()

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, e: Exception):
        self._json(_error_code(e), {"error": f"{type(e).__name__}: {e}"})

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length", "0"))
        return json.loads(self.rfile.read(length) or b"{}")

    def log_message(self, fmt, *args):  # quiet
        pass

    def do_GET(self):
        if self.path == "/health":
            self._json(200, {"ok": True})
        elif self.path == "/jobs":
            self._json(200, {
                "jobs": [j.brief() for j in self.job_queue.snapshot()],
            })
        elif self.path.startswith("/jobs/"):
            job = self.job_queue.get(self.path[len("/jobs/"):])
            if job is None:
                self._json(404, {"error": "no such job"})
                return
            payload = job.brief()
            if job.status == "done":
                payload.update(job.result)
            elif job.status == "error":
                payload["error"] = job.error
            self._json(200, payload)
        elif self.path == "/models":
            self._json(200, {"models": sorted(self.manager._dirs)})
        elif self.path == "/samplers":
            self._json(200, {"samplers": sorted(registry.SAMPLERS)})
        elif self.path == "/preprocessors":
            from ..ops import preprocess as pp

            self._json(200, {
                "pure_image": sorted(pp.NATIVE_PREPROCESSORS),
                "model_based_native": list(pp.NATIVE_MODEL_PREPROCESSORS),
                "model_based_unavailable": [
                    n for n in pp.MODEL_BASED_PREPROCESSORS
                    if n not in pp.NATIVE_MODEL_PREPROCESSORS
                ],
            })
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        if self.path == "/preprocess":
            # one detector on its own, so that a client can inspect or
            # edit a control image
            try:
                req = self._read_json()
                img = _image_field(req["image"])
                # the detectors' contract: uint8 0..255 RGB (a base64 upload
                # decodes to 0..255 floats, maybe 2-D; a nested list may be
                # in [0, 1])
                if img.ndim == 2:
                    img = np.stack([img] * 3, axis=-1)
                if img.max() <= 1.0:
                    img = img * 255.0
                img = np.clip(np.round(img), 0, 255).astype(np.uint8)
                fn = self.manager.get_preprocessor(req["preprocessor"])
                opts = req.get("options") or {}
                with self.lock:
                    out = fn(img, **opts) if opts else fn(img)
                self._json(200, {"image": _encode_images(
                    np.round(np.asarray(out) * 255).astype(np.uint8)[None]
                )[0]})
            except (ValueError, KeyError, TypeError) as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if self.path == "/jobs":
            try:
                req = self._read_json()
                _inference_kwargs(req)  # validate shape before queueing
                job = self.job_queue.submit(req)
                self._json(202, job.brief())
            except Exception as e:  # noqa: BLE001
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
            return
        if self.path == "/warmup":
            # run shape buckets once (see api.warmup). Payload:
            # {"configs": [<generate payloads>]} or {"model": "name"} for
            # the default buckets. Synchronous; call once at deploy time.
            try:
                req = self._read_json()
                if "configs" in req:
                    # prompt and seed change no shape; warm-up payloads
                    # may omit them
                    configs = [
                        _inference_kwargs({"prompt": "warmup", **c})
                        for c in req["configs"]
                    ]
                else:
                    configs = default_warmup_configs(req["model"])
                with self.lock:
                    results = warmup(self.manager, configs)
                self._json(200, {"results": results})
            except Exception as e:  # noqa: BLE001 - report to client
                self._error(e)
            return
        if self.path.startswith("/jobs/") and self.path.endswith("/cancel"):
            job = self.job_queue.get(
                self.path[len("/jobs/"):-len("/cancel")])
            if job is None:
                self._json(404, {"error": "no such job"})
                return
            job.cancel.set()
            if job.status == "queued":
                job.status = "cancelled"
            self._json(200, job.brief())
            return
        if self.path != "/generate":
            self._json(404, {"error": "not found"})
            return
        try:
            kwargs = _inference_kwargs(self._read_json())
            with self.lock:
                result = inference(self.manager, **kwargs)
            self._json(200, _result_payload(result))
        except Exception as e:  # noqa: BLE001 - report to client
            self._error(e)


def serve(manager: ModelManager, host: str = "127.0.0.1", port: int = 7860,
          block: bool = True) -> Optional[ThreadingHTTPServer]:
    """Serve ``manager``'s models. With ``block=False`` the server runs in a
    daemon thread and is returned (``port=0`` picks a free port:
    ``server.server_address[1]``); stop it with ``server.shutdown()``."""
    lock = threading.Lock()
    handler = type("Handler", (_Handler,), {
        "manager": manager,
        "lock": lock,
        "job_queue": _JobQueue(manager, lock),
    })
    server = ThreadingHTTPServer((host, port), handler)
    if block:
        server.serve_forever()
        return None
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def launch_gradio(manager: ModelManager, **kwargs):
    """The Gradio front-end (app/gradio_ui.py), when ``gradio`` is
    installed."""
    try:
        import gradio  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "gradio is not installed; use app.server.serve (JSON HTTP) "
            "instead"
        ) from e
    from .gradio_ui import launch

    return launch(manager, **kwargs)


def build_manager_from_args(args, mesh=None) -> ModelManager:
    """argparse namespace -> configured ModelManager (split from main() so
    tests can drive the CLI wiring without binding a port); ``mesh``: the
    rank's data-parallel mesh under ``torchrun``."""
    import torch

    from ..config import MODEL_FAMILIES

    manager = ModelManager(
        dtype=torch.float32 if args.dtype == "f32" else torch.bfloat16,
        device=args.device if mesh is None else mesh.device, mesh=mesh,
    )
    for spec in args.model:
        if "=" not in spec:
            raise SystemExit(f"--model expects NAME=DIR, got {spec!r}")
        name, path = spec.split("=", 1)
        manager.register(name, path)
    if args.zoo:
        names = manager.register_zoo(args.zoo)
        if not names:
            raise SystemExit(f"--zoo {args.zoo}: no zoo checkpoints found")
    for spec in args.random_model:
        parts = spec.split(":")
        name = parts[0]
        family = parts[1] if len(parts) > 1 else "sd15"
        if family not in MODEL_FAMILIES:
            raise SystemExit(
                f"unknown family {family!r}; options: "
                f"{sorted(MODEL_FAMILIES)}"
            )
        seed = int(parts[2]) if len(parts) > 2 else 0
        manager.register_random(name, MODEL_FAMILIES[family](), seed=seed)
    for spec in args.preprocessor:
        if "=" not in spec:
            raise SystemExit(
                f"--preprocessor expects NAME=WEIGHTS, got {spec!r}"
            )
        name, path = spec.split("=", 1)
        manager.register_preprocessor(name, path=path)
    if args.image_encoder:
        manager.register_image_encoder(path=args.image_encoder)
    if args.face_embedder:
        manager.register_face_embedder(path=args.face_embedder)
    if not manager._dirs:
        raise SystemExit(
            "no models registered; pass --model NAME=DIR, --zoo ROOT "
            "and/or --random-model NAME[:FAMILY[:SEED]]"
        )
    return manager


def parse_args(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="diffusionspatialcontrol_tpu_torch.app.server",
        description="JSON HTTP server for the PyTorch/CUDA port of the "
        "DiffusionSpatialControl framework.",
    )
    p.add_argument("--model", action="append", default=[],
                   metavar="NAME=DIR",
                   help="register a diffusers-layout checkpoint directory "
                   "(repeatable; converted onto the device at its first "
                   "request)")
    p.add_argument("--zoo", metavar="ROOT",
                   help="register every reference-zoo checkpoint found "
                   "under ROOT (registry.MODEL_ZOO names)")
    p.add_argument("--random-model", action="append", default=[],
                   metavar="NAME[:FAMILY[:SEED]]",
                   help="register a random-init model (weightless demo/"
                   "smoke runs; families: sd15, sd15-inpaint, sd21, tiny)")
    p.add_argument("--preprocessor", action="append", default=[],
                   metavar="NAME=WEIGHTS",
                   help="register control-preprocessor weights, e.g. "
                   "'Depth=/w/dpt.safetensors' (repeatable)")
    p.add_argument("--image-encoder", metavar="WEIGHTS",
                   help="CLIP-vision weights for IP-Adapter embedding "
                   "(without them the tower has random weights)")
    p.add_argument("--face-embedder", metavar="WEIGHTS",
                   help="ArcFace recognition weights for IP-Adapter FaceID "
                   "(without them the stub embedder runs)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the models run (default cuda; it raises "
                   "without a card)")
    p.add_argument("--backend", choices=["nccl", "gloo"],
                   help="under torchrun: the process group's backend "
                   "(default nccl on cuda, which needs a card a rank; gloo "
                   "for ranks that share a card, and on cpu)")
    p.add_argument("--warmup", action="store_true",
                   help="run the default shape buckets once for every "
                   "registered model before accepting requests")
    p.add_argument("--gradio", action="store_true",
                   help="launch the Gradio Blocks UI instead of the JSON "
                   "HTTP server (requires gradio)")
    return p.parse_args(argv)


def main(argv=None):
    """CLI: ``python -m diffusionspatialcontrol_tpu_torch.app.server ...``
    (the reference's ``python app.py`` launch, source/app.py:3063)."""
    args = parse_args(argv)
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # under torchrun
        from ..parallel.mesh import init_data_parallel

        mesh = init_data_parallel(backend=args.backend, device=args.device)
    try:
        manager = build_manager_from_args(args, mesh)
        if mesh is not None and mesh.rank > 0:
            follow_requests(manager)
            return
        try:
            if args.warmup:
                for name in list(manager._dirs):
                    warmup(manager, default_warmup_configs(name))
            if args.gradio:
                launch_gradio(manager, server_name=args.host,
                              server_port=args.port)
                return
            print(f"serving on http://{args.host}:{args.port}", flush=True)
            serve(manager, host=args.host, port=args.port, block=True)
        finally:
            if mesh is not None:
                stop_followers(manager)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":  # pragma: no cover
    main()
