"""Serving — port of `sgam_neurips22_tpu/serving.py`, smallest layer first:

- `flagship_config` / `load_inference_params`: the full-size
  conditional-generation model configurations and the weights a server
  loads (a reference torch `.ckpt`, a JAX parameter pickle, or a port
  training run; a JAX orbax run raises the command that exports it);
- `build_inference_step`: one conditional-generation step on an example
  batch (warp-conditioned encode -> nearest codeword or top-k draw ->
  decode -> metric depth);
- `SceneServer`: one resident `InfiniteSceneGeneration` that serves scene
  requests, its seeds swapped per request by `reset(seeds)`;
- `run_http_server` (CLI: `python -m sgam_neurips22_tpu_torch.serve`): a
  standard-library `ThreadingHTTPServer` JSON API around a SceneServer:
  GET /healthz and /metrics, POST /warmup and /generate.
"""
from __future__ import annotations

import contextlib
import json
import os
import shlex
import threading
import time
from dataclasses import replace
from typing import Any, Dict, Optional

import numpy as np
import torch

from sgam_neurips22_tpu_torch.core.checkpoint import CKPT_FILE, checkpoint_file, orbax_run
from sgam_neurips22_tpu_torch.core.device import resolve_device
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_into, load_tree_pickle, random_state_dict
from sgam_neurips22_tpu_torch.geometry.codec import get_codec
from sgam_neurips22_tpu_torch.models.conditioning import get_x
from sgam_neurips22_tpu_torch.models.vqgan.autoencoder import DDConfig
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel, VQModelConfig


def flagship_config(dataset: str = "clevr-infinite", compute_dtype: str = "float32") -> VQModelConfig:
    """Full-size conditional-generation config for either dataset
    (reference configs/conditional_generation/{clevr-infinite,
    google_earth_vqgan}.yaml): ch 128, ch_mult (1,1,2,2,4), attention at
    tracked resolution 16, embed_dim 256; clevr-infinite's codebook of
    16384 and depth range (7, 16), google_earth's codebook of 4096 and
    depth range (0.099975586, 4.765625); activations in `compute_dtype`."""
    dd = DDConfig(
        ch=128, out_ch=4, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
        attn_resolutions=(16,), resolution=64, z_channels=256, in_channels=4,
        compute_dtype=compute_dtype,
    )
    cfg = VQModelConfig(
        ddconfig=dd, n_embed=16384, embed_dim=256,
        phase="conditional_generation", dataset="clevr-infinite", depth_range=(7.0, 16.0),
    )
    if dataset == "google_earth":
        return replace(cfg, n_embed=4096, dataset="google_earth", depth_range=(0.099975586, 4.765625))
    if dataset != "clevr-infinite":
        raise ValueError(f"unknown dataset {dataset!r}")
    return cfg


def load_inference_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a checkpoint into `model`, as the JAX package merges one:

    - a reference torch checkpoint (a Lightning `.ckpt`, or a bare
      state_dict), or the port trainer's own, given as its run directory,
      the run's `checkpoints/` or one step directory (the latest step
      first): the `state_dict` entry is used if there is one, without the
      loss's `loss.*` and `perceptual_loss.*` tensors; every other tensor
      whose name and shape the model has replaces the model's, and the rest
      of the model keeps its weights (a non-strict load);
    - a `.pkl` of the JAX package's parameter tree (the `init_vqmodel`
      layout, numpy or `jax.Array` leaves, which
      `core.state_dict.load_tree_pickle` reads as numpy without importing
      JAX): it replaces the weights wholesale, as the JAX package's does,
      through the weight bridge (`from_jax_params`), and a tree that does
      not fit the model raises.

    Checkpoints are unpickled whole, as the reference's loader does: load
    only files you trust. A JAX trainer's orbax checkpoints (its run
    directory, their `checkpoints/` or one step directory) hold JAX pytrees
    in orbax's format, which the port reads only through a `.ckpt`: they
    raise a ValueError whose text is the command that writes one
    (`tools/export_torch_ckpt.py`), with the run's paths filled in."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if os.path.isdir(path):
        ckpt = checkpoint_file(path)
        if ckpt is None:
            run = orbax_run(path)
            if run is not None:
                run_dir, step = run
                out = os.path.join(run_dir, "exported_last.ckpt")
                cmd = f"python tools/export_torch_ckpt.py {shlex.quote(run_dir)} --out {shlex.quote(out)}"
                if step is not None:
                    cmd += f" --step {step}"
                raise ValueError(f"{path} is a JAX orbax checkpoint, which the port reads as a .ckpt; from the "
                                 f"repository root run: {cmd} (then load {out})")
            raise FileNotFoundError(f"{path}: neither a port checkpoint (<step>/{CKPT_FILE}) nor a JAX orbax run")
        path = ckpt
    elif path.endswith(".pkl"):
        return load_into(model, from_jax_params(load_tree_pickle(path)))
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    own = model.state_dict()
    merged = dict(own)
    for name, tensor in sd.items():
        if name.split(".")[0] in ("loss", "perceptual_loss") or name not in own:
            continue
        tensor = torch.as_tensor(tensor)
        if tuple(tensor.shape) == tuple(own[name].shape):
            merged[name] = tensor.to(own[name].dtype)
    model.load_state_dict(merged)
    return model


def build_inference_step(model_cfg: VQModelConfig, topk: int = 1, num_src: int = 5, image_size: int = 256,
                         device: str | torch.device = "cuda"):
    """(fn, (model, batch, generator)) for one conditional-generation
    inference step on `model_cfg`: fn(model, batch, generator, gumbel=None)
    -> (rgb [B, H, W, 3] clipped to [-1, 1], metric depth [B, H, W]).

    The step: `get_x` without a depth range, the model's forward with the
    extrapolation mask and top-k (at topk > 1 `generator` draws the Gumbel
    noise, or `gumbel` [P, 1, topk] is the noise itself), sample 0, depth
    through the dataset's codec. fn runs under inference mode;
    `fn.__wrapped__` is the same step without it (`export_aot` traces it
    under no_grad). The model takes seeded random weights
    (`random_state_dict`, seed 0) and the example batch is the JAX
    package's, from `np.random.default_rng(0)`: 5 sources of uniform RGB
    and depth in the model's depth range, the dataset's focal length of
    355.5555 at the image centre, identity rotations, zero translations.
    The generator is a `torch.Generator` on `device` seeded with 3 (JAX's
    `PRNGKey(3)`, whose draws it cannot match bit for bit). The step runs
    at batch 1 with plain attention: as JAX's, it strips `flash_attention`
    from the config, so that a training YAML's `true` does not leak into
    serving."""
    dev = resolve_device(device)
    model_cfg = replace(model_cfg, ddconfig=replace(model_cfg.ddconfig, flash_attention=None))
    codec = get_codec(model_cfg.dataset)
    model = VQModel(model_cfg)
    load_into(model, random_state_dict(model, 0))
    model = model.to(dev).eval()
    b, n, h, w = 1, num_src, image_size, image_size
    rng = np.random.default_rng(0)
    lo, hi = model_cfg.depth_range
    k = np.array([[355.5555, 0, w / 2.0], [0, 355.5555, h / 2.0], [0, 0, 1.0]], np.float32)
    host = {
        "dst_img": np.zeros((b, h, w, 3), np.float32),
        "dst_depth": np.full((b, h, w), (lo + hi) / 2, np.float32),
        "src_imgs": rng.uniform(-1, 1, (b, n, h, w, 3)).astype(np.float32),
        "src_depths": rng.uniform(lo, hi, (b, n, h, w)).astype(np.float32),
        "Ks": np.broadcast_to(k, (b, n, 3, 3)),
        "R_rels": np.broadcast_to(np.eye(3, dtype=np.float32), (b, n, 3, 3)),
        "t_rels": np.zeros((b, n, 3), np.float32),
        "src_masks": np.ones((b, n), np.float32),
    }
    batch = {name: torch.as_tensor(np.ascontiguousarray(v), device=dev) for name, v in host.items()}
    generator = torch.Generator(device=dev).manual_seed(3)

    @torch.inference_mode()
    def fn(model, batch, generator, gumbel=None):
        cond = get_x(batch, model_cfg.dataset, depth_range=None)
        res = model(cond.x, extrapolation_mask=cond.extrapolation_mask, topk=topk, sample_number=1,
                    generator=generator, gumbel=gumbel)
        xrec = res.xrec[:, 0]
        return torch.clamp(xrec[..., :3], -1.0, 1.0), codec.decode(xrec[..., 3])

    return fn, (model, batch, generator)


class SceneServer:
    """Resident scene-generation service: load the model once, serve many
    requests. One `InfiniteSceneGeneration` is kept and takes each
    request's seeds through `reset(seeds)` (under map re-query that also
    rebuilds the map). One lock serialises the device work: one unroll
    owns the card, concurrent requests queue. Each unroll is one scene at
    batch 1 with plain attention (the generator strips the model's flash
    field, as JAX's does).

    Args:
      model: a VQModel; the generator moves it to `device`.
      scene_cfg: the SceneGenConfig of every request.
      template_dir: the seed templates (`pipeline.templates`).
      output_root: the directory under which exports land; a request's
        `output_dir` must resolve inside it.
      device: "cuda" (default) or "cpu" (`core.device.resolve_device`).
    """

    def __init__(self, model: VQModel, scene_cfg, template_dir: str, output_root: str = "serve_out",
                 device: str | torch.device = "cuda"):
        self.model = model
        self.scene_cfg = scene_cfg
        self.template_dir = template_dir
        self.output_root = output_root
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._gen = None
        self._compiled = False
        self._device_info: Optional[Dict[str, Any]] = None
        self.stats: Dict[str, Any] = {
            "requests": 0, "frames": 0, "busy_seconds": 0.0, "last_fps": None, "started": time.time(),
        }

    # ------------------------------------------------------------ internals
    def _load_seeds(self, seed_index: int) -> list:
        from sgam_neurips22_tpu_torch.pipeline.templates import load_seed_frames

        return load_seed_frames(self.template_dir, self.scene_cfg.dataset, seed_index,
                                self.scene_cfg.image_resolution)

    def _generator(self, seeds):
        from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration

        if self._gen is None:
            self._gen = InfiniteSceneGeneration(self.model, self.scene_cfg, seeds, device=self.device)
        else:
            self._gen.reset(seeds)
        return self._gen

    def _device_work(self):
        """Contexts for device work on the calling thread: grad mode and the
        current CUDA device are per thread, so an HTTP handler thread gets
        inference mode and this server's card here."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
        return stack

    # ------------------------------------------------------------ public API
    def warmup(self) -> Dict[str, Any]:
        """Run the whole unroll once on the template seeds, so that the
        first request does not pay for the kernels' build and cuDNN's
        algorithm search."""
        t0 = time.time()
        self.generate({"seed_index": 0, "export": False})
        self._compiled = True
        return {"warmup_seconds": round(time.time() - t0, 2)}

    def generate(self, req: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Serve one scene-generation request.

        Request keys (all optional):
          seed_index (int, default 0): which seed template;
          rng_seed (int, default 3): at topk > 1 the seed of the
            `torch.Generator` on the device that draws the samples (JAX's
            `PRNGKey(rng_seed)` draws other samples); at topk = 1 the
            frames do not depend on it;
          export (bool, default True): write the frames and point clouds;
          output_dir (str): overrides <output_root>/<request id>; it must
            resolve inside output_root, else ValueError.
        """
        req = req or {}
        seed_index = int(req.get("seed_index", 0))
        rng_seed = int(req.get("rng_seed", 3))
        export = bool(req.get("export", True))
        seeds = self._load_seeds(seed_index)
        with self._lock, self._device_work():
            rid = self.stats["requests"]
            self.stats["requests"] = rid + 1
            t0 = time.time()
            gen = self._generator(seeds)
            draws = torch.Generator(device=self.device).manual_seed(rng_seed) if self.scene_cfg.topk > 1 else None
            _, depth = gen.scene_expansion(draws)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            # a host read of the last frame: the time below covers the work
            checksum = float(depth[-1].sum())
            dt = time.time() - t0
            n_frames = gen.grid.size - len(seeds)
            out_dir = None
            if export:
                out_dir = req.get("output_dir") or os.path.join(
                    self.output_root, f"req{rid:04d}_{self.scene_cfg.dataset}_seed{seed_index}")
                # /generate is unauthenticated: a client's path must stay
                # inside output_root
                root = os.path.realpath(self.output_root)
                resolved = os.path.realpath(out_dir)
                if not (resolved == root or resolved.startswith(root + os.sep)):
                    raise ValueError(f"output_dir must be under output_root ({self.output_root})")
                out_dir = resolved
                gen.export_frames(out_dir)
                gen.export_point_clouds(out_dir)
            self.stats["frames"] += n_frames
            self.stats["busy_seconds"] += dt
            fps = n_frames / dt if dt > 0 else 0.0
            self.stats["last_fps"] = round(fps, 2)
            self._compiled = True
        return {
            "request": rid,
            "seed_index": seed_index,
            "frames": n_frames,
            "seconds": round(dt, 3),
            "frames_per_second": round(fps, 2),
            "output_dir": out_dir,
            "depth_checksum": checksum,
        }

    def health(self) -> Dict[str, Any]:
        """Liveness and model/device info. The device info is read once and
        cached, so that /healthz never touches CUDA again (it must answer
        while a request holds the card)."""
        if self._device_info is None:
            if self.device.type == "cuda":
                self._device_info = {"devices": torch.cuda.device_count(), "backend": "cuda",
                                     "device_name": torch.cuda.get_device_name(self.device)}
            else:
                self._device_info = {"devices": 1, "backend": "cpu", "device_name": "cpu"}
        return {
            "status": "ok",
            "dataset": self.scene_cfg.dataset,
            "grid": list(self.scene_cfg.output_dim),
            **self._device_info,
            "compiled": self._compiled,
            "uptime_seconds": round(time.time() - self.stats["started"], 1),
        }

    def metrics(self) -> Dict[str, Any]:
        up = time.time() - self.stats["started"]
        return {
            **{k: v for k, v in self.stats.items() if k != "started"},
            "utilization": round(self.stats["busy_seconds"] / up, 4) if up else 0.0,
        }


def run_http_server(server: SceneServer, host: str = "127.0.0.1", port: int = 8000, warmup: bool = True):
    """A JSON-over-HTTP front end (standard library only); returns the
    ThreadingHTTPServer, whose serve_forever() the caller runs.

    GET  /healthz  -> liveness and model/device info (always answers: each
                      request runs on its own thread, and only /generate
                      and /warmup take the device lock)
    GET  /metrics  -> request and frame counters, utilization, last fps
    POST /warmup   -> run the unroll once (also started at startup, on a
                      daemon thread, unless warmup=False)
    POST /generate -> body = a SceneServer.generate request; returns its result

    A body that is not JSON answers 400, an unknown path 404, and an
    exception 500 with {"error": "<Type>: <message>"}."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (the standard library's name)
            if self.path == "/healthz":
                self._reply(200, server.health())
            elif self.path == "/metrics":
                self._reply(200, server.metrics())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            try:
                n = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(n) or b"{}")
            except ValueError as e:  # json.JSONDecodeError is a ValueError
                self._reply(400, {"error": f"bad request body: {e}"})
                return
            try:
                if self.path == "/generate":
                    self._reply(200, server.generate(req))
                elif self.path == "/warmup":
                    self._reply(200, server.warmup())
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # answer the client; the daemon goes on
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):
            print(f"[serve] {self.address_string()} {fmt % args}", flush=True)

    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"[serve] listening on http://{host}:{httpd.server_address[1]}", flush=True)
    if warmup:
        threading.Thread(target=server.warmup, daemon=True).start()
    return httpd
