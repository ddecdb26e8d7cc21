"""Cells of kind "unroll": the port's batched scene generation
(`InfiniteSceneGeneration.scene_expansion_batched`) under a closed loop of
requests, each request `scenes` scenes from their own seed frames, unrolled
over the traffic's trajectory.

`frames_per_s` counts every generated RGB-D frame of every scene of the
requests the window ran (the seed frames are inputs), over the time from
the window's start to the end of its last request. A request starts only
while window time is left and ends with a synchronize: the client waits
for its frames.

The check: after the window, a request drawn from the seed among those it
finished (`window`) is followed by the plain reference (`reference/unroll.follow`),
step by step from the program's own earlier frames. A VQ model's tokens
are its codewords: each step's are read as the model returns them, and
held to the reference's distances from its own latents (the served
model's rule: the gap by which a chosen token lies below the reference's
best), and the program's frames to the reference's decode of those
codewords (`check`).
"""
from __future__ import annotations

import math
import random
import time

import torch

from portbench import program, traffic as gen, weights, work
from portbench.reference import autoencoder as ref_autoencoder
from portbench.reference import codec as ref_codec
from portbench.reference import plain_ops
from portbench.reference import model as ref_model
from portbench.reference import quantize as ref_quantize
from portbench.reference import unroll as ref_unroll


def _ref_model(cfg: dict):
    return ref_model.VQModel(program.vq_config(cfg, ref_autoencoder, ref_model, "float32", False))


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault=None):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.fault = fault  # tests only: a callable that breaks the program's output
        g = math.prod(traffic["grid"])
        self.frames_per_request = traffic["scenes"] * (g - 1)

    def setup(self) -> None:
        """Weights from the seed, the program, and one warm request of the
        cell's own shapes (not counted)."""
        with torch.device("meta"):
            shapes = _ref_model(self.cfg)
        self.weights = weights.vq_weights(shapes, self.seed, self.device, self.cfg["codebook_std"])
        model = program.vq_model(self.cfg, self.weights, self.device)
        warm = gen.request_seeds(self.cfg, self.traffic, self.seed, -1, self.device)
        self.gen = program.generator(self.cfg, self.traffic, model, warm[0], self.device)
        # the codewords each step chose (the VQ model's tokens), as the model returns them
        model.register_forward_hook(lambda module, args, out: self._codes.append(out.indices))
        self.request(-1)

    def request(self, index: int):
        """(rgb [S, G, H, W, 3], depth [S, G, H, W], each step's codewords)."""
        seeds = gen.request_seeds(self.cfg, self.traffic, self.seed, index, self.device)
        self._codes = []
        rgb, depth = self.gen.scene_expansion_batched(seeds)
        if self.fault is not None:
            self.fault(rgb, depth)
        return rgb, depth, self._codes

    def window(self, seconds: float) -> dict:
        """Requests while window time is left. One finished request, drawn
        from the seed with equal chances, is kept for the check (a sample of
        one by reservoir sampling: the outputs of the others are freed as the
        program frees them, so that the peak of device memory is the
        program's)."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        draw = random.Random(self.seed)
        sync()
        t0 = time.perf_counter()
        end, done = t0, 0
        while end - t0 < seconds:
            out = self.request(done)
            sync()
            end = time.perf_counter()
            if draw.random() * (done + 1) < 1.0:
                self.kept = (done, out)
            done += 1
        frames = done * self.frames_per_request
        return {"units": frames, "seconds": end - t0, "attempted": done,
                "metrics": {"frames_per_s": frames / (end - t0)}}

    def trace_call(self):
        """One more request, for a traced session; returns the frames it makes."""
        self.request(-2)
        return self.frames_per_request

    def flops_per_unit(self) -> float:
        h, w = self.cfg["image_resolution"]
        return work.forward_flops(lambda: _ref_model(self.cfg), h, w)

    def check(self, control: bool = False) -> dict:
        """Free the program, follow one request drawn from the seed with
        the reference, and return the readings:
        - code_gap: over every latent of every generated frame, the widest
          relative gap by which the squared distance of the codeword the
          program chose, from the reference's latent, lies above the
          reference's nearest;
        - decode_gap: over every generated frame, the widest relative RMS
          gap between the program's frame (RGB, and its depth as
          disparity) and the reference's decode of the program's codewords.
        With `control`, also the control's (`control_` + the same): the
        reference one precision below the configuration's
        (`plain_ops.low_precision`) in the program's place, its own
        codewords read against the float32 reference's distances and its
        decode of the program's codewords against the float32 decode."""
        pick, (rgb, depth, codes) = self.kept
        del self.gen, self.kept
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        plain_ops.set_f32()
        with torch.device("meta"):
            model = _ref_model(self.cfg)
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.weights)
        model.eval()
        codec = ref_codec.get_codec(self.cfg["dataset"])
        book = model.codebook
        got = {"code_gap": [], "decode_gap": [], "control_code_gap": [], "control_decode_gap": []}

        def decoded(c):  # (rgb, disparity) of codewords c, as the program writes its frames
            xrec = model.decode(book[c.long()], flash=False)
            return torch.clamp(xrec[..., :3], -1.0, 1.0), xrec[..., 3]

        def disparity(d):  # the depth codec inverted without its clamp: linear in the model's output
            return 2.0 * (1.0 / (d + codec.shift) - codec.inv_hi) / (codec.inv_lo - codec.inv_hi) - 1.0

        def distances(cond):  # [P, K]: every codeword's from each of the reference's latents of the step
            z = model.encode_prequant(cond.x, cond.extrapolation_mask, flash=False)
            return ref_quantize.codeword_distances(z.reshape(-1, z.shape[-1]), book)

        def on_step(t, tgt, cond):
            dist = distances(cond)
            best = dist.min(dim=1).values
            step_codes = codes[t].reshape(rgb.shape[0], *codes[t].shape[-2:])  # [S, h, w]: sample 0 of the draw
            c = step_codes.reshape(-1)
            got["code_gap"].append(float(((dist.gather(1, c[:, None].long())[:, 0] - best) / best).max()))
            ref_rgb, ref_depth = decoded(step_codes)
            got["decode_gap"].append(max(_frame_gaps(rgb[:, tgt], disparity(depth[:, tgt]), ref_rgb, ref_depth)))
            if control:
                with plain_ops.low_precision():
                    low = distances(cond)
                    low_rgb, low_depth = decoded(step_codes)
                c8 = low.argmin(dim=1)
                got["control_code_gap"].append(float(((dist.gather(1, c8[:, None])[:, 0] - best) / best).max()))
                got["control_decode_gap"].append(max(_frame_gaps(low_rgb, low_depth, ref_rgb, ref_depth)))

        ref_unroll.follow(self.cfg, self.traffic, rgb, depth, on_step)
        out = {"request": pick, "frames": len(got["decode_gap"]) * rgb.shape[0]}
        out.update({k: max(v) for k, v in got.items() if v})
        return out


def _frame_gaps(rgb, depth, ref_rgb, ref_depth) -> list:
    """Per scene: the larger of the relative RMS of the RGB and of the
    disparity (the model's output; the metric depth decoded from it grows
    without bound where random weights put it past the far plane)."""
    return [max(float((rgb[s] - ref_rgb[s]).norm() / ref_rgb[s].norm()),
                float((depth[s] - ref_depth[s]).norm() / ref_depth[s].norm())) for s in range(rgb.shape[0])]
