"""Serve-from-artifacts pipeline (port of t2v_turbo_tpu/pipelines/artifact.py):
prompt -> video from the `torch.export` programs that `apps/warmup.py
--export` writes, with no model code.

`warmup --export DIR` writes three programs, each a `.pt2` file that
`torch.export.load` reads back, and a manifest.json:

- `lcm_step`: one LCM step (the UNet, the boundary combine, the renoise:
  `T2VTurboVC2Pipeline.lcm_step`), its timestep and its five scalars
  (sqrt(a_t), sqrt(1 - a_t), c_skip, c_out, a_prev) given as inputs. The
  manifest's `grid` lists them for every step, so this host loops over the
  grid and needs no schedule;
- `vae_decode`: `decode_latents` on chunks of `decode_chunk` frames;
- `text_encode`: the text tower on the tokenizer's ids.

The weights are program inputs (the programs call `torch.func.
functional_call` on state dicts), so a `.pt2` file holds no weights, as
the JAX artifact holds no params: `from_dir` takes the state dicts a
checkpoint's key maps give (io/convert.py) and casts each tensor to the
dtype the manifest records for it.

This module imports nothing of models/ or diffusion/. It does import `ops`:
unlike JAX's StableHLO, which embeds its kernels, an exported program
names the hand-written kernels as `t2v_turbo::*` operators, which must be
registered before `torch.export.load` reads the program; running it
launches them (and counts their launches, as the live pipeline does). The
one piece of host math, the guidance-scale embedding, is inlined below.

Randomness: the initial latents and each step's renoise are drawn here
from the caller's `torch.Generator`, in the live pipeline's order
(pipelines/vc2.py), and passed in, so the artifact and the live pipeline
give the same video for the same seed. The programs are bound to the
exported operating point (steps, frames, height, width, batch, decode
chunk); prompt, seed, fps and guidance scale stay free.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import ops  # noqa: F401  (registers the t2v_turbo operators the programs call)

PROGRAMS = ("lcm_step", "vae_decode", "text_encode")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _guidance_scale_embedding(w: torch.Tensor, dim: int) -> torch.Tensor:
    """w * 1000 sinusoidal embedding, [sin | cos]: diffusion.lcm's
    guidance_scale_embedding, op for op (the artifact-vs-live test holds them
    equal to the bit)."""
    w = w.float() * 1000.0
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=w.device) * (-math.log(10000.0) / (half - 1)))
    emb = w[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def program_weights(manifest: dict, name: str, sd: Mapping[str, torch.Tensor], device) -> dict:
    """The tensors of `sd` that program `name` takes, each cast to the dtype
    and checked against the shape the manifest records; raises on a missing
    key or a shape that differs. Keys the program does not take are left
    out (an open_clip checkpoint's last block, which the penultimate tower
    never runs)."""
    want = manifest["weights"][name]
    missing = sorted(k for k in want if k not in sd)
    if missing:
        raise KeyError(f"{name}: the state dict lacks {len(missing)} weights the program takes, "
                       f"first {missing[:5]}")
    out = {}
    for k, (dtype, shape) in want.items():
        t = sd[k]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: weight {k} has shape {tuple(t.shape)}, the program takes {tuple(shape)}")
        out[k] = t.detach().to(device=device, dtype=_DTYPES[dtype])
    return out


class ArtifactPipeline:
    """Prompt -> video from exported programs and state dicts.

    The call surface is the live pipeline's, so apps/serve.py takes either;
    a static knob off the exported operating point raises, naming it."""

    def __init__(self, *, programs: dict, manifest: dict, weights: dict, tokenizer: Any, device):
        self._step = programs["lcm_step"]
        self._decode = programs["vae_decode"]
        self._encode = programs["text_encode"]
        self.manifest = manifest
        self.op = manifest["operating_point"]
        self.weights = weights
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.dtype = _DTYPES[self.op["dtype"]]
        op = self.op
        # apps/serve.py's /healthz: the one operating point these programs serve
        self.operating_points = {(op["frames"], op["height"], op["width"], op["steps"], op["lcm_origin_steps"])}

    @classmethod
    def from_dir(cls, path: str, *, unet_sd: Mapping, vae_sd: Mapping, text_sd: Mapping, tokenizer: Any = None,
                 device="cuda:0") -> "ArtifactPipeline":
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if "operating_point" not in manifest or "grid" not in manifest:
            raise ValueError(f"{path}/manifest.json is not a manifest of apps/warmup.py --export")
        device = torch.device(device)
        programs = {n: torch.export.load(os.path.join(path, manifest["programs"][n]["artifact"])).module()
                    for n in PROGRAMS}
        sds = {"lcm_step": unet_sd, "vae_decode": vae_sd, "text_encode": text_sd}
        weights = {n: program_weights(manifest, n, sds[n], device) for n in PROGRAMS}
        return cls(programs=programs, manifest=manifest, weights=weights, tokenizer=tokenizer, device=device)

    @torch.no_grad()
    def encode_prompt(self, prompt: str | Sequence[str]) -> torch.Tensor:
        tokens = torch.from_numpy(np.asarray(self.tokenizer(prompt))).to(self.device)
        return self._encode(self.weights["text_encode"], tokens)

    def _check(self, name, got, want):
        if got != want:
            raise ValueError(
                f"artifact pipeline is compiled for {name}={want}; got {got}. Re-export with "
                f"`python -m t2v_turbo_tpu_torch.apps.warmup --export ...` at the requested operating point."
            )

    def _randn(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        dev = generator.device if generator is not None else self.device
        return torch.randn(shape, generator=generator, device=dev).to(self.device)

    @torch.no_grad()
    def __call__(
        self,
        prompt: str | Sequence[str] | None = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        frames: Optional[int] = None,
        fps: int = 16,
        guidance_scale: float = 7.5,
        num_videos_per_prompt: int = 1,
        num_inference_steps: Optional[int] = None,
        lcm_origin_steps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        output_type: str = "video",
        use_motion_cond: Optional[bool] = None,
        motion_gs: float = 0.1,
        percentage: Optional[float] = None,
        decode_frame_chunk: Optional[int] = None,
    ) -> torch.Tensor:
        op = self.op
        self._check("height", height if height is not None else op["height"], op["height"])
        self._check("width", width if width is not None else op["width"], op["width"])
        self._check("frames", frames if frames is not None else op["frames"], op["frames"])
        self._check("steps", num_inference_steps if num_inference_steps is not None else op["steps"], op["steps"])
        self._check("lcm_origin_steps", lcm_origin_steps if lcm_origin_steps is not None else op["lcm_origin_steps"],
                    op["lcm_origin_steps"])
        if use_motion_cond is not None:
            self._check("use_motion_cond", use_motion_cond, op["use_motion_cond"])
        # the percentage picks the grid's motion-guided steps; it matters only with the motion embedding
        if percentage is not None and op["use_motion_cond"]:
            self._check("percentage", percentage, op["percentage"])
        if decode_frame_chunk is not None:
            self._check("decode_frame_chunk", decode_frame_chunk, op["decode_chunk"])

        if prompt_embeds is None:
            if prompt is None:
                raise ValueError("pass a prompt or prompt_embeds")
            prompt_embeds = self.encode_prompt(prompt)
        ctx = prompt_embeds.to(self.device, self.dtype)
        if num_videos_per_prompt != 1:
            ctx = ctx.repeat_interleave(num_videos_per_prompt, dim=0)
        bs = ctx.shape[0]
        self._check("batch", bs, op["batch"])

        shape = (bs, op["frames"], op["height"] // op["vae_scale"], op["width"] // op["vae_scale"],
                 op["in_channels"])
        if latents is None:
            latents = self._randn(shape, generator)
        elif tuple(latents.shape) != shape:
            raise ValueError(f"latents shape {tuple(latents.shape)} != compiled shape {shape}")
        lat = latents.to(self.device, self.dtype)

        w = torch.full((bs,), guidance_scale, device=self.device)
        w_emb = _guidance_scale_embedding(w, op["w_embedding_dim"]).to(self.dtype)
        fps_arr = torch.full((bs,), float(fps), device=self.device)

        def scalar(x):
            return torch.tensor(x, dtype=torch.float32, device=self.device)

        zeros = None
        for i, step in enumerate(self.manifest["grid"]):
            tb = torch.full((bs,), step["t"], dtype=torch.long, device=self.device)
            scalars = tuple(scalar(step[k]) for k in ("sqrt_alpha", "sqrt_one_minus_alpha", "c_skip", "c_out",
                                                      "alpha_prev"))
            if op["steps"] > 1:
                step_noise = noise[i].to(self.device) if noise is not None else self._randn(shape, generator)
            else:  # one step draws no renoise; the program's next latents go unused
                zeros = zeros if zeros is not None else torch.zeros(shape, device=self.device)
                step_noise = zeros
            args = [self.weights["lcm_step"], lat, tb, ctx, fps_arr, w_emb, scalars, step_noise]
            if op["use_motion_cond"]:
                gs = motion_gs if step["motion_on"] else 0.0
                args.append(_guidance_scale_embedding(torch.full((bs,), gs, device=self.device),
                                                      op["w_embedding_dim"]).to(self.dtype))
            lat, denoised = self._step(*args)

        if output_type == "latent":
            return denoised
        b, t, hh, ww, c = denoised.shape
        flat = denoised.reshape(b * t, hh, ww, c)
        chunk = op["decode_chunk"]
        if (b * t) % chunk:
            raise ValueError(f"decode artifact is compiled for chunks of {chunk} frames; "
                             f"{b * t} frames do not divide evenly")
        video = torch.cat([self._decode(self.weights["vae_decode"], flat[i:i + chunk])
                           for i in range(0, b * t, chunk)])
        return video.reshape(b, t, *video.shape[1:])


def video_to_uint8(video: torch.Tensor) -> np.ndarray:
    """[-1, 1] float video -> uint8 numpy, on the host (here, not in
    pipelines/vc2.py, which re-exports it: a host that serves artifacts
    must not import the models)."""
    v = ((video.float() + 1.0) / 2.0).clamp(0, 1).cpu().numpy()
    return (v * 255).round().astype(np.uint8)
