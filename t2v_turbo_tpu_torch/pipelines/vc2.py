"""T2V-Turbo (VideoCrafter2) prompt -> video (port of t2v_turbo_tpu/pipelines/vc2.py).

Encode the prompt with the CLIP text tower, draw N(0, 1) latents, run the
LCM loop (UNet, boundary-condition combine, renoise) as a plain Python loop
over the 4 timesteps [999, 759, 519, 279] (`lcm_step`), then decode the
frames with the VAE, all at once or `decode_frame_chunk` at a time
(`decode_latents`; JAX pipelines/vc2.py:288-293). Randomness comes from an explicit `torch.Generator`; tests may pass the
latents and the per-step noise instead, so two implementations can share them.

Over a mesh (`mesh=`, parallel/mesh.py; one process per rank, the JAX
pipeline's `mesh` at vc2.py:216-293): the batch splits over the data axis
and the frames over the seq axis. Every rank draws the global latents and
each step's renoise from its generator (every rank's is seeded alike) and
keeps its (data, seq) block, so a sharded run draws the single-rank numbers,
as JAX's device_put of one global draw does; latents and noise a caller
passes are global too. The UNet's temporal layers run sequence-parallel
(UNetModel.set_seq_group). Over a model axis of more than one rank the
UNet's weights are split once, in place (UNetModel.set_model_group, JAX's
tensor-parallel shardings at vc2.py:231-248): the model ranks of one
(data, seq) block hold the same latents and contexts and each runs its
share of the heads, GEGLU and conv channels; the VAE and the text tower
stay whole, as in JAX. The sampled latents are gathered on every rank;
the VAE, which is per frame, decodes B*T / world frames on each rank (the
first B*T % world ranks one more where they do not divide) and the frames
are gathered on rank 0, which returns the video; the other ranks return
None (output_type="latent": every rank returns the global latents).

T2V-Turbo-v2's students also take a motion-guidance embedding
(`use_motion_cond`): guidance_scale_embedding(motion_gs) at the steps whose
timestep t >= num_timesteps * (1 - percentage), of 0 below that (JAX
pipelines/vc2.py:107-120, the reference pipeline :190-204). The v2
operating point is 16 steps from an LCM origin grid of 200.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from ..diffusion import DiffusionSchedule, LCMScheduler, guidance_scale_embedding
from ..diffusion.scheduler import lcm_update
from ..parallel import collectives
from ..parallel.mesh import shard
from .artifact import video_to_uint8  # noqa: F401  (the CLIs' uint8 conversion, kept beside the artifact host's)


@dataclasses.dataclass
class T2VTurboVC2Pipeline:
    unet: torch.nn.Module
    vae: torch.nn.Module
    text_model: torch.nn.Module
    tokenizer: Any
    schedule: DiffusionSchedule
    device: torch.device
    scale_factor: float = 0.18215
    vae_scale: int = 8
    w_embedding_dim: int = 256
    dtype: torch.dtype = torch.bfloat16
    mesh: Optional[Any] = None  # parallel.mesh.Mesh: sample over (data, seq, model) ranks

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.scheduler = LCMScheduler(schedule=self.schedule.to(self.device))
        if self.mesh is not None:
            if not hasattr(self.unet, "set_seq_group"):
                raise NotImplementedError(f"{type(self.unet).__name__} has no sequence-parallel path")
            self.unet.set_seq_group(self.mesh.axis("seq"))
            self.unet.set_model_group(self.mesh.axis("model"))

    def _shard(self, x: torch.Tensor, spec=("data", "seq")) -> torch.Tensor:
        """This rank's block of a global (B, T, ...) tensor (rows only for
        spec ("data",)); the tensor itself without a mesh."""
        return x if self.mesh is None else shard(self.mesh, x, spec)

    @torch.no_grad()
    def encode_prompt(self, prompt: str | Sequence[str]) -> torch.Tensor:
        """prompt(s) -> (B, 77, 1024) cross-attention context."""
        tokens = torch.from_numpy(self.tokenizer(prompt)).to(self.device)
        return self.text_model(tokens)

    def _randn(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        dev = generator.device if generator is not None else self.device
        return torch.randn(shape, generator=generator, device=dev).to(self.device)

    @torch.no_grad()
    def __call__(
        self,
        prompt: str | Sequence[str] | None = None,
        height: int = 320,
        width: int = 512,
        frames: int = 16,
        fps: int = 16,
        guidance_scale: float = 7.5,
        num_videos_per_prompt: int = 1,
        num_inference_steps: int = 4,
        lcm_origin_steps: int = 50,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        output_type: str = "video",
        use_motion_cond: bool = False,
        motion_gs: float = 0.1,
        percentage: float = 0.3,
        decode_frame_chunk: Optional[int] = None,
    ) -> torch.Tensor:
        """-> video (B, T, H, W, 3) in [-1, 1], or the final latents when
        output_type="latent". `noise`, when given, is the renoise draw of
        each step (used only when there is more than one step).
        `decode_frame_chunk`: frames a VAE decode call (None: all B*T at
        once; the last chunk may be shorter)."""
        if use_motion_cond and getattr(self.unet, "motion_cond_proj", None) is None:
            raise ValueError("use_motion_cond needs a UNet built with motion_cond_proj_dim")
        multiple = self.vae_scale * 2 ** (self._levels() - 1)
        if height % multiple or width % multiple:
            raise ValueError(f"height/width must be multiples of {multiple} (got {height}x{width})")
        if prompt_embeds is None:
            if prompt is None:
                raise ValueError("pass a prompt or prompt_embeds")
            prompt_embeds = self.encode_prompt(prompt)
        ctx = prompt_embeds.to(self.device, self.dtype)
        if num_videos_per_prompt != 1:
            ctx = ctx.repeat_interleave(num_videos_per_prompt, dim=0)
        bs = ctx.shape[0]
        if self.mesh is not None and (bs % self.mesh.data or frames % self.mesh.seq):
            raise ValueError(
                f"sharded inference needs batch {bs} divisible by the data axis ({self.mesh.data}) and frames "
                f"{frames} by the seq axis ({self.mesh.seq})")

        shape = (bs, frames, height // self.vae_scale, width // self.vae_scale,
                 self.unet.cfg.in_channels)
        if latents is None:
            latents = self._randn(shape, generator)
        lat = self._shard(latents.to(self.device, self.dtype))
        ctx = self._shard(ctx, ("data",))
        bs = ctx.shape[0]

        w = torch.full((bs,), guidance_scale, device=self.device)
        w_emb = guidance_scale_embedding(w, self.w_embedding_dim).to(self.dtype)
        fps_arr = torch.full((bs,), float(fps), device=self.device)

        ts = [int(t) for t in self.scheduler.timesteps(num_inference_steps, lcm_origin_steps)]
        prev_ts = ts[1:] + ts[-1:]
        denoised = lat
        for i, (t, pt) in enumerate(zip(ts, prev_ts)):
            tb = torch.full((bs,), t, dtype=torch.long, device=self.device)
            motion = None
            if use_motion_cond:
                gs = motion_guidance_scale(t, motion_gs, percentage, self.schedule.num_timesteps)
                motion = guidance_scale_embedding(
                    torch.full((bs,), gs, device=self.device), self.w_embedding_dim).to(self.dtype)
            step_noise = None
            if num_inference_steps > 1:
                step_noise = noise[i].to(self.device) if noise is not None else self._randn(shape, generator)
                step_noise = self._shard(step_noise)
            lat, denoised = self.lcm_step(lat, tb, ctx, fps_arr, w_emb, self.scheduler.step_scalars(t, pt),
                                          step_noise, motion)

        if self.mesh is not None:
            denoised = self._gather_latents(denoised)
        if output_type == "latent":
            return denoised
        b, t, hh, ww, c = denoised.shape
        flat = denoised.reshape(b * t, hh, ww, c)
        if self.mesh is not None:  # each rank decodes its share of the frames
            counts = frame_split(b * t, self.mesh.size)
            flat = flat[sum(counts[:self.mesh.rank]):][:counts[self.mesh.rank]]
        chunk = decode_frame_chunk or len(flat)
        video = torch.cat([self.decode_latents(flat[i:i + chunk]) for i in range(0, len(flat), chunk)])
        if self.mesh is not None:
            video = collectives.gather_to_root(video, counts, self.mesh.axis("world"))
            if video is None:
                return None
        return video.reshape(b, t, *video.shape[1:])

    def _gather_latents(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's (B / data, T / seq, ...) block -> the global (B, T, ...)."""
        every = collectives.gather_to_all(local, self.mesh.axis("world"))
        blocks = [[None] * self.mesh.seq for _ in range(self.mesh.data)]
        for r in range(self.mesh.size):
            d, s, _ = self.mesh.coords(r)
            blocks[d][s] = every[r]
        return torch.cat([torch.cat(row, dim=1) for row in blocks])

    def lcm_step(self, lat, tb, ctx, fps, w_emb, scalars, noise=None, motion_cond=None):
        """One LCM step: the UNet, the boundary combine, the renoise ->
        (the next latents in the pipeline's dtype, the f32 denoised ones).
        warmup --export traces exactly this as the `lcm_step` program."""
        kw = {} if motion_cond is None else {"motion_cond": motion_cond}
        eps = self.unet(lat, tb, ctx, **self._unet_kwargs(fps, w_emb, **kw))
        lat_next, denoised = lcm_update(eps.float(), lat.float(), scalars, noise)
        return lat_next.to(self.dtype), denoised

    def decode_latents(self, z):
        """(N, h, w, 4) denoised latents -> (N, H, W, 3) frames in [-1, 1]
        (the `vae_decode` program)."""
        return self.vae.decode(z.to(self.dtype) / self.scale_factor)

    def _levels(self) -> int:
        return len(self.unet.cfg.channel_mult)

    def _unet_kwargs(self, fps, w_emb, **kw):
        return dict(fps=fps, timestep_cond=w_emb, **kw)


def frame_split(n: int, ranks: int) -> list:
    """Frames each of `ranks` ranks decodes of n: n // ranks, and one more on
    the first n % ranks ranks."""
    return [n // ranks + (r < n % ranks) for r in range(ranks)]


def motion_guidance_scale(t: int, motion_gs: float, percentage: float, num_timesteps: int = 1000) -> float:
    """The motion-guidance scale the v2 student is given at timestep t:
    `motion_gs` in the top `percentage` of the schedule, else 0."""
    return 0.0 if t < num_timesteps * (1.0 - percentage) else float(motion_gs)

