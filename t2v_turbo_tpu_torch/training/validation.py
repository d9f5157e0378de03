"""Periodic validation videos during training (port of
t2v_turbo_tpu/training/validation.py).

The reference renders a fixed set of 10 prompts at 8 and 16 steps every
--validation_steps and logs the clips to wandb
(utils/common_utils.py:322-387). Here the student renders them through the
pipeline into <output_dir>/validation/ with an index.jsonl, no tracking
service needed.

Each prompt's render draws from its own `torch.Generator` seeded with the
prompt's index (the JAX package's `PRNGKey(i)`), so a run with validation
takes the same training draws as one without, and a render equals a
direct pipeline call with the same weights and seed. The files are mp4
(through ffmpeg) or, with suffix ".npy", the uint8 frames; a file that
cannot be written raises, and the container is never switched silently.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import torch
from torch.nn.utils import parametrize

# the reference's validation set (utils/common_utils.py:325-338)
DEFAULT_VALIDATION_PROMPTS = (
    "An astronaut riding a horse.",
    "Darth vader surfing in waves.",
    "Robot dancing in times square.",
    "Clown fish swimming through the coral reef.",
    "A child excitedly swings on a rusty swing set, laughter filling the air.",
    "With the style of van gogh, A young couple dances under the moonlight by the lake.",
    "A young woman with glasses is jogging in the park wearing a pink headband.",
    "Impressionist style, a yellow rubber duck floating on the wave on the sunset",
    "Wolf, turns its head, in the wild",
    "Iron man, walks, on the moon, 8k, high detailed, best quality",
)


def make_validation_logger(pipe, output_dir: str, prompts: Optional[Sequence[str]] = None,
                           step_counts: Sequence[int] = (8, 16), frames: int = 16, height: int = 320,
                           width: int = 512, save_fps: int = 8, max_prompts: Optional[int] = None,
                           suffix: str = ".mp4", write: bool = True):
    """validation_fn(step, unet) for `LCDTrainer.run`: renders each prompt
    at each step count with `unet` (the trainer's student, its LoRA merged
    through the weights' parametrisation) in `pipe`'s place, and appends
    {step, sample_steps, prompt, path} rows to validation/index.jsonl. The
    student's train flags and the pipeline's own UNet are restored after.
    Over a mesh every rank renders (the UNet's seq layers are collective);
    only a logger with `write` (rank 0's) writes, and a rank whose pipeline
    returns no video writes nothing."""
    from ..io.video import save_video
    from ..pipelines.vc2 import video_to_uint8

    if suffix not in (".mp4", ".npy"):
        raise ValueError(f"validation videos are .mp4 or .npy, not {suffix!r}")
    prompts = list(prompts or DEFAULT_VALIDATION_PROMPTS)[:max_prompts or None]
    vdir = os.path.join(output_dir, "validation")
    if write:
        os.makedirs(vdir, exist_ok=True)
    index_path = os.path.join(vdir, "index.jsonl")

    def validation_fn(step: int, unet: torch.nn.Module):
        old_unet, modes = pipe.unet, [(m, m.training) for m in unet.modules()]
        pipe.unet = unet.eval()
        try:
            with torch.no_grad(), parametrize.cached():
                for n_steps in step_counts:
                    for i, prompt in enumerate(prompts):
                        video = pipe(prompt=prompt, height=height, width=width, frames=frames,
                                     num_inference_steps=n_steps, generator=torch.Generator().manual_seed(i))
                        if video is None or not write:
                            continue
                        path = save_video(video_to_uint8(video)[0],
                                          os.path.join(vdir, f"step{step:07d}_s{n_steps}_p{i}{suffix}"),
                                          fps=save_fps)
                        with open(index_path, "a") as f:
                            f.write(json.dumps({"step": step, "sample_steps": n_steps, "prompt": prompt,
                                                "path": path}) + "\n")
        finally:
            pipe.unet = old_unet
            for m, training in modes:
                m.training = training

    validation_fn.pipe = pipe
    return validation_fn
