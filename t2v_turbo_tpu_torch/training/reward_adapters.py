"""Adapters from the reward models to the LCD loss (port of
t2v_turbo_tpu/training/reward_adapters.py).

The reference decodes a few frames of the student's predicted x_0 inside
the loss and backpropagates the negated reward through the VAE into the
UNet (train_t2v_turbo_v1_lora.py:1043-1098). `make_reward_fns` builds the
two `reward_fn(model_pred, batch) -> (B,) rewards` callables `lcd_loss`
takes:
- image: the `reward_frame_idx` frames of each sample, decoded and scored
  against `reward_text_feats` (the reference's random frames, :1049);
- video: the `video_frame_idx` strided frames, decoded and scored as one
  clip against `video_text_feats` (:1066-1098).
The frame indices and text features are batch fields made on the host
(`sample_frame_indices`, `precompute_text_feats`). The closures hold the
frozen VAE and towers; the JAX package's `make_reward_fn_factory` exists
only so that jit does not bake them in as constants.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


def chunked_decode(vae, frames: torch.Tensor, decode_chunk: Optional[int] = None) -> torch.Tensor:
    """VAE-decode (N, h, w, C) latents `decode_chunk` frames at a time (the
    reference's --vae_decode_batch_size). Each chunk runs under activation
    checkpointing, as under jax.checkpoint: the backward recomputes one
    chunk's activations at a time instead of holding every chunk's. With
    no chunk, or one of at least N frames, the decode runs as one call."""
    n = frames.shape[0]
    if not decode_chunk or decode_chunk >= n:
        return vae.decode(frames)
    return torch.cat([checkpoint(vae.decode, frames[i:i + decode_chunk], use_reentrant=False)
                      for i in range(0, n, decode_chunk)])


def _decode_frames(vae, model_pred, idx, scale_factor, decode_chunk):
    """The frames `idx` (B, n) of each sample of model_pred (B, T, h, w, C),
    decoded to (B * n, H, W, 3) images in [0, 1] (f32)."""
    b, n = idx.shape
    sel = torch.take_along_dim(model_pred, idx.long()[:, :, None, None, None], dim=1)
    imgs = chunked_decode(vae, sel.reshape(b * n, *sel.shape[2:]) / scale_factor, decode_chunk)
    return (imgs.float() / 2.0 + 0.5).clamp(0.0, 1.0)


def make_image_reward_fn(vae, reward_model, scale_factor: float = 0.18215,
                         decode_chunk: Optional[int] = None) -> Callable:
    def reward_fn(model_pred: torch.Tensor, batch: dict) -> torch.Tensor:
        """model_pred: (B, T, h, w, C) predicted clean latents -> (B,)."""
        idx = batch["reward_frame_idx"]
        imgs = _decode_frames(vae, model_pred, idx, scale_factor, decode_chunk)
        feats = batch["reward_text_feats"].repeat_interleave(idx.shape[1], dim=0)
        return reward_model.score(imgs, feats).reshape(idx.shape).mean(dim=1)

    return reward_fn


def make_video_reward_fn(vae, video_reward_model, scale_factor: float = 0.18215,
                         decode_chunk: Optional[int] = None) -> Callable:
    def reward_fn(model_pred: torch.Tensor, batch: dict) -> torch.Tensor:
        idx = batch["video_frame_idx"]
        imgs = _decode_frames(vae, model_pred, idx, scale_factor, decode_chunk)
        return video_reward_model.score(imgs.reshape(*idx.shape, *imgs.shape[1:]),
                                        batch["video_text_feats"])

    return reward_fn


def make_reward_fns(vae, image_rm=None, video_rm=None, scale_factor: float = 0.18215,
                    decode_chunk: Optional[int] = None) -> Tuple[Optional[Callable], Optional[Callable]]:
    """(reward_fn, video_reward_fn) for `lcd_loss`; None where the model is None."""
    rf = vrf = None
    if image_rm is not None:
        rf = make_image_reward_fn(vae, image_rm, scale_factor, decode_chunk)
    if video_rm is not None:
        vrf = make_video_reward_fn(vae, video_rm, scale_factor, decode_chunk)
    return rf, vrf


def sample_frame_indices(rng: np.random.RandomState, batch_size: int, total_frames: int,
                         n_frames: int, strided: bool = False) -> np.ndarray:
    """(batch_size, n_frames) int32 frame indices, drawn as the JAX package
    draws them: a random permutation's first frames for the image reward
    (reference :1049), a random-offset stride for the video reward
    (:1071-1076). The same RandomState gives both packages the same frames."""
    out = np.zeros((batch_size, n_frames), np.int32)
    if strided:
        skip = total_frames // n_frames
        for i in range(batch_size):
            start = rng.randint(0, max(skip, 1))
            out[i] = np.arange(start, total_frames, skip)[:n_frames]
    else:
        for i in range(batch_size):
            out[i] = rng.permutation(total_frames)[:n_frames]
    return out


def precompute_text_feats(reward_model, texts) -> torch.Tensor:
    """Normalised text features for a batch, without a graph."""
    return reward_model.encode_texts(list(texts))
