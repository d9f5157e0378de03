"""MotionClone's motion prior (port of t2v_turbo_tpu/training/motion.py):
the temporal-attention probability capture, the rank-k attention loss, the
score as the gradient of that loss with respect to the latents, and the
DDIM inversion loop.

The reference taps attn1's probabilities in the temporal transformers of
output blocks 3-11 through module hooks (motion_prior_sample.py:27-84,
utils/common_utils.py:446-478); the port's UNet returns them itself
(`UNetModel.forward(..., record_probs=True)`, models/unet_vc2.py), in
ascending output-block order: the pairing of each generated layer with
its reference layer is JAX's, the order of the layers is not (JAX sorts
them by key string), and the loss is a mean over layers.

`unet` below is a UNet module (or any callable with its signature); its
weights need no gradient: the score is a gradient with respect to the
latents alone, so every kernel's autograd function computes the input's
gradient and no weight's.

Under sequence parallelism (`group=`, the seq axis of parallel/mesh.py,
with the UNet's seq group set to it) each rank holds T / seq frames of the
latents and captures the rows of its H*W / seq columns; the generated and
the reference capture on one rank share that split. The rank loss of a
layer is (masked squared difference summed) / (mask count) over every row
of every rank: each rank divides its own sum by the count all-reduced over
the group (detached), so the ranks' terms add up to the one-process loss,
and the gradient of each rank's term, through the collectives' backward,
gives every rank the global loss's gradient with respect to its frames.
Each row's top-k threshold is over its T keys, all on the rank.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..diffusion import DDIMSolver


def temp_attn_probs(unet, latents: torch.Tensor, ts: torch.Tensor, ctx: torch.Tensor, fps=None,
                    **kw) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(the UNet's output, [the captured probabilities (B*H*W*heads, T, T), ...])."""
    return unet(latents, ts, ctx, fps=fps, record_probs=True, **kw)


def motion_rank_loss(probs: Sequence[torch.Tensor], probs_ref: Sequence[torch.Tensor], rank_k: int = 1,
                     scale: float = 100.0, group=None) -> torch.Tensor:
    """Mean over layers of the squared difference on each row's top-rank_k
    reference entries (those >= the row's rank_k-th largest), divided by
    the count of such entries, x `scale` (reference
    calculate_motion_rank_new / compute_temp_loss). The reference side
    carries no gradient. With a seq `group` of more than one rank: this
    rank's term, its sums over the counts of every rank (the module
    docstring); the group's sum of the terms is the loss."""
    if len(probs) != len(probs_ref) or not probs:
        raise ValueError(f"{len(probs)} captured layers against {len(probs_ref)} reference layers")
    if rank_k == 0:
        return torch.zeros((), device=probs_ref[0].device)
    sums, counts = [], []
    for gen, ref in zip(probs, probs_ref):
        ref = ref.detach()
        if rank_k > ref.shape[-1]:
            raise ValueError(f"rank_k {rank_k} > {ref.shape[-1]} keys")
        thresh = torch.topk(ref, rank_k, dim=-1).values[..., -1:]
        mask = ref >= thresh
        sums.append((torch.square(ref - gen) * mask).sum())
        counts.append(mask.sum())
    counts = torch.stack(counts)
    if group is not None and group.size > 1:
        from ..parallel import collectives

        counts = collectives.all_reduce_(counts.double(), group)  # exact: counts are integers
    losses = torch.stack(sums) / counts.clamp_min(1).to(sums[0].dtype)
    return losses.mean() * scale


def motion_prior_score(unet, latents: torch.Tensor, ts: torch.Tensor, example_latents: torch.Tensor,
                       original_ctx: torch.Tensor, inference_ctx: torch.Tensor, fps=None,
                       temp_loss_scale: float = 1.0, rank_k: int = 1,
                       return_loss: bool = False, group=None) -> Tuple[torch.Tensor, ...]:
    """(score, the conditional output at `latents`[, the unscaled rank
    loss]): score = d(temp_loss_scale * rank loss)/d latents between the
    capture at `latents` under `inference_ctx` and the reference capture
    at `example_latents` under `original_ctx`, taken under no_grad
    (reference get_motion_prior_score:59-84). Two UNet calls: the reference
    capture, then the capture with gradient, whose output is the
    conditional output. All detached. With a seq `group` (the UNet's):
    latents, example_latents, the score and the output are this rank's
    frames, the loss the whole one (every rank calls this)."""
    with torch.no_grad():
        _, probs_ref = temp_attn_probs(unet, example_latents, ts, original_ctx, fps)
    z = latents.detach().requires_grad_(True)
    with torch.enable_grad():
        out, probs = temp_attn_probs(unet, z, ts, inference_ctx, fps)
        raw = motion_rank_loss(probs, probs_ref, rank_k, group=group)
        (score,) = torch.autograd.grad(temp_loss_scale * raw, z)
    result = (score.detach(), out.detach())
    if not return_loss:
        return result
    raw = raw.detach()
    if group is not None and group.size > 1:
        from ..parallel import collectives

        raw = collectives.all_reduce_(raw.clone().reshape(1), group)[0]
    return result + (raw,)


@torch.no_grad()
def reverse_ddim_loop(unet, latents: torch.Tensor, ctx: torch.Tensor, solver: DDIMSolver, num_steps: int,
                      fps=None, return_intermediates: bool = True) -> torch.Tensor:
    """DDIM inversion: clean latents -> the noised trajectory over the
    first `num_steps` grid points, one UNet call each (reference
    motion_prior_sample.py:27-37). Returns the stacked latents after each
    step (num_steps, B, ...) in f32, or the last."""
    b = latents.shape[0]
    lat = latents.float()
    inter: Optional[List[torch.Tensor]] = [] if return_intermediates else None
    for i in range(num_steps):
        ts = solver.ddim_timesteps[i].expand(b)
        eps = unet(lat, ts, ctx, fps=fps).float()
        lat = solver.ddim_reverse_step(lat, eps, ts)
        if inter is not None:
            inter.append(lat)
    return torch.stack(inter) if inter is not None else lat
