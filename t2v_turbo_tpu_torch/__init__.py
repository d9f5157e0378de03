"""t2v_turbo_tpu_torch: the T2V-Turbo VideoCrafter2 text-to-video path in
PyTorch, with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

It mirrors the layout of the JAX package `t2v_turbo_tpu`, which stays the
numerical reference: `ops/` (norms and attention, plain and kernel),
`diffusion/` (schedule, LCM math, scheduler), `models/` (VC2 UNet, VAE,
OpenCLIP text tower), `pipelines/`, `io/` (weight conversion), `utils/`
(tokenizer), `apps/` (the generate CLI) and `csrc/` (the CUDA sources).
It imports torch and never jax.
"""

__version__ = "0.1.0"
