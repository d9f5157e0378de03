"""t2v_turbo_tpu_torch: the T2V-Turbo VideoCrafter2 text-to-video path and
its v1 LoRA consistency-distillation trainer in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (sm_90a).

It mirrors the layout of the JAX package `t2v_turbo_tpu`, which stays the
numerical reference: `ops/` (norms and attention, plain and kernel, with
their autograd functions), `diffusion/` (schedule, LCM math, scheduler,
DDIM solver), `models/` (VC2 UNet, VAE, OpenCLIP text tower), `lora.py`,
`pipelines/`, `training/` (LCD loss, optimizers, trainer), `io/` (weight
and LoRA conversion, video writing), `utils/` (tokenizer), `apps/` (the
generate and train_v1 CLIs), `assets/` (the BPE vocabulary) and `csrc/`
(the CUDA sources). It imports torch, never jax, and reads nothing of the
JAX package.
"""

__version__ = "0.2.0"
