"""The port's reward feedback (training/reward_adapters.py, the reward terms
of training/lcd.py, apps/train_v1.py's reward stack) against the JAX
package's, on the CPU.

- The VAE decode's gradient with respect to the latents against `jax.grad`
  of the JAX decode, and `chunked_decode` in checkpointed chunks against
  one call.
- One LCD step with both rewards through tests/tinymodels.py's UNet, the
  JAX CLI's tiny VAE and tests/test_rewards.py's tiny towers: the JAX loss
  and its LoRA gradients (`jax.value_and_grad` of `lcd_loss` with the JAX
  adapters' reward fns, one compile) against the port's `lcd_loss` with
  `make_reward_fns`, fed the same draws, frame indices, text features and
  masks. Decodes run in chunks of 2 frames on both sides.
- The CLI with both rewards (tests/test_torch_trainer.py).

Tolerances (f32): the decode's output 1e-5 and its gradient 1e-5 x its
largest entry (one chain of ops in another summation order); chunked
against one call 1e-5 x the largest entry (the same ops on fewer frames,
but the CPU's convolutions pick their kernels, and so their summation
order, by batch size);
the LCD step as tests/test_torch_training.py holds it (loss 1e-5 relative,
each LoRA gradient 1e-3 x its largest entry) and each reward term 1e-5
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu import diffusion as J
from t2v_turbo_tpu import lora as jlora
from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models.vae import AutoencoderKL as JVAE
from t2v_turbo_tpu.models.vae import VAEConfig as JVAEConfig
from t2v_turbo_tpu.training import reward_adapters as jra
from t2v_turbo_tpu.training.lcd import LCDConfig as JLCDConfig
from t2v_turbo_tpu.training.lcd import lcd_loss as jlcd_loss
from t2v_turbo_tpu_torch import diffusion as P
from t2v_turbo_tpu_torch import lora as L
from t2v_turbo_tpu_torch.io import convert
from t2v_turbo_tpu_torch.models import AutoencoderKL, VAEConfig
from t2v_turbo_tpu_torch.training.lcd import LCDConfig, lcd_loss
from t2v_turbo_tpu_torch.training.reward_adapters import chunked_decode, make_reward_fns, sample_frame_indices
from torch_parity import (TEXTS, TINY_VAE_KW, assert_lora_grads_close, jax_lcd_draws, lcd_unet_pair,
                          reward_model_pair, seeded_lora_factors, seeded_numpy_state_dict, to_torch)

RANK, B, T = 4, 2, 4


@pytest.fixture(scope="module")
def vae_pair():
    """(port tiny VAE, JAX tiny VAE, its params) on the same seeded weights."""
    port = AutoencoderKL(VAEConfig(**TINY_VAE_KW))
    sd = seeded_numpy_state_dict(port, 40)
    port.load_state_dict(to_torch(sd), strict=True)
    jvae = JVAE(cfg=JVAEConfig(**TINY_VAE_KW))
    return port, jvae, {"params": ti.import_vae_params(sd, n_levels=2, n_res=1)}


def test_vae_decode_gradient_matches_jax(vae_pair):
    port, jvae, params = vae_pair
    rng = np.random.RandomState(41)
    z = rng.randn(3, 8, 8, 4).astype(np.float32)
    w = rng.randn(3, 16, 16, 3).astype(np.float32)

    def jloss(zz):
        out = jvae.apply(params, zz, method=jvae.decode)
        return (out * w).sum(), out

    (_, ref_out), ref_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    out = port.decode(zt)
    (grad,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), zt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-5)
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(grad.numpy(), ref_grad, atol=1e-5 * float(np.abs(ref_grad).max()))


def test_chunked_decode_equals_one_call(vae_pair):
    port = vae_pair[0]
    rng = np.random.RandomState(42)
    z = rng.randn(5, 8, 8, 4).astype(np.float32)
    w = torch.from_numpy(rng.randn(5, 16, 16, 3).astype(np.float32))
    results = []
    for chunk in (None, 2):  # one call; chunks of 2, 2, 1 under checkpointing
        zt = torch.from_numpy(z).requires_grad_()
        out = chunked_decode(port, zt, chunk)
        results.append((out.detach(), torch.autograd.grad((out * w).sum(), zt)[0]))
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, atol=1e-5 * float(a.abs().max()), rtol=0)


@pytest.fixture(scope="module")
def reward_lcd_case(vae_pair):
    (student, jstudent, sp), (teacher, jteacher, tp) = lcd_unet_pair(10)
    factors = seeded_lora_factors(student, 12, RANK)
    vae, jvae, vae_params = vae_pair
    image_rm, _, jimage_rm = reward_model_pair(video=False)
    video_rm, _, jvideo_rm = reward_model_pair(video=True, num_frames=T)
    rng = np.random.RandomState(13)
    batch = {
        "latents": rng.randn(B, T, 8, 8, 4).astype(np.float32),
        "ctx": rng.randn(B, 7, 16).astype(np.float32),
        "uncond_ctx": np.zeros((B, 7, 16), np.float32),
        "fps": np.full((B,), 16.0, np.float32),
        "reward_frame_idx": sample_frame_indices(rng, B, T, 2),
        "reward_text_feats": image_rm.encode_texts(TEXTS[:B]).numpy(),
        "reward_mask": np.ones((B,), np.float32),
        "video_frame_idx": sample_frame_indices(rng, B, T, T, strided=True),
        "video_text_feats": video_rm.encode_texts(TEXTS[1:B + 1]).numpy(),
        "video_reward_mask": np.array([0.0, 1.0], np.float32),
    }
    jsched = J.DiffusionSchedule.create()
    jsolver = J.DDIMSolver.create(np.asarray(jsched.alphas_cumprod))
    jcfg = JLCDConfig(w_embedding_dim=8, reward_scale=1.0, video_reward_scale=2.0)
    key = jax.random.PRNGKey(3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(lf):
        return jlcd_loss(
            lf, jbatch, key,
            student_apply=lambda l_, z, t, c, fps=None, timestep_cond=None: jstudent.apply(
                jlora.merge_lora(sp, l_), z, t, c, fps=fps, timestep_cond=timestep_cond),
            teacher_apply=lambda p, z, t, c, fps=None: jteacher.apply(p, z, t, c, fps=fps),
            teacher_params=tp, sched=jsched, solver=jsolver, cfg=jcfg,
            reward_fn=jra.make_image_reward_fn(jvae, vae_params, jimage_rm, decode_chunk=2),
            video_reward_fn=jra.make_video_reward_fn(jvae, vae_params, jvideo_rm, decode_chunk=2),
        )

    lora_flat = {k: {n: jnp.asarray(a) for n, a in f.items()}
                 for k, f in convert.lora_to_jax(factors).items()}
    (ref_loss, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(lora_flat)
    return dict(student=student, teacher=teacher, factors=factors, batch=batch, vae=vae,
                image_rm=image_rm, video_rm=video_rm, draws=jax_lcd_draws(key, jcfg, batch["latents"].shape),
                ref_loss=float(ref_loss), ref_metrics={k: float(v) for k, v in ref_metrics.items()},
                ref_grads=ref_grads)


def test_reward_lcd_step_matches_jax_value_and_grad(reward_lcd_case):
    case = reward_lcd_case
    L.apply_lora(case["student"], {n: {k: t.clone() for k, t in f.items()} for n, f in case["factors"].items()})
    sched = P.DiffusionSchedule.create()
    rf, vrf = make_reward_fns(case["vae"], case["image_rm"], case["video_rm"], decode_chunk=2)
    loss, terms = lcd_loss(case["student"], case["teacher"], {k: torch.from_numpy(v) for k, v in case["batch"].items()},
                           case["draws"], sched=sched, solver=P.DDIMSolver.create(sched.alphas_cumprod.numpy()),
                           cfg=LCDConfig(w_embedding_dim=8, reward_scale=1.0, video_reward_scale=2.0),
                           reward_fn=rf, video_reward_fn=vrf)
    ref = case["ref_metrics"]
    for name in ("reward_loss", "video_rm_loss", "distill_loss"):
        assert ref[name] != 0
        np.testing.assert_allclose(float(terms[name]), ref[name], rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(loss), case["ref_loss"], rtol=1e-5)
    factors = L.lora_factors(case["student"])
    names = sorted(factors)
    grads = torch.autograd.grad(loss, [factors[n][k] for n in names for k in ("down", "up")])
    got = convert.lora_to_jax({n: {"down": grads[2 * i], "up": grads[2 * i + 1]} for i, n in enumerate(names)})
    assert_lora_grads_close(got, case["ref_grads"])
