"""The port's v1 LoRA LCD training (training/, apps/train_v1.py) against the
JAX package's, on the CPU.

One LCD step through the tiny UNet of tests/tinymodels.py: the JAX loss and
its gradient with respect to the LoRA factors (`jax.value_and_grad` of
`lcd_loss` with `merge_lora`, one compile) against the port's `lcd_loss`
fed the JAX package's own draws, recomputed from its key as `lcd_loss`
splits it (t2v_turbo_tpu/training/lcd.py:86-109). Weights and factors come
from seeded numpy, the `up` factors non-zero so both factors get gradients.
The trainer (steps, checkpoint rotation, resume) and the CLI are in
tests/test_torch_trainer.py, so that xdist runs them beside this file's
JAX compile.

Tolerances (f32): the loss to 1e-5 relative; each factor gradient to
1e-3 x its largest entry (the UNet's f32 sums run in another order in the
two frameworks, PARITY.md's 2e-4 on its outputs, and the gradient of a
Huber loss amplifies that where |pred - target| is small), with a floor of f32
round-off, 1e-7 x the largest gradient of all; remat on and off agree to
1e-6 x their largest entry (the same ops recomputed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu import diffusion as J
from t2v_turbo_tpu import lora as jlora
from t2v_turbo_tpu.training.lcd import LCDConfig as JLCDConfig
from t2v_turbo_tpu.training.lcd import lcd_loss as jlcd_loss
from t2v_turbo_tpu_torch import diffusion as P
from t2v_turbo_tpu_torch import lora as L
from t2v_turbo_tpu_torch.io import convert
from t2v_turbo_tpu_torch.models import UNetModel
from t2v_turbo_tpu_torch.training.lcd import LCDConfig, lcd_loss
from torch_parity import assert_lora_grads_close, jax_lcd_draws, lcd_unet_pair, seeded_lora_factors

RANK, B = 4, 2


@pytest.fixture(scope="module")
def lcd_case():
    (student, jstudent, sp), (teacher, jteacher, tp) = lcd_unet_pair(10)
    factors = seeded_lora_factors(student, 12, RANK)
    rng = np.random.RandomState(13)
    batch = {
        "latents": rng.randn(B, 4, 8, 8, 4).astype(np.float32),
        "ctx": rng.randn(B, 7, 16).astype(np.float32),
        "uncond_ctx": np.zeros((B, 7, 16), np.float32),
        "fps": np.full((B,), 16.0, np.float32),
    }
    jsched = J.DiffusionSchedule.create()
    jsolver = J.DDIMSolver.create(np.asarray(jsched.alphas_cumprod))
    jcfg = JLCDConfig(w_embedding_dim=8)
    key = jax.random.PRNGKey(3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(lf):
        return jlcd_loss(
            lf, jbatch, key,
            student_apply=lambda l_, z, t, c, fps=None, timestep_cond=None: jstudent.apply(
                jlora.merge_lora(sp, l_), z, t, c, fps=fps, timestep_cond=timestep_cond),
            teacher_apply=lambda p, z, t, c, fps=None: jteacher.apply(p, z, t, c, fps=fps),
            teacher_params=tp, sched=jsched, solver=jsolver, cfg=jcfg,
        )[0]

    lora_flat = {k: {n: jnp.asarray(a) for n, a in f.items()}
                 for k, f in convert.lora_to_jax(factors).items()}
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss))(lora_flat)
    draws = jax_lcd_draws(key, jcfg, batch["latents"].shape)
    return dict(student=student, teacher=teacher, factors=factors, batch=batch, draws=draws,
                ref_loss=float(ref_loss), ref_grads=ref_grads)


def _port_step(case, use_remat):
    student = case["student"]
    model = UNetModel(student.cfg, use_remat=use_remat)
    model.load_state_dict(student.state_dict(), strict=True)
    L.apply_lora(model, {n: {k: t.clone() for k, t in f.items()} for n, f in case["factors"].items()})
    sched = P.DiffusionSchedule.create()
    solver = P.DDIMSolver.create(sched.alphas_cumprod.numpy())
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    loss, metrics = lcd_loss(model, case["teacher"], batch, case["draws"], sched=sched, solver=solver,
                             cfg=LCDConfig(w_embedding_dim=8))
    factors = L.lora_factors(model)
    names = sorted(factors)
    params = [factors[n][k] for n in names for k in ("down", "up")]
    grads = torch.autograd.grad(loss, params)
    gf = {n: {"down": grads[2 * i], "up": grads[2 * i + 1]} for i, n in enumerate(names)}
    return float(loss.detach()), gf


@pytest.mark.parametrize("use_remat", [False, True], ids=["no_remat", "remat"])
def test_lcd_step_matches_jax_value_and_grad(lcd_case, use_remat):
    loss, grads = _port_step(lcd_case, use_remat)
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(loss, lcd_case["ref_loss"], rtol=1e-5)
    assert_lora_grads_close(convert.lora_to_jax(grads), lcd_case["ref_grads"])


def test_remat_recomputes_the_same_step(lcd_case):
    loss0, g0 = _port_step(lcd_case, False)
    loss1, g1 = _port_step(lcd_case, True)
    assert loss0 == pytest.approx(loss1, rel=1e-6)
    for n in g0:
        for k in ("down", "up"):
            a, b = g0[n][k], g1[n][k]
            torch.testing.assert_close(b, a, atol=1e-6 * float(a.abs().max()) + 1e-12, rtol=0)
