"""The port's v1 LoRA LCD training (training/, apps/train_v1.py) against the
JAX package's, on the CPU.

One LCD step through the tiny UNet of tests/tinymodels.py: the JAX loss and
its gradient with respect to the LoRA factors (`jax.value_and_grad` of
`lcd_loss` with `merge_lora`, one compile) against the port's `lcd_loss`
fed the JAX package's own draws, recomputed from its key as `lcd_loss`
splits it (t2v_turbo_tpu/training/lcd.py:86-109). Weights and factors come
from seeded numpy, the `up` factors non-zero so both factors get gradients.
Then the trainer (steps, checkpoint rotation, resume) and the CLI.

Tolerances (f32): the loss to 1e-5 relative; each factor gradient to
1e-3 x its largest entry (the UNet's f32 sums run in another order in the
two frameworks, PARITY.md's 2e-4 on its outputs, and the gradient of a
Huber loss amplifies that where |pred - target| is small), with a floor of f32
round-off, 1e-7 x the largest gradient of all; remat on and off agree to
1e-6 x their largest entry (the same ops recomputed).
"""

import os

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
from t2v_turbo_tpu_torch.apps import train_v1
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


def _tiny_args(out_dir, *extra):
    return train_v1.parse_args(["--tiny-model", "--synthetic-data", "--random-weights", "--device", "cpu",
                                "--output-dir", str(out_dir), "--lora-rank", "4", *extra])


def test_trainer_checkpoints_resume_and_isolation(tmp_path):
    args = _tiny_args(tmp_path, "--max-steps", "4", "--checkpointing-steps", "2",
                      "--checkpoints-total-limit", "2", "--learning-rate", "1e-3")
    trainer, data, _ = train_v1.build_trainer(args)
    base0 = {k: v.clone() for k, v in L.base_state_dict(trainer.student).items()}
    teacher0 = {k: v.clone() for k, v in trainer.teacher.state_dict().items()}
    fac0 = {n: {k: t.detach().clone() for k, t in f.items()} for n, f in trainer.factors.items()}
    assert all(float(f["up"].abs().max()) == 0 for f in fac0.values())
    metrics = trainer.run(data)
    assert metrics["step"] == 4 and np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    assert [s for s, _ in trainer._checkpoints()] == [2, 4]
    rows = [l for l in open(os.path.join(tmp_path, "metrics.jsonl"))]
    assert len(rows) == 4 and all('"time_per_step_s"' in r and '"data_wait_frac"' in r for r in rows)
    base1 = L.base_state_dict(trainer.student)
    assert all(torch.equal(base1[k], base0[k]) for k in base0)  # the base is frozen
    assert all(torch.equal(v, teacher0[k]) for k, v in trainer.teacher.state_dict().items())
    for n, f in trainer.factors.items():  # every factor moved
        assert not torch.equal(f["up"], fac0[n]["up"]) and not torch.equal(f["down"], fac0[n]["down"]), n

    resumed, data2, _ = train_v1.build_trainer(
        _tiny_args(tmp_path, "--max-steps", "5", "--checkpointing-steps", "2",
                   "--checkpoints-total-limit", "2"))
    assert resumed.resume_if_available() == 4
    for n, f in trainer.factors.items():
        for k in ("down", "up"):
            assert torch.equal(resumed.factors[n][k], f[k])
    assert resumed.optimizer.count == trainer.optimizer.count == 4
    assert resumed.run(data2)["step"] == 5
    assert [s for s, _ in resumed._checkpoints()] == [4, 5]
    # export: base + collapsed factors
    merged = resumed.export_student_params()
    assert set(merged) == set(base0)


def test_trainer_with_remat_takes_the_same_steps(tmp_path):
    """--use-remat recomputes the blocks in the backward, reading the step's
    merged weights: the same losses and factors as without it."""
    runs = []
    for remat in (False, True):
        args = _tiny_args(tmp_path / str(remat), "--max-steps", "2", *(["--use-remat"] if remat else []))
        trainer, data, _ = train_v1.build_trainer(args)
        losses = [float(trainer.step_once(next(data))["loss"]) for _ in range(2)]
        runs.append((losses, trainer.flat.clone()))
    assert runs[1][0] == pytest.approx(runs[0][0], rel=1e-6)
    torch.testing.assert_close(runs[1][1], runs[0][1], atol=1e-7, rtol=0)


def test_grad_accumulation_updates_every_k_micro_steps(tmp_path):
    args = _tiny_args(tmp_path, "--max-steps", "3", "--gradient-accumulation-steps", "2",
                      "--checkpointing-steps", "100")
    trainer, data, _ = train_v1.build_trainer(args)
    snap = lambda: [p.detach().clone() for p in trainer.params]
    p0 = snap()
    trainer.step_once(next(data))
    assert trainer.optimizer.count == 0 and all(torch.equal(a, b) for a, b in zip(p0, snap()))
    trainer.step_once(next(data))
    assert trainer.optimizer.count == 1 and any(not torch.equal(a, b) for a, b in zip(p0, snap()))


def test_cli_trains_and_exports(tmp_path):
    from t2v_turbo_tpu.lora import load_lora_npz as jax_load_npz

    train_v1.main(["--tiny-model", "--synthetic-data", "--random-weights", "--max-steps", "2",
                   "--device", "cpu", "--output-dir", str(tmp_path)])
    assert os.path.exists(tmp_path / "checkpoints" / "step_00000002.pt")
    flat = jax_load_npz(str(tmp_path / "unet_lora.npz"))
    weights = torch.load(tmp_path / "unet_lora.pt", weights_only=True)
    assert len(weights) == 2 * len(flat) == 2 * 248
    assert weights[1].shape[0] == 64  # rank 64 down factor first pair (up, down)
