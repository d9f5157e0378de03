"""T2V-Turbo-v2's training in the port (training/lcd_v2.py, optim.py's v2
groups, trainer.py's full-model mode) against the JAX package's, on the CPU,
in f32, through a one-level tiny motion-conditioned UNet (a shorter JAX
compile) with one no-zero weight set.

- `lcd_v2_loss` and its gradient with respect to every UNet parameter
  against `jax.value_and_grad` of JAX's (one compile, the target's params an
  argument): with the EMA target network and without it (JAX's `None` is
  the student under stop_gradient, the same function at the student's
  params), in a batch whose motion gate is on for one sample and off for
  the other two (index out of the band; no motion prior), with a reward
  term behind a mask. Loss 1e-5 relative; each gradient within 1e-3 x its
  largest entry, floored at 1e-7 x the largest of all (the tiny UNet's
  embedding paths have a zero gradient in exact math: PARITY.md's 2e-4 on
  the outputs, and the Huber loss amplifies it where |pred - target| is
  small).
- the v2 temporal group: the same parameters as JAX's `is_temporal_param`
  after the block-index shift; one grouped update of the trainer against
  JAX's `make_v2_optimizer` to 1e-6.
- the full-model trainer: working weights refreshed from the master, the
  EMA once per optimizer update under gradient accumulation and the
  target's weights equal to it, checkpoint and resume (equal bits), bf16
  gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from t2v_turbo_tpu import diffusion as J
from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
from t2v_turbo_tpu.models import UNetModel as JUNet
from t2v_turbo_tpu.training import optim as joptim
from t2v_turbo_tpu.training.lcd_v2 import LCDV2Config as JLCDV2Config
from t2v_turbo_tpu.training.lcd_v2 import lcd_v2_loss as jlcd_v2_loss
from t2v_turbo_tpu_torch import diffusion as P
from t2v_turbo_tpu_torch.io import convert
from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel
from t2v_turbo_tpu_torch.training import lcd_v2, optim
from t2v_turbo_tpu_torch.training.trainer import LCDTrainer, TrainerConfig
from torch_parity import TINY_UNET_KW, seeded_numpy_state_dict, to_torch

KW = dict(TINY_UNET_KW, motion_cond_proj_dim=8, channel_mult=(1,), attention_resolutions=(1,))  # one level
CFG = dict(w_embedding_dim=8, use_motion_cond=True, motion_gs=0.5, reward_scale=0.3)


def v2_batch(seed=80, b=3):
    rng = np.random.RandomState(seed)
    shape = (b, 4, 8, 8, 4)
    return {
        "index": np.array([45, 10, 40][:b], np.int32),  # in the band, out of it, in it without a prior
        "z_t": rng.randn(*shape).astype(np.float32),
        "cond_teacher_out": rng.randn(*shape).astype(np.float32),
        "uncond_teacher_out": rng.randn(*shape).astype(np.float32),
        "score": rng.randn(*shape).astype(np.float32),
        "prompt_emb": rng.randn(b, 7, 16).astype(np.float32),
        "use_motion_guide": np.array([True, True, False][:b]),
        "reward_mask": np.array([1.0, 0.0, 1.0][:b], np.float32),
    }


def reward(model_pred, batch):
    """A reward with a gradient: the mean of each sample's prediction."""
    return model_pred.mean(axis=(1, 2, 3, 4)) if isinstance(model_pred, jax.Array) else \
        model_pred.mean(dim=(1, 2, 3, 4))


@pytest.fixture(scope="module")
def case():
    student = UNetModel(UNetConfig(**KW))
    sd = seeded_numpy_state_dict(student, 81)
    student.load_state_dict(to_torch(sd), strict=True)
    ema_sd = seeded_numpy_state_dict(student, 82)
    target = UNetModel(UNetConfig(**KW))
    target.load_state_dict(to_torch(ema_sd), strict=True)
    jcfg = JUNetConfig(**KW)
    junet = JUNet(cfg=jcfg)
    sp, tp = ({"params": ti.import_unet_params(d, jcfg)} for d in (sd, ema_sd))
    batch = v2_batch()
    jsched = J.DiffusionSchedule.create()
    jsolver = J.DDIMSolver.create(np.asarray(jsched.alphas_cumprod))
    key = jax.random.PRNGKey(9)

    def apply(p, z, t, c, fps=None, timestep_cond=None, motion_cond=None):
        return junet.apply(p, z, t, c, fps=fps, timestep_cond=timestep_cond, motion_cond=motion_cond)

    def loss(s, t):
        return jlcd_v2_loss(s, {k: jnp.asarray(v) for k, v in batch.items()}, key, student_apply=apply,
                            target_params=t, target_apply=apply, sched=jsched, solver=jsolver,
                            cfg=JLCDV2Config(**CFG), reward_fn=reward)[0]

    grad_fn = jax.jit(jax.value_and_grad(loss))
    refs = {"ema": grad_fn(sp, tp), "none": grad_fn(sp, sp)}
    k_w, _ = jax.random.split(key)
    w = np.asarray(5.0 + 10.0 * jax.random.uniform(k_w, (3,)))
    return dict(student=student, target=target, batch=batch, refs=refs, w=w)


@pytest.mark.parametrize("target", ["ema", "none"])
def test_lcd_v2_loss_and_gradients_match_jax(case, target):
    student = case["student"]
    sched = P.DiffusionSchedule.create()
    solver = P.DDIMSolver.create(sched.alphas_cumprod.numpy())
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    draws = lcd_v2.LCDV2Draws(torch.tensor(case["w"]))
    loss, terms = lcd_v2.lcd_v2_loss(student, batch, draws, target=case["target"] if target == "ema" else None,
                                     sched=sched, solver=solver, cfg=lcd_v2.LCDV2Config(**CFG), reward_fn=reward)
    names = [n for n, _ in student.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in student.named_parameters()], allow_unused=True,
                                materialize_grads=True)
    ref_loss, ref_grads = case["refs"][target]
    assert set(terms) == {"distill_loss", "reward_loss", "loss"}
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    ref = convert.unet_state_dict_from_jax(ref_grads)
    assert set(ref) == set(names)
    gmax = max(float(v.abs().max()) for v in ref.values())
    for n, g in zip(names, grads):
        r = ref[n].numpy()
        np.testing.assert_allclose(g.numpy(), r, atol=max(1e-3 * float(np.abs(r).max()), 1e-7 * gmax), err_msg=n)
    assert all(p.grad is None for p in case["target"].parameters())


def test_motion_gate_and_quirk_factor():
    """The gate: a motion prior and index >= (1 - percentage) * N; the score
    enters x_prev scaled by motion_gs * sqrt(1 - sqrt(alpha_bar))."""
    cfg = lcd_v2.LCDV2Config(motion_gs=0.5)
    batch = {k: torch.from_numpy(v) for k, v in v2_batch(b=3).items()}
    assert lcd_v2.motion_gate(batch, cfg).tolist() == [True, False, False]
    assert lcd_v2.motion_gate({"index": torch.tensor([34, 35])}, cfg).tolist() == [False, True]
    sched = P.DiffusionSchedule.create()
    solver = P.DDIMSolver.create(sched.alphas_cumprod.numpy())
    seen = []

    def student(x, t, ctx, **kw):
        seen.append(kw["motion_cond"])
        return torch.zeros_like(x)

    draws = lcd_v2.LCDV2Draws(torch.full((3,), 7.0))
    out = {}
    for scale in (0.0, 1.0):
        b = dict(batch, score=batch["score"] * scale)
        seen.clear()
        loss, _ = lcd_v2.lcd_v2_loss(student, b, draws, sched=sched, solver=solver,
                                     cfg=lcd_v2.LCDV2Config(motion_gs=0.5, use_motion_cond=True, loss_type="l2"))
        out[scale] = float(loss)
    # the motion embedding: motion_gs where gated, 0 elsewhere
    want = P.guidance_scale_embedding(torch.tensor([0.5, 0.0, 0.0]), 256)
    torch.testing.assert_close(seen[0], want)
    assert out[0.0] != out[1.0]


def test_temporal_group_matches_jax_labels():
    cfg = JUNetConfig(**KW)
    params = ti.import_unet_params(seeded_numpy_state_dict(UNetModel(UNetConfig(**KW)), 83), cfg)
    marks = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(np.shape(leaf), float(joptim.is_temporal_param(path)), np.float32), params)
    want = convert.unet_state_dict_from_jax({"params": marks})
    assert set(want) == {n for n, _ in UNetModel(UNetConfig(**KW)).named_parameters()}
    for name, mark in want.items():
        assert optim.is_temporal_param(name) == bool(mark.flatten()[0]), name
        assert optim.v2_param_label(name) == ("temporal" if mark.flatten()[0] else "base")
    assert any(optim.is_temporal_param(n) for n in want) and not all(optim.is_temporal_param(n) for n in want)
    assert optim.is_temporal_param("input_blocks.1.2.proj_in.weight")  # JAX input_blocks_0_2
    assert not optim.is_temporal_param("input_blocks.1.1.proj_in.weight")


class GradOf:
    """A loss hook whose gradient is G exactly: sum(p * G) over the student."""

    def __init__(self, grads):
        self.grads = grads

    def __call__(self, trainer, batch, draws):
        loss = sum((p * self.grads[n]).sum() for n, p in trainer.student.named_parameters())
        return loss, {"distill_loss": loss, "loss": loss}


def _full_trainer(tmp_path, student, **kw):
    cfg = dict(output_dir=str(tmp_path), lora_rank=None, max_grad_norm=1e9, log_every=1)
    cfg.update(kw.pop("cfg", {}))
    sched = P.DiffusionSchedule.create()
    return LCDTrainer(student=student, sched=sched, solver=P.DDIMSolver.create(sched.alphas_cumprod.numpy()),
                      lcd_cfg=lcd_v2.LCDV2Config(**CFG), cfg=TrainerConfig(**cfg),
                      param_label=optim.v2_param_label, **kw)


def test_one_grouped_update_matches_jax(tmp_path):
    student = UNetModel(UNetConfig(**KW))
    sd = seeded_numpy_state_dict(student, 84)
    student.load_state_dict(to_torch(sd), strict=True)
    rng = np.random.RandomState(85)
    g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in sd.items()}
    trainer = _full_trainer(tmp_path, student, loss_fn=GradOf(to_torch(g)), draws_fn=lambda *_: None,
                            optimizer=functools.partial(optim.make_v2_optimizer, name="adamw", learning_rate=1e-3,
                                                        temporal_learning_rate=1e-2))
    assert set(trainer.optimizers) == {"base", "temporal"}
    trainer.train_step({}, None)
    cfg = JUNetConfig(**KW)
    params, grads = (ti.import_unet_params(d, cfg) for d in (sd, g))
    tx = joptim.make_v2_optimizer("adamw", 1e-3, temporal_learning_rate=1e-2)
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    want = convert.unet_state_dict_from_jax(optax.apply_updates(params, updates))
    got = trainer.export_student_params()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
    # the module's weights are the working copy (f32 on the CPU) and the norms' the master itself
    for n, p in student.named_parameters():
        torch.testing.assert_close(p.detach(), got[n], rtol=0, atol=0)
    norm = student.get_parameter("out.0.weight")
    assert norm.data_ptr() == got["out.0.weight"].data_ptr()


def test_ema_once_per_update_and_target_weights(tmp_path):
    student = UNetModel(UNetConfig(**KW))
    student.load_state_dict(to_torch(seeded_numpy_state_dict(student, 86)), strict=True)
    rng = np.random.RandomState(87)
    g = {n: torch.from_numpy(rng.randn(*p.shape).astype(np.float32)) for n, p in student.named_parameters()}
    trainer = _full_trainer(tmp_path, student, loss_fn=GradOf(g), draws_fn=lambda *_: None,
                            optimizer=functools.partial(optim.make_v2_optimizer, name="adamw8bit",
                                                        learning_rate=1e-3),
                            cfg=dict(ema_decay=0.9, grad_accum_steps=2))
    ema0, master0 = trainer.ema.clone(), trainer.master.clone()
    torch.testing.assert_close(ema0, master0, rtol=0, atol=0)
    trainer.train_step({}, None)  # micro-step 1: no update
    torch.testing.assert_close(trainer.master, master0, rtol=0, atol=0)
    torch.testing.assert_close(trainer.ema, ema0, rtol=0, atol=0)
    trainer.train_step({}, None)  # micro-step 2: one update, one EMA step
    assert not torch.equal(trainer.master, master0)
    torch.testing.assert_close(trainer.ema, 0.9 * ema0 + 0.1 * trainer.master, rtol=1e-6, atol=1e-7)
    fresh = UNetModel(UNetConfig(**KW))
    fresh.load_state_dict(trainer.state_dict_of(trainer.ema), strict=True)
    x, ctx = torch.randn(1, 4, 8, 8, 4), torch.randn(1, 7, 16)
    kw = dict(timestep_cond=torch.randn(1, 8), motion_cond=torch.randn(1, 8))
    with torch.no_grad():
        torch.testing.assert_close(trainer.target(x, torch.tensor([500]), ctx, **kw),
                                   fresh(x, torch.tensor([500]), ctx, **kw), rtol=0, atol=0)
    assert not any(p.requires_grad for p in trainer.target.parameters())


def _v2_trainer(tmp_path, **cfg):
    student = UNetModel(UNetConfig(**KW))
    student.load_state_dict(to_torch(seeded_numpy_state_dict(student, 88)), strict=True)
    return _full_trainer(tmp_path, student, loss_fn=lcd_v2.trainer_loss, draws_fn=lcd_v2.trainer_draws,
                         optimizer=functools.partial(optim.make_v2_optimizer, name="adamw8bit", learning_rate=1e-3,
                                                     temporal_learning_rate=3e-3),
                         cfg=dict(ema_decay=0.95, checkpoint_every=2, max_steps=4, max_grad_norm=10.0, **cfg))


def _batches():
    while True:
        yield v2_batch(89, b=2)


def test_full_model_checkpoint_and_resume(tmp_path):
    """A checkpoint holds the master, the moments, the EMA and the step; a
    new trainer resumes them to the bit (its working copy and target
    refreshed) and goes on; the resumed run's draws do not replay the first
    steps' (trainer.draws_seed)."""
    first = _v2_trainer(tmp_path)
    metrics = first.run(_batches(), max_steps=2)
    assert metrics["step"] == 2 and np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    resumed = _v2_trainer(tmp_path)
    assert not torch.equal(resumed.master, first.master)
    assert resumed.resume_if_available() == 2
    for a, b in ((first.master, resumed.master), (first.ema, resumed.ema), (first.working, resumed.working),
                 (first.target_working, resumed.target_working)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for lb in ("base", "temporal"):
        o1, o2 = first.optimizers[lb], resumed.optimizers[lb]
        assert o1.count == o2.count == 2
        for a, b in zip(o1.mu + o1.nu, o2.mu + o2.nu):
            for x, y in zip(a, b):
                torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert resumed.run(_batches())["step"] == 4
    assert [s for s, _ in resumed._checkpoints()] == [2, 4]
    assert not torch.equal(resumed.master, first.master)


def test_bf16_gradients(tmp_path):
    trainer = _v2_trainer(tmp_path, grads_bf16=True)
    metrics = trainer.step_once(v2_batch(90, b=2))
    assert trainer._grad_flat.dtype == torch.bfloat16 and float(metrics["grad_norm"]) > 0
    with pytest.raises(ValueError, match="bf16"):
        _v2_trainer(tmp_path / "k", grads_bf16=True, grad_accum_steps=2)
