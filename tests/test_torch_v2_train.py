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
  small). The same loss and gradients at (data, seq) = (1, 2), on two gloo
  ranks (tests/torch_dist_worker.py's `v2_loss`, started by the fixture so
  they run while JAX compiles), summed over the ranks, against the same
  JAX references at the same tolerances.
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
import torch_dist_worker as W
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
def case(tmp_path_factory):
    """JAX's loss and gradients with the EMA target and without; the (1, 2)
    ranks start before JAX compiles."""
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
    k_w, _ = jax.random.split(key)
    w = np.asarray(5.0 + 10.0 * jax.random.uniform(k_w, (3,)))
    ranks_dir = tmp_path_factory.mktemp("v2_loss")
    W.write_inputs(ranks_dir, {"unet": KW, "lcd": CFG}, w=w, **{f"batch.{k}": v for k, v in batch.items()},
                   **{f"student.{k}": v for k, v in sd.items()}, **{f"target.{k}": v for k, v in ema_sd.items()})
    ranks = W.start_ranks("v2_loss", 2, ranks_dir)

    def apply(p, z, t, c, fps=None, timestep_cond=None, motion_cond=None):
        return junet.apply(p, z, t, c, fps=fps, timestep_cond=timestep_cond, motion_cond=motion_cond)

    def loss(s, t):
        return jlcd_v2_loss(s, {k: jnp.asarray(v) for k, v in batch.items()}, key, student_apply=apply,
                            target_params=t, target_apply=apply, sched=jsched, solver=jsolver,
                            cfg=JLCDV2Config(**CFG), reward_fn=reward)[0]

    try:
        grad_fn = jax.jit(jax.value_and_grad(loss))
        refs = {"ema": grad_fn(sp, tp), "none": grad_fn(sp, sp)}
        yield dict(student=student, target=target, batch=batch, refs=refs, w=w, ranks=ranks, ranks_dir=ranks_dir)
    finally:  # nothing left running after a failure
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()


def _close_to_jax(names, got, loss, ref_loss, ref_grads):
    """The loss to 1e-5 relative; each gradient within 1e-3 x its largest
    entry, floored at 1e-7 x the largest of all."""
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    ref = convert.unet_state_dict_from_jax(ref_grads)
    assert set(ref) == set(names)
    gmax = max(float(v.abs().max()) for v in ref.values())
    for n, g in zip(names, got):
        r = ref[n].numpy()
        np.testing.assert_allclose(np.asarray(g), r, atol=max(1e-3 * float(np.abs(r).max()), 1e-7 * gmax), err_msg=n)


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
    assert set(terms) == {"distill_loss", "reward_loss", "loss"}
    _close_to_jax(names, [g.numpy() for g in grads], loss.detach(), *case["refs"][target])
    assert all(p.grad is None for p in case["target"].parameters())


@pytest.fixture(scope="module")
def seq_ranks(case):
    codes, outs = W.finish(case["ranks"])
    assert codes == [0, 0], "v2_loss ranks failed:\n" + "\n".join(outs)
    return [W.read_report(case["ranks_dir"], r) for r in range(2)], np.load(case["ranks_dir"] / "arrays_0.npz")


@pytest.mark.parametrize("target", ["ema", "none"])
def test_lcd_v2_loss_and_gradients_at_1x2_match_jax(case, seq_ranks, target):
    """Each rank's share of the loss and its gradients, summed over the seq
    ranks, against JAX's whole-batch loss and gradients."""
    reports, arrays = seq_ranks
    assert all(r[target] == ["distill_loss", "loss", "reward_loss"] for r in reports)
    names = [n for n, _ in case["student"].named_parameters()]
    _close_to_jax(names, [arrays[f"{target}/{n}"] for n in names], arrays[f"{target}/loss"], *case["refs"][target])


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
    kw.setdefault("param_label", optim.v2_param_label)
    return LCDTrainer(student=student, sched=sched, solver=P.DDIMSolver.create(sched.alphas_cumprod.numpy()),
                      lcd_cfg=lcd_v2.LCDV2Config(**CFG), cfg=TrainerConfig(**cfg), **kw)


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


# --- the text encoder trained beside the UNet (--train-text-encoder) --------

TEXT_KW = dict(vocab_size=64, width=16, heads=4, layers=4, context_length=7)  # 3 blocks run
UNLOCKED = 2  # of the full tower's 4: block 2 of the 3 that run, and block 3, which does not


def _text_marks(tcfg_kw, unlocked, text_resblocks):
    """JAX's v2 labels of a text tower's leaves, as the port's state dict:
    {port key: label}."""
    from t2v_turbo_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig
    from t2v_turbo_tpu.models.clip_text import CLIPTextModel as JCLIPText

    jtext = JCLIPText(cfg=JCLIPTextConfig(**tcfg_kw))
    shapes = jax.eval_shape(lambda: jtext.init(jax.random.PRNGKey(0), jnp.zeros((1, tcfg_kw.get(
        "context_length", 77)), jnp.int32)))
    label = joptim.make_v2_label_fn(train_text_encoder=True, unlocked_text_layers=unlocked,
                                    text_resblocks=text_resblocks)
    names = ("frozen", "base")
    marks = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, float(names.index(label(
            (jax.tree_util.DictKey("text"),) + tuple(path)))), np.float32), shapes)
    sd = convert.clip_text_state_dict_from_jax(marks)
    return {k: "text" if v.flatten()[0] else "frozen" for k, v in sd.items()}


@pytest.mark.parametrize("tcfg_kw,unlocked", [(TEXT_KW, UNLOCKED), (TEXT_KW, 1), (TEXT_KW, 5),
                                              (dict(layers=24), 4)])
def test_text_labels_match_jax(tcfg_kw, unlocked):
    """Every text parameter's group is JAX's label (its "base" is the
    port's "text" group): ln_final and the last unlocked - 1 blocks that
    run train; the embeddings never do; at the full ViT-H tower blocks
    20-22."""
    from t2v_turbo_tpu_torch.models import CLIPTextConfig

    runs = CLIPTextConfig(**tcfg_kw).layers_run
    want = _text_marks(tcfg_kw, unlocked, runs)
    got = {k: optim.v2_param_label(optim.TEXT_PREFIX + k, unlocked, runs) for k in want}
    assert got == want
    assert want["token_embedding.weight"] == want["positional_embedding"] == "frozen"
    assert want["ln_final.weight"] == "text"
    if tcfg_kw == dict(layers=24):
        live = sorted({int(k.split(".")[2]) for k, v in want.items() if v == "text" and k.startswith("transformer")})
        assert live == [20, 21, 22]
    with pytest.raises(ValueError, match="frozen"):
        optim.make_v2_optimizer([torch.zeros(3)], "frozen")


@pytest.fixture(scope="module")
def text_case():
    """One v2 step with the text encoder trained, in JAX: the UNet and the
    tower's loss and gradients (JAX's pre-clip mask on the frozen leaves),
    the global norm, the clip, and make_v2_optimizer's update of the
    combined tree (eps 1: an update smooth in the gradient)."""
    from t2v_turbo_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig
    from t2v_turbo_tpu.models.clip_text import CLIPTextModel as JCLIPText
    from t2v_turbo_tpu_torch.models import CLIPTextConfig, CLIPTextModel

    student = UNetModel(UNetConfig(**KW))
    sd = seeded_numpy_state_dict(student, 91)
    text = CLIPTextModel(CLIPTextConfig(**TEXT_KW))
    tsd = seeded_numpy_state_dict(text, 92)
    jcfg = JUNetConfig(**KW)
    junet, jtext = JUNet(cfg=jcfg), JCLIPText(cfg=JCLIPTextConfig(**TEXT_KW))
    jt_params = ti.import_clip_text_params(tsd, layers=TEXT_KW["layers"])
    tree = {"unet": {"params": ti.import_unet_params(sd, jcfg)}, "text": {"params": jt_params}}
    batch = v2_batch(93)
    batch["tokens"] = np.random.RandomState(94).randint(1, 64, size=(3, 7)).astype(np.int32)
    jsched = J.DiffusionSchedule.create()
    jsolver = J.DDIMSolver.create(np.asarray(jsched.alphas_cumprod))
    key = jax.random.PRNGKey(95)
    runs = TEXT_KW["layers"] - 1
    label = joptim.make_v2_label_fn(train_text_encoder=True, unlocked_text_layers=UNLOCKED, text_resblocks=runs)

    def apply(p, z, t, c, fps=None, timestep_cond=None, motion_cond=None):
        return junet.apply(p, z, t, c, fps=fps, timestep_cond=timestep_cond, motion_cond=motion_cond)

    def loss(tr):
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        b["prompt_emb"] = jtext.apply(tr["text"], b["tokens"])
        return jlcd_v2_loss(tr["unet"], b, key, student_apply=apply, target_params=None, target_apply=apply,
                            sched=jsched, solver=jsolver, cfg=JLCDV2Config(**CFG), reward_fn=reward)[0]

    max_norm = 0.5
    tx = joptim.make_v2_optimizer("adamw", 1e-3, temporal_learning_rate=1e-2, train_text_encoder=True,
                                  unlocked_text_layers=UNLOCKED, text_resblocks=runs, eps=1.0)

    @jax.jit
    def step(tr):
        value, grads = jax.value_and_grad(loss)(tr)
        grads = jax.tree_util.tree_map_with_path(lambda p, g: jnp.zeros_like(g) if label(p) == "frozen" else g,
                                                 grads)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in jax.tree.leaves(grads)))
        scale = jnp.minimum(1.0, max_norm / (gnorm + 1e-6))
        updates, _ = tx.update(jax.tree.map(lambda g: g * scale, grads), tx.init(tr), tr)
        return value, grads, gnorm, optax.apply_updates(tr, updates)

    value, grads, gnorm, new = step(tree)
    k_w, _ = jax.random.split(key)
    return dict(sd=sd, tsd=tsd, batch=batch, loss=float(value), grads=grads, gnorm=float(gnorm), new=new,
                w=np.asarray(5.0 + 10.0 * jax.random.uniform(k_w, (3,))), max_norm=max_norm)


def test_text_encoder_step_matches_jax(tmp_path, text_case):
    """The port trainer's step with the text encoder: the loss, the
    gradient norm (the frozen text tensors, which keep no slot and no
    gradient, are out of it as JAX's masked ones), each trained tensor's
    gradient (1e-3 x its max, floored at 1e-7 x the largest of all) and the
    updated UNet and tower (lr x 1e-3 x max|g|: eps 1 makes the update
    smooth in g); the frozen tensors bitwise unchanged; the EMA over the
    UNet alone."""
    from t2v_turbo_tpu_torch.models import CLIPTextConfig, CLIPTextModel

    c = text_case
    student, text = UNetModel(UNetConfig(**KW)), CLIPTextModel(CLIPTextConfig(**TEXT_KW))
    student.load_state_dict(to_torch(c["sd"]), strict=True)
    text.load_state_dict(to_torch(c["tsd"]), strict=True)
    runs = TEXT_KW["layers"] - 1
    trainer = _full_trainer(
        tmp_path, student, loss_fn=lcd_v2.trainer_loss, draws_fn=lcd_v2.trainer_draws, text_encoder=text,
        param_label=functools.partial(optim.v2_param_label, unlocked_text_layers=UNLOCKED, text_resblocks=runs),
        optimizer=functools.partial(optim.make_v2_optimizer, name="adamw", learning_rate=1e-3,
                                    temporal_learning_rate=1e-2, eps=1.0),
        reward_fn=reward, cfg=dict(max_grad_norm=c["max_norm"], ema_decay=0.9))
    assert set(trainer.optimizers) == {"base", "temporal", "text"}
    frozen = {n: p.detach().clone() for n, p in text.named_parameters() if not p.requires_grad}
    live = sorted(n for n, p in text.named_parameters() if p.requires_grad)
    assert live == sorted(n[len(optim.TEXT_PREFIX):] for n in trainer.param_names if n.startswith(optim.TEXT_PREFIX))
    assert {n.split(".")[2] for n in live if n.startswith("transformer")} == {"2"} and "ln_final.weight" in live
    assert "token_embedding.weight" in frozen and not any(n.startswith("transformer.resblocks.2.") for n in frozen)
    slots = sum(p.numel() for opt in trainer.optimizers.values() for p in opt.params)
    assert slots == trainer.master.numel()  # frozen tensors: no master, no moments
    text_before = {k: v.clone() for k, v in trainer.text_state_dict().items()}
    ema0 = trainer.ema.clone()

    metrics = trainer.train_step({k: torch.from_numpy(np.asarray(v)) for k, v in c["batch"].items()},
                                 lcd_v2.LCDV2Draws(torch.tensor(c["w"])))
    assert float(metrics["loss"]) == pytest.approx(c["loss"], rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(c["gnorm"], rel=1e-4)
    assert c["gnorm"] > c["max_norm"]  # the clip acts
    jgrads = {**{optim.TEXT_PREFIX + k: v.numpy() for k, v in convert.clip_text_state_dict_from_jax(
        c["grads"]["text"]).items()}, **{k: v.numpy() for k, v in convert.unet_state_dict_from_jax(
            c["grads"]["unet"]).items()}}
    floor = 1e-7 * max(float(np.abs(g).max()) for g in jgrads.values())
    for name, g in zip(trainer.param_names, trainer._grad_views):
        want = jgrads[name]
        np.testing.assert_allclose(g.numpy(), want, atol=max(1e-3 * float(np.abs(want).max()), floor), err_msg=name)
    gmax = max(float(np.abs(g).max()) for g in jgrads.values())
    want_unet = convert.unet_state_dict_from_jax(c["new"]["unet"])
    want_text = convert.clip_text_state_dict_from_jax(c["new"]["text"])
    got_unet, got_text = trainer.export_student_params(), trainer.text_state_dict()
    for got, want in ((got_unet, want_unet), (got_text, want_text)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-3 * 1e-2 * gmax, err_msg=k)
    for n, v in frozen.items():
        assert torch.equal(text.get_parameter(n), v) and torch.equal(got_text[n], v.float()), n
    assert all(not torch.equal(got_text[n], text_before[n]) for n in live)
    # the EMA and the target network: the UNet's parameters alone
    assert set(trainer.state_dict_of(trainer.ema)) == {n for n, _ in student.named_parameters()}
    assert trainer.ema.numel() < trainer.master.numel()
    n = trainer.ema.numel()
    torch.testing.assert_close(trainer.ema, 0.9 * ema0 + 0.1 * trainer.master[:n], rtol=1e-6, atol=1e-7)


def test_zero_snr_and_use_scale_ddim_match_jax():
    """The zero-terminal-SNR betas (JAX's schedule option) and the VC2
    latent-scale DDIM step with eta > 0, the noise fed in, against JAX's,
    to f32 rounding; the generator draws the same step as the noise it
    draws; the inversion refuses use_scale, as JAX's."""
    jsched = J.DiffusionSchedule.create(rescale_betas_zero_snr=True)
    sched = P.DiffusionSchedule.create(rescale_betas_zero_snr=True)
    np.testing.assert_allclose(sched.alphas_cumprod.numpy(), np.asarray(jsched.alphas_cumprod), rtol=1e-6,
                               atol=1e-12)
    assert float(sched.alphas_cumprod[-1]) == 0.0 and float(sched.alphas_cumprod[0]) > 0.99
    np.testing.assert_allclose(P.schedule.rescale_zero_terminal_snr(np.linspace(1e-4, 2e-2, 100)),
                               J.schedule.rescale_zero_terminal_snr(np.linspace(1e-4, 2e-2, 100)), rtol=1e-12)
    ac = np.asarray(J.DiffusionSchedule.create().alphas_cumprod)
    kw = dict(ddim_timesteps=50, use_scale=True, ddim_eta=0.7, scale_b=0.7, mid_step=400)
    jsolver, solver = J.DDIMSolver.create(ac, **kw), P.DDIMSolver.create(ac, **kw)
    for f in ("ddim_scale_arr", "ddim_scale_arr_prev", "ddim_sigmas", "ddim_alpha_cumprods_prev"):
        np.testing.assert_allclose(getattr(solver, f).numpy(), np.asarray(getattr(jsolver, f)), rtol=1e-6, err_msg=f)
    assert float(solver.ddim_sigmas.max()) > 0 and float(solver.ddim_scale_arr.min()) < 1.0
    rng = np.random.RandomState(96)
    x0, eps, noise = (rng.randn(3, 4, 8, 8, 4).astype(np.float32) for _ in range(3))
    index = np.array([49, 20, 3], np.int32)
    want = np.asarray(jsolver.ddim_step(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(index), jnp.asarray(noise)))
    got = solver.ddim_step(torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(index).long(),
                           torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    no_noise = np.asarray(jsolver.ddim_step(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(index)))
    np.testing.assert_allclose(solver.ddim_step(torch.from_numpy(x0), torch.from_numpy(eps),
                                                torch.from_numpy(index).long()).numpy(), no_noise, rtol=1e-5,
                               atol=1e-5)
    drawn = torch.randn((3, 4, 8, 8, 4), generator=torch.Generator().manual_seed(7))
    by_gen = solver.ddim_step(torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(index).long(),
                              generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(by_gen, solver.ddim_step(torch.from_numpy(x0), torch.from_numpy(eps),
                                                        torch.from_numpy(index).long(), drawn), rtol=0, atol=0)
    with pytest.raises(ValueError, match="use_scale"):
        solver.ddim_reverse_step(torch.from_numpy(x0), torch.from_numpy(eps), torch.tensor([19, 19, 19]))
