"""MotionClone motion transfer and the DDIM inversion round trip in the port
(pipelines/motion_clone.py, apps/motion_sample.py, apps/inverse_ddim.py)
against the JAX package's, on the CPU, in f32, on shared weights, seeded
from numpy and converted by the JAX importer: the transfer on a one-level
cut of the CLIs' tiny teacher UNet (tests/test_preprocess_motionclone.py's;
one level keeps both output blocks' captured temporal attentions and halves
the JAX compile of the guided step), the CLIs on their own tiny UNet.

- motion_transfer_sample on a 10-point grid at percentage 0.3 (guided
  indices 9, 8, 7), with a reward gradient at reward_scale 0.5: the guided
  step count, the per-step rank loss to 1e-4 relative, the final latents to
  5e-4 x their largest entry (ten steps of CFG at 7.5 over UNet outputs
  held to PARITY.md's 2e-4; a guided step adds a gradient through the UNet,
  held to 1e-3 x its largest entry in test_torch_v2_motion.py);
- the band's float comparison at n = 50, p = 0.3: 15 guided steps;
- apps/motion_sample.py (at percentage 0: the draws, the inversion and
  the plain steps) and apps/inverse_ddim.py with --random-weights
  --tiny-model against the JAX mains on the same weights: the JAX CLIs
  init their UNet with flax and build the tiny config without fps
  conditioning, so the test hands them the port's weights (init patched)
  and the fps embedding the port's UNet always has (config patched); the
  latents to the tolerance above, `relative` to 1e-4 relative.
One JAX compile of each program (the guided and the plain step, the
inversion's resampling scan).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu import diffusion as J
from t2v_turbo_tpu.apps import inverse_ddim as jinverse
from t2v_turbo_tpu.apps import motion_sample as jmotion_sample
from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models import unet_vc2 as junet_mod
from t2v_turbo_tpu.pipelines import motion_clone as jmc
from t2v_turbo_tpu.utils import cache as jcache
from t2v_turbo_tpu_torch import diffusion as P
from t2v_turbo_tpu_torch.apps import inverse_ddim, motion_sample
from t2v_turbo_tpu_torch.models import UNetModel
from t2v_turbo_tpu_torch.pipelines import motion_clone as mc
from torch_parity import seeded_numpy_state_dict, to_torch


def _jax_cfg(cfg):
    return junet_mod.UNetConfig(**{f: getattr(cfg, f) for f in (
        "model_channels", "num_res_blocks", "attention_resolutions", "channel_mult", "num_head_channels",
        "context_dim")})


@pytest.fixture(scope="module")
def teacher():
    cfg = dataclasses.replace(motion_sample.tiny_unet_config(), channel_mult=(1,), attention_resolutions=(1,))
    port = UNetModel(cfg)
    sd = seeded_numpy_state_dict(port, 70)
    port.load_state_dict(to_torch(sd), strict=True)
    port.requires_grad_(False).eval()
    jcfg = _jax_cfg(cfg)
    return port, junet_mod.UNetModel(cfg=jcfg), {"params": ti.import_unet_params(sd, jcfg)}


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * float(np.abs(want).max()))


def test_band_is_jax_float_comparison():
    assert len(mc.guided_indices(mc.MotionCloneConfig(num_ddim_timesteps=50, percentage=0.3))) == 15
    assert mc.guided_indices(mc.MotionCloneConfig(num_ddim_timesteps=10, percentage=0.3)) == [9, 8, 7]


def test_motion_transfer_with_reward_matches_jax(teacher):
    port, junet, params = teacher
    rng = np.random.RandomState(71)
    ref = (0.2 * rng.randn(1, 4, 8, 8, 4)).astype(np.float32)
    ctx_o, ctx_i = (rng.randn(1, 7, 16).astype(np.float32) for _ in range(2))
    uncond = np.zeros_like(ctx_o)
    kw = dict(num_ddim_timesteps=10, percentage=0.3, temp_loss_scale=100.0, reward_scale=0.5)

    jsched = J.DiffusionSchedule.create()
    jsolver = J.DDIMSolver.create(np.asarray(jsched.alphas_cumprod), ddim_timesteps=10)
    jlat, jtrace = jmc.motion_transfer_sample(
        unet_apply=lambda p, z, ts, c, fps=None: junet.apply(p, z, ts, c, fps=fps),
        unet_apply_mutable=lambda p, z, ts, c, fps=None: junet.apply(
            p, z, ts, c, fps=fps, record_probs=True, mutable=["intermediates"]),
        params=params, ref_latents=jnp.asarray(ref), original_ctx=jnp.asarray(ctx_o),
        inference_ctx=jnp.asarray(ctx_i), uncond_ctx=jnp.asarray(uncond), sched=jsched, solver=jsolver,
        cfg=jmc.MotionCloneConfig(**kw), reward_grad_fn=lambda z, ts: 0.1 * jnp.sin(3.0 * z),
        return_trace=True)

    sched = P.DiffusionSchedule.create()
    solver = P.DDIMSolver.create(sched.alphas_cumprod.numpy(), ddim_timesteps=10)
    calls = []

    def reward_grad(z, ts):
        calls.append(int(ts[0]))
        return 0.1 * torch.sin(3.0 * z)

    lat, trace = mc.motion_transfer_sample(
        port, torch.from_numpy(ref), torch.from_numpy(ctx_o), torch.from_numpy(ctx_i), torch.from_numpy(uncond),
        sched, solver, mc.MotionCloneConfig(**kw), reward_grad_fn=reward_grad, return_trace=True)
    assert calls == [int(solver.ddim_timesteps[i]) for i in (9, 8, 7)]
    assert trace["motion_loss"].shape == (3,) == np.asarray(jtrace["motion_loss"]).shape
    np.testing.assert_allclose(trace["motion_loss"].numpy(), np.asarray(jtrace["motion_loss"]), rtol=1e-4)
    assert lat.dtype == torch.float32 and np.isfinite(lat.numpy()).all()
    _close(lat.numpy(), jlat, 5e-4)


@pytest.fixture
def jax_cli_on_port_weights(monkeypatch):
    """Hand the JAX CLIs the port CLI's seeded UNet: their flax init
    returns the imported weights and their tiny config keeps fps
    conditioning (the port's UNet always has it); no persistent cache."""
    def use(port_unet):
        sd = {k: v.detach().float().numpy() for k, v in port_unet.state_dict().items()}
        cfg = _jax_cfg(motion_sample.tiny_unet_config())
        params = {"params": ti.import_unet_params(sd, cfg)}
        real = junet_mod.UNetConfig
        monkeypatch.setattr(junet_mod, "UNetConfig", lambda **kw: real(**{**kw, "fps_cond": True}))
        monkeypatch.setattr(junet_mod.UNetModel, "init", lambda self, *a, **k: params)
        monkeypatch.setattr(jcache, "enable_persistent_cache", lambda *a, **k: None)
    return use


def test_motion_sample_cli_matches_jax(tmp_path, jax_cli_on_port_weights):
    # percentage 0: no guided step, so the JAX CLI compiles no second guided
    # program (the test above holds the guided step)
    argv = ["--random-weights", "--tiny-model", "--prompt", "a cat", "--num-ddim-timesteps", "10", "--seed", "3",
            "--percentage", "0"]
    port_out, jax_out = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    args = motion_sample.parse_args(argv + ["--device", "cpu", "--output", port_out])
    job = motion_sample.build_job(args)
    assert job.models.vae is None
    path = motion_sample.write_output(job, motion_sample.run(job), args)
    assert path == port_out + ".latents.npy"
    jax_cli_on_port_weights(job.models.unet)
    jmotion_sample.main(argv + ["--cpu", "--output", jax_out])
    got, want = np.load(path), np.load(jax_out + ".latents.npy")
    assert got.shape == want.shape == (1, 4, 8, 8, 4)
    _close(got, want, 5e-4)


def test_inverse_ddim_cli_matches_jax(jax_cli_on_port_weights, capsys):
    argv = ["--random-weights", "--tiny-model", "--num-ddim-timesteps", "10", "--invert-steps", "6", "--seed", "4"]
    job = inverse_ddim.build_job(inverse_ddim.parse_args(argv + ["--device", "cpu"]))
    z_rec, err = inverse_ddim.round_trip(job)
    assert z_rec.shape == job.z0.shape and err["rmse"] > 0
    assert err["relative"] == pytest.approx(err["rmse"] / float(job.z0.pow(2).mean().sqrt()))
    jax_cli_on_port_weights(job.models.unet)
    want = jinverse.main(argv + ["--cpu"])
    assert err["relative"] == pytest.approx(want, rel=1e-4)
    assert inverse_ddim.main(argv + ["--device", "cpu"]) == pytest.approx(err["relative"], rel=1e-6)
    assert f"relative={err['relative']:.4f}" in capsys.readouterr().out
