"""The port's diffusion math (t2v_turbo_tpu_torch/diffusion) against the JAX
package's, on the CPU (inference part). Tolerances: 1e-6 relative on the
f32 tables and scalings (same float64 tables cast to f32, same f32 formulas); the
sinusoidal embeddings take sines of arguments up to 1.2e4 rad, where one f32
ulp of the argument moves the sine by up to 1e-3, and are held to that."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu import diffusion as J
from t2v_turbo_tpu_torch import diffusion as P

RTOL = 1e-6


@pytest.mark.parametrize("num_timesteps", [1000, 100])
def test_schedule_tables(num_timesteps):
    js = J.DiffusionSchedule.create(num_timesteps=num_timesteps)
    ps = P.DiffusionSchedule.create(num_timesteps=num_timesteps)
    for name in ("alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_allclose(getattr(ps, name).numpy(), np.asarray(getattr(js, name)), rtol=RTOL)
    assert ps.num_timesteps == js.num_timesteps


def test_extract_broadcasts_right():
    ps = P.DiffusionSchedule.create()
    js = J.DiffusionSchedule.create()
    t = np.array([0, 500, 999])
    got = P.extract(ps.alphas_cumprod, torch.from_numpy(t), 5)
    ref = J.extract(js.alphas_cumprod, jnp.asarray(t), 5)
    assert tuple(got.shape) == (3, 1, 1, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    t = np.array([0.0, 1.0, 279.0, 999.0, 16.0], np.float32)
    ref = J.timestep_embedding(jnp.asarray(t), dim)
    got = P.timestep_embedding(torch.from_numpy(t), dim)
    # arguments reach 999 rad: one f32 ulp of the argument is 6e-5 of the sine
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("dim", [8, 256, 257])
def test_guidance_scale_embedding(dim):
    w = np.array([1.0, 7.5, 12.0], np.float32)
    ref = J.guidance_scale_embedding(jnp.asarray(w), dim)
    got = P.guidance_scale_embedding(torch.from_numpy(w), dim)
    # arguments reach 1.2e4 rad, so f32 sin/cos differ by a few ulp of the argument
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-3)


def test_boundary_scalings():
    for t in (0, 279, 519, 759, 999):
        ref = J.scalings_for_boundary_conditions(jnp.asarray(t))
        got = P.scalings_for_boundary_conditions(t)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(float(g), float(r), rtol=RTOL)


@pytest.mark.parametrize("ts", [(759, 279), (999, 0)])
def test_predicted_origin(ts):
    """The epsilon parameterisation, the only one the VC2 students use."""
    rng = np.random.RandomState(0)
    out, sample = (rng.randn(2, 3, 4, 4, 4).astype(np.float32) for _ in range(2))
    t = np.array(ts)
    js, ps = J.DiffusionSchedule.create(), P.DiffusionSchedule.create()
    ref = J.predicted_origin(jnp.asarray(out), jnp.asarray(t), jnp.asarray(sample), "epsilon", js)
    got = P.predicted_origin(torch.from_numpy(out), torch.from_numpy(t), torch.from_numpy(sample), ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("steps,origin", [(4, 50), (1, 50), (8, 50), (16, 200), (3, 25)])
def test_lcm_timesteps(steps, origin):
    np.testing.assert_array_equal(P.lcm_timesteps(steps, origin), J.lcm_timesteps(steps, origin))


def test_lcm_grid_of_the_main_path():
    assert P.lcm_timesteps(4).tolist() == [999, 759, 519, 279]


@pytest.mark.parametrize("with_noise", [False, True])
def test_lcm_scheduler_step(with_noise):
    rng = np.random.RandomState(1)
    eps, sample, noise = (rng.randn(1, 4, 4, 8, 4).astype(np.float32) for _ in range(3))
    js = J.LCMScheduler(schedule=J.DiffusionSchedule.create())
    ps = P.LCMScheduler(schedule=P.DiffusionSchedule.create())
    ref = js.step(jnp.asarray(eps), jnp.asarray(759), jnp.asarray(519), jnp.asarray(sample),
                  jnp.asarray(noise) if with_noise else None)
    got = ps.step(torch.from_numpy(eps), 759, 519, torch.from_numpy(sample),
                  torch.from_numpy(noise) if with_noise else None)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
