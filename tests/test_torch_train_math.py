"""The port's training math against the JAX package's, on the CPU: the DDIM
solver, forward diffusion, the parameterisation converters, the pseudo-Huber
loss, and the three AdamW moment variants against optax / the JAX package's
own optimizers over three steps on the same gradients.

Tolerances: 1e-6 relative on the f32 tables and elementwise math (same
float64 tables cast to f32, same f32 formulas); optimizers 1e-6 absolute on
parameters of O(1) after three steps of lr 1e-2 (f32 rounding in another
order; the int8 variant quantises the same values, so it agrees as well).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from t2v_turbo_tpu import diffusion as J
from t2v_turbo_tpu.diffusion import lcm as jlcm
from t2v_turbo_tpu.diffusion import schedule as jsched
from t2v_turbo_tpu.training import optim as joptim
from t2v_turbo_tpu_torch import diffusion as P
from t2v_turbo_tpu_torch.training import optim as poptim

RTOL = 1e-6


@pytest.fixture(scope="module")
def schedules():
    js = J.DiffusionSchedule.create()
    ps = P.DiffusionSchedule.create()
    return js, ps


@pytest.mark.parametrize("n", [50, 8])
def test_ddim_solver_tables_and_steps(schedules, n):
    js, ps = schedules
    jsol = J.DDIMSolver.create(np.asarray(js.alphas_cumprod), ddim_timesteps=n)
    psol = P.DDIMSolver.create(ps.alphas_cumprod.numpy(), ddim_timesteps=n)
    assert psol.step_ratio == jsol.step_ratio
    np.testing.assert_array_equal(psol.ddim_timesteps.numpy(), np.asarray(jsol.ddim_timesteps))
    for name in ("alpha_cumprods", "ddim_alpha_cumprods", "ddim_alpha_cumprods_prev"):
        np.testing.assert_allclose(getattr(psol, name).numpy(), np.asarray(getattr(jsol, name)),
                                   rtol=RTOL)
    rng = np.random.RandomState(n)
    x0, eps = (rng.randn(3, 2, 4, 4, 4).astype(np.float32) for _ in range(2))
    idx = np.array([0, n // 2, n - 1])
    np.testing.assert_array_equal(psol.index_to_timestep(torch.from_numpy(idx)).numpy(),
                                  np.asarray(jsol.index_to_timestep(jnp.asarray(idx))))
    got = psol.ddim_step(torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(idx))
    ref = jsol.ddim_step(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    ts = np.array([0, 499, 999])
    got = psol.ddim_reverse_step(torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(ts))
    ref = jsol.ddim_reverse_step(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_add_noise_and_q_sample(schedules):
    js, ps = schedules
    rng = np.random.RandomState(0)
    x0, noise = (rng.randn(3, 2, 4, 4, 4).astype(np.float32) for _ in range(2))
    t = np.array([0, 500, 999])
    ref = jsched.add_noise(js, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got = P.add_noise(ps, torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    ref = jsched.q_sample(js, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = P.q_sample(ps, torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ptype", ["epsilon", "sample", "v_prediction"])
def test_predicted_origin_and_noise(schedules, ptype):
    js, ps = schedules
    rng = np.random.RandomState(1)
    out, sample = (rng.randn(3, 2, 4, 4, 4).astype(np.float32) for _ in range(2))
    t = np.array([19, 500, 999])
    args_j = (jnp.asarray(out), jnp.asarray(t), jnp.asarray(sample), ptype, js)
    args_p = (torch.from_numpy(out), torch.from_numpy(t), torch.from_numpy(sample), ps, ptype)
    np.testing.assert_allclose(P.predicted_noise(*args_p).numpy(),
                               np.asarray(jlcm.predicted_noise(*args_j)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(P.predicted_origin(*args_p).numpy(),
                               np.asarray(jlcm.predicted_origin(*args_j)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [0.001, 0.5])
def test_huber_loss(c):
    rng = np.random.RandomState(2)
    a, b = (rng.randn(2, 3, 5).astype(np.float32) for _ in range(2))
    ref = jlcm.huber_loss(jnp.asarray(a), jnp.asarray(b), c)
    got = P.huber_loss(torch.from_numpy(a), torch.from_numpy(b), c)
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def _run_optax(tx, params, grads):
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return params


@pytest.mark.parametrize(
    "name,jax_tx",
    [("adamw", lambda lr, wd: optax.adamw(lr, weight_decay=wd)),
     ("adamw_bf16", lambda lr, wd: joptim.adamw_bf16_states(lr, weight_decay=wd)),
     ("adamw8bit", lambda lr, wd: joptim.adamw_q8_states(lr, weight_decay=wd))],
)
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("layout", ["per_tensor", "flat"])
def test_optimizer_matches_jax_over_three_steps(name, jax_tx, wd, layout):
    """Per tensor, and over one flat buffer holding the tensors at 256-aligned
    offsets (the trainer's layout): the same result either way."""
    rng = np.random.RandomState(3)
    shapes = {"a": (300,), "b": (7, 64)}  # 300: a ragged 256-value block
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    ref = _run_optax(jax_tx(1e-2, wd), {k: jnp.asarray(v) for k, v in params.items()},
                     [{k: jnp.asarray(v) for k, v in g.items()} for g in grads])
    tparams = [torch.from_numpy(params[k].copy()) for k in shapes]
    if layout == "flat":
        flat, tparams = poptim.flat_buffer(tparams)
        opt = poptim.make_optimizer([flat], name=name, learning_rate=1e-2, weight_decay=wd)
        for g in grads:
            opt.step([poptim.flat_buffer([torch.from_numpy(g[k]) for k in shapes])[0]])
    else:
        opt = poptim.make_optimizer(tparams, name=name, learning_rate=1e-2, weight_decay=wd)
        for g in grads:
            opt.step([torch.from_numpy(g[k]) for k in shapes])
    for p, k in zip(tparams, shapes):
        np.testing.assert_allclose(p.numpy(), np.asarray(ref[k]), atol=1e-6, err_msg=f"{name} {k}")


def test_make_optimizer_defaults_and_state_roundtrip():
    p = [torch.ones(4)]
    opt = poptim.make_optimizer(p)
    assert opt.weight_decay == 0.0 and opt.moments == "f32"  # not torch.optim.AdamW's 0.01
    q8 = poptim.make_optimizer([torch.ones(300)], name="adamw8bit")
    q8.step([torch.ones(300)])
    assert q8.mu[0][0].dtype == torch.int8 and q8.mu[0][0].shape == (2, 256)
    fresh = poptim.make_optimizer([torch.ones(300)], name="adamw8bit")
    fresh.load_state_dict(q8.state_dict())
    assert fresh.count == 1 and all(torch.equal(a, b) for a, b in zip(fresh.nu[0], q8.nu[0]))
    with pytest.raises(ValueError):
        poptim.make_optimizer(p, name="adamw").load_state_dict(q8.state_dict())
