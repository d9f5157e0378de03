"""MotionClone's motion prior and the EMA in the port (training/motion.py,
training/ema.py) against the JAX package's, on the CPU, in f32, through the
tiny teacher UNet of torch_parity with one no-zero weight set.

- the rank loss on given probabilities (rank_k 0, 1, 2, 4; random
  softmax rows have no ties) to 1e-6 relative;
- the loss on the two packages' own captures (JAX lists its layers by
  sorted key string, the port by output block: the same pairing) to 1e-5;
- motion_prior_score: the score to 1e-3 x its largest entry (a gradient
  through the UNet, whose f32 sums run in another order: PARITY.md's 2e-4
  on the outputs), the conditional output to 2e-4, the unscaled loss to
  1e-4 relative; one JAX gradient compile;
- reverse_ddim_loop over 3 grid points to 5e-4 (2e-4 a UNet call);
- update_ema / warmup_decay to f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu import diffusion as J
from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
from t2v_turbo_tpu.models import UNetModel as JUNet
from t2v_turbo_tpu.training import ema as jema
from t2v_turbo_tpu.training import motion as jmotion
from t2v_turbo_tpu_torch import diffusion as P
from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel
from t2v_turbo_tpu_torch.training import ema, motion
from torch_parity import TINY_UNET_KW, seeded_numpy_state_dict, to_torch

KW = dict(TINY_UNET_KW, time_cond_proj_dim=None)


@pytest.fixture(scope="module")
def teacher():
    port = UNetModel(UNetConfig(**KW))
    sd = seeded_numpy_state_dict(port, 60)
    port.load_state_dict(to_torch(sd), strict=True)
    port.requires_grad_(False).eval()
    jcfg = JUNetConfig(**KW)
    junet, params = JUNet(cfg=jcfg), {"params": ti.import_unet_params(sd, jcfg)}

    def apply(p, z, ts, c, fps=None):
        return junet.apply(p, z, ts, c, fps=fps)

    @jax.jit
    def apply_mut(p, z, ts, c, fps=None):
        return junet.apply(p, z, ts, c, fps=fps, record_probs=True, mutable=["intermediates"])

    rng = np.random.RandomState(61)
    data = dict(z=rng.randn(1, 4, 8, 8, 4).astype(np.float32), example=rng.randn(1, 4, 8, 8, 4).astype(np.float32),
                ctx=rng.randn(1, 7, 16).astype(np.float32), ts=np.array([799]))
    return port, apply, apply_mut, params, data


def _softmax_rows(rng, shape):
    x = rng.randn(*shape).astype(np.float32) * 2
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("rank_k", [0, 1, 2, 4])
def test_rank_loss_matches_jax(rank_k):
    rng = np.random.RandomState(rank_k)
    shapes = [(40, 4, 4), (24, 4, 4), (8, 4, 4)]
    gen = [_softmax_rows(rng, s) for s in shapes]
    ref = [_softmax_rows(rng, s) for s in shapes]
    want = float(jmotion.motion_rank_loss([jnp.asarray(g) for g in gen], [jnp.asarray(r) for r in ref], rank_k))
    got = float(motion.motion_rank_loss([torch.from_numpy(g) for g in gen], [torch.from_numpy(r) for r in ref],
                                        rank_k))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-9)
    if rank_k:
        assert got > 0


def test_rank_loss_refuses_mismatched_layers():
    p = [torch.rand(2, 4, 4)]
    with pytest.raises(ValueError):
        motion.motion_rank_loss(p, p + p)
    with pytest.raises(ValueError):
        motion.motion_rank_loss(p, p, rank_k=5)


def test_captured_layers_pair_as_jax(teacher):
    port, _, apply_mut, params, d = teacher
    j = {k: jnp.asarray(v) for k, v in d.items()}
    _, jref = jmotion.temp_attn_probs(apply_mut, params, j["example"], j["ts"], j["ctx"])
    jout, jgen = jmotion.temp_attn_probs(apply_mut, params, j["z"], j["ts"], j["ctx"])
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    with torch.no_grad():
        _, pref = motion.temp_attn_probs(port, t["example"], t["ts"], t["ctx"])
        pout, pgen = motion.temp_attn_probs(port, t["z"], t["ts"], t["ctx"])
    assert len(pgen) == len(jgen) == 4
    for a, b in zip(pgen, jgen):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=2e-4)
    want = float(jmotion.motion_rank_loss(jgen, jref))
    assert float(motion.motion_rank_loss(pgen, pref)) == pytest.approx(want, rel=1e-5)


def test_motion_prior_score_matches_jax(teacher):
    port, _, apply_mut, params, d = teacher
    j = {k: jnp.asarray(v) for k, v in d.items()}
    score_fn = jax.jit(lambda p, z, e, c, ts: jmotion.motion_prior_score(
        apply_mut, p, z, ts, e, c, c, temp_loss_scale=2.0, rank_k=1, return_loss=True))
    jscore, jcond, jloss = (np.asarray(a) for a in score_fn(params, j["z"], j["example"], j["ctx"], j["ts"]))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    score, cond, loss = motion.motion_prior_score(port, t["z"], t["ts"], t["example"], t["ctx"], t["ctx"],
                                                  temp_loss_scale=2.0, rank_k=1, return_loss=True)
    assert not score.requires_grad and not cond.requires_grad and score.dtype == torch.float32
    assert float(np.abs(jscore).max()) > 0
    np.testing.assert_allclose(score.numpy(), jscore, atol=1e-3 * float(np.abs(jscore).max()))
    np.testing.assert_allclose(cond.numpy(), jcond, atol=2e-4)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    # the frozen teacher's weights get no gradient and stay frozen
    assert all(p.grad is None and not p.requires_grad for p in port.parameters())


def test_reverse_ddim_loop_matches_jax(teacher):
    port, apply, _, params, d = teacher
    jsched = J.DiffusionSchedule.create()
    jsolver = J.DDIMSolver.create(np.asarray(jsched.alphas_cumprod))
    want = np.asarray(jmotion.reverse_ddim_loop(apply, params, jnp.asarray(d["z"]), jnp.asarray(d["ctx"]),
                                                jsolver, 3))
    solver = P.DDIMSolver.create(P.DiffusionSchedule.create().alphas_cumprod.numpy())
    got = motion.reverse_ddim_loop(port, torch.from_numpy(d["z"]), torch.from_numpy(d["ctx"]), solver, 3)
    assert got.shape == want.shape == (3, 1, 4, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)
    last = motion.reverse_ddim_loop(port, torch.from_numpy(d["z"]), torch.from_numpy(d["ctx"]), solver, 3,
                                    return_intermediates=False)
    torch.testing.assert_close(last, got[-1], rtol=0, atol=0)


def test_ema_matches_jax():
    rng = np.random.RandomState(7)
    e, p = rng.randn(1000).astype(np.float32), rng.randn(1000).astype(np.float32)
    want = np.asarray(jema.update_ema({"a": jnp.asarray(e)}, {"a": jnp.asarray(p)}, 0.95)["a"])
    got = ema.update_ema(torch.from_numpy(e.copy()), torch.from_numpy(p), 0.95)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=1e-7)
    for step in (0, 1, 10, 1000, 10**7):
        assert float(ema.warmup_decay(step)) == pytest.approx(float(jema.warmup_decay(jnp.asarray(step))), rel=1e-7)
