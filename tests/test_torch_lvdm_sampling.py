"""The port's lvdm sampling API and x_transformer against the JAX package
and the reference goldens: `diffusion/ancestral.py` (p_sample,
p_sample_loop with the inpainting blend), `diffusion/ddim.py::
ddim_sample_loop` (both grids, eta, CFG, the latent scale) and
`models/x_transformer.py`.

JAX's draws come from its keys as its loops split them; the port takes
them through its `noise` / `noise_fn` arguments (torch.Generator and
jax.random draw different numbers). The stand-in denoisers are the same
closed-form function on both sides.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 (one intra-op thread)
from t2v_turbo_tpu.diffusion import DiffusionSchedule as JSchedule
from t2v_turbo_tpu.diffusion import ancestral as jan
from t2v_turbo_tpu.diffusion.ddim import DDIMSolver as JSolver
from t2v_turbo_tpu.diffusion.ddim import ddim_sample_loop as jddim_loop
from t2v_turbo_tpu.io.torch_import import import_x_transformer_layers, import_x_transformer_params
from t2v_turbo_tpu.models import x_transformer as jxt
from t2v_turbo_tpu_torch.diffusion import DDIMSolver, DiffusionSchedule, ddim_sample_loop
from t2v_turbo_tpu_torch.diffusion import ancestral as an
from t2v_turbo_tpu_torch.models import x_transformer as xt
from torch_parity import seeded_numpy_state_dict, to_torch

T = 100
SHAPE = (2, 3, 4, 5)  # latents (B, T, H, W) stand-in


def _eps(lib):
    """A stand-in denoiser, the same closed form in either framework."""
    def fn(x, t):
        tt = t.reshape((-1,) + (1,) * (x.ndim - 1)).astype(x.dtype) if lib is jnp else \
            t.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
        return 0.3 * lib.tanh(x) + 1e-3 * tt
    return fn


def _uncond(lib):
    return lambda x, t: 0.2 * lib.sin(x)


@pytest.fixture(scope="module")
def scheds():
    return JSchedule.create(num_timesteps=T), DiffusionSchedule.create(num_timesteps=T)


def _x(seed):
    return np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)


class TestAncestral:
    def test_posterior_tables_match_jax(self, scheds):
        jsched, sched = scheds
        for v in (0.0, 0.3):
            for a, b in zip(jan.posterior_tables(jsched, v), an.posterior_tables(sched, v)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("param,clip", [("eps", False), ("eps", True), ("x0", False)])
    def test_p_sample_matches_jax(self, scheds, param, clip):
        jsched, sched = scheds
        x, out = _x(1), 0.5 * _x(2)
        t = np.array([37, 0])
        key = jax.random.PRNGKey(3)
        ref, ref_x0 = jan.p_sample(jan.posterior_tables(jsched), key, jnp.asarray(out), jnp.asarray(x),
                                   jnp.asarray(t), param, clip, temperature=0.7)
        noise = torch.from_numpy(np.asarray(jax.random.normal(key, SHAPE, jnp.float32)))
        got, got_x0 = an.p_sample(an.posterior_tables(sched), torch.from_numpy(out), torch.from_numpy(x),
                                  torch.from_numpy(t), param, clip, temperature=0.7, noise=noise)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(got_x0.numpy(), np.asarray(ref_x0), atol=1e-5)
        # no noise at t = 0: the second sample is the posterior mean whatever the draw
        again, _ = an.p_sample(an.posterior_tables(sched), torch.from_numpy(out), torch.from_numpy(x),
                               torch.from_numpy(t), param, clip, noise=torch.randn(SHAPE))
        assert torch.equal(again[1], got[1]) and not torch.equal(again[0], got[0])

    def test_p_sample_refuses_unknown_parameterization(self, scheds):
        with pytest.raises(NotImplementedError):
            an.p_mean_variance(an.posterior_tables(scheds[1]), torch.zeros(SHAPE), torch.zeros(SHAPE),
                               torch.tensor([1, 1]), "v")

    @pytest.mark.parametrize("inpaint", [False, True])
    def test_p_sample_loop_matches_jax(self, scheds, inpaint):
        jsched, sched = scheds
        steps, x_t = 12, _x(4)
        mask = x0 = None
        if inpaint:
            mask = (np.random.RandomState(5).rand(*SHAPE) > 0.5).astype(np.float32)
            x0 = _x(6)
        key = jax.random.PRNGKey(7)
        ref = jan.p_sample_loop(_eps(jnp), jsched, jnp.asarray(x_t), key, timesteps=steps, temperature=0.9,
                                mask=None if mask is None else jnp.asarray(mask),
                                x0=None if x0 is None else jnp.asarray(x0))
        # JAX's key walk: a step's noise, then (with the blend) its re-noising
        draws, q_draws, k = [], [], key
        for _ in range(steps):
            k, sub = jax.random.split(k)
            draws.append(torch.from_numpy(np.asarray(jax.random.normal(sub, SHAPE, jnp.float32))))
            if inpaint:
                k, kq = jax.random.split(k)
                q_draws.append(torch.from_numpy(np.asarray(jax.random.normal(kq, SHAPE, jnp.float32))))
        got = an.p_sample_loop(_eps(torch), sched, torch.from_numpy(x_t), timesteps=steps, temperature=0.9,
                               mask=None if mask is None else torch.from_numpy(mask),
                               x0=None if x0 is None else torch.from_numpy(x0),
                               noise_fn=lambda i, t: draws[i], q_noise_fn=lambda i, t: q_draws[i])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    def test_p_sample_loop_generator_and_guards(self, scheds):
        sched = scheds[1]
        x_t = torch.from_numpy(_x(8))
        runs = [an.p_sample_loop(_eps(torch), sched, x_t, torch.Generator().manual_seed(s), timesteps=5)
                for s in (1, 1, 2)]
        assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
        with pytest.raises(ValueError, match="together"):
            an.p_sample_loop(_eps(torch), sched, x_t, mask=torch.ones(SHAPE), timesteps=2)


def _solvers(use_scale=False, ddim_eta=0.0):
    ac = np.cumprod(1.0 - np.linspace(0.00085**0.5, 0.012**0.5, T, dtype=np.float64) ** 2)
    kw = dict(timesteps=T, ddim_timesteps=10, use_scale=use_scale, ddim_eta=ddim_eta)
    return JSolver.create(ac, **kw), DDIMSolver.create(ac, **kw)


class TestDDIMSampleLoop:
    @pytest.mark.parametrize("grid,eta,cfg,use_scale,temperature", [
        ("sampler", 0.0, 1.0, False, 1.0),
        ("sampler", 0.6, 7.5, False, 0.8),
        ("solver", 0.0, 1.0, False, 1.0),
        ("solver", 0.5, 2.0, True, 1.3),
    ])
    def test_matches_jax(self, grid, eta, cfg, use_scale, temperature):
        # on the solver grid the sigmas are the solver's (ddim_eta); on the sampler grid, `eta`'s
        jsolver, solver = _solvers(use_scale, eta if grid == "solver" else 0.0)
        x_t, key = _x(9), jax.random.PRNGKey(11)
        kw = dict(cfg_scale=cfg, temperature=temperature, grid=grid, eta=eta)
        ref = jddim_loop(_eps(jnp), jsolver, jnp.asarray(x_t), key, uncond_model_fn=_uncond(jnp), **kw)
        draws, k = [], key
        for _ in range(10):
            k, sub = jax.random.split(k)
            draws.append(torch.from_numpy(np.asarray(jax.random.normal(sub, SHAPE, jnp.float32))))
        got = ddim_sample_loop(_eps(torch), solver, torch.from_numpy(x_t), uncond_model_fn=_uncond(torch),
                               noise_fn=lambda i: draws[i], **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    def test_reference_sampler_chain(self):
        """The reference DDIMSampler's chain (tests/goldens/ddim_sampler_chain.npz):
        eta 0, 10 steps of T = 100 on its uniform grid i*10 + 1."""
        g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "ddim_sampler_chain.npz"))
        np.testing.assert_array_equal(g["meta.ts"], np.arange(10) * 10 + 1)
        _, solver = _solvers()
        out = ddim_sample_loop(lambda z, t: 0.05 * z, solver, torch.from_numpy(g["in.x_T"]), grid="sampler")
        np.testing.assert_allclose(out.numpy(), g["out.x0"].reshape(out.shape), atol=1e-5, rtol=1e-4)

    def test_generator_and_guards(self):
        _, solver = _solvers()
        x_t = torch.from_numpy(_x(12))
        runs = [ddim_sample_loop(_eps(torch), solver, x_t, torch.Generator().manual_seed(s), eta=0.5)
                for s in (3, 3, 4)]
        assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
        with pytest.raises(ValueError, match="uncond_model_fn"):
            ddim_sample_loop(_eps(torch), solver, x_t, cfg_scale=3.0)
        with pytest.raises(ValueError, match="grid"):
            ddim_sample_loop(_eps(torch), solver, x_t, grid="other")
        with pytest.raises(NotImplementedError, match="use_scale"):
            ddim_sample_loop(_eps(torch), _solvers(use_scale=True)[1], x_t, grid="sampler")


# --- x_transformer -----------------------------------------------------------

ATOL = 3e-5  # tests/test_x_transformer.py's


@pytest.fixture(scope="module")
def gold():
    return np.load(os.path.join(os.path.dirname(__file__), "goldens", "x_transformer.npz"))


def _sd(gold, name):
    p = f"{name}/sd/"
    return {k[len(p):]: gold[k] for k in gold.files if k.startswith(p)}


def _load(model, sd):
    model.load_state_dict(to_torch(sd), strict=True)
    return model.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a))


# The golden's cases: the configurations of tests/xt_golden_gen.py (its
# `attn_*` / `ff_*` keywords as the attn_kwargs / ff_kwargs dicts).
GOLDEN_CASES = {
    "A": lambda: xt.TransformerWrapper(num_tokens=50, max_seq_len=16, attn_layers=xt.Encoder(
        dim=32, depth=2, heads=4, attn_kwargs=dict(dim_head=8))),
    "B": lambda: xt.TransformerWrapper(num_tokens=50, max_seq_len=16, emb_dim=24, num_memory_tokens=2,
                                       attn_layers=xt.Encoder(
        dim=32, depth=2, heads=2, use_scalenorm=True, sandwich_coef=1, residual_attn=True,
        attn_kwargs=dict(dim_head=8, talking_heads=True, num_mem_kv=2, sparse_topk=4), ff_kwargs=dict(glu=True))),
    "C": lambda: xt.AttentionLayers(dim=32, depth=2, heads=4, causal=True, gate_residual=True, use_rmsnorm=True,
                                    attn_kwargs=dict(dim_head=8)),
    "D": lambda: xt.AttentionLayers(dim=32, depth=2, heads=4, pre_norm=False, use_rezero=True,
                                    position_infused_attn=True, attn_kwargs=dict(dim_head=8, on_attn=True)),
    "E": lambda: xt.AttentionLayers(dim=32, depth=2, heads=4, cross_attend=True, cross_residual_attn=True,
                                    attn_kwargs=dict(dim_head=8)),
    "G": lambda: xt.TransformerWrapper(num_tokens=50, max_seq_len=16, tie_embedding=True,
                                       attn_layers=xt.Encoder(dim=32, depth=1, heads=4, attn_kwargs=dict(dim_head=8))),
}


class TestXTransformer:
    @pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
    def test_reference_golden(self, gold, case):
        model = _load(GOLDEN_CASES[case](), _sd(gold, case))
        with torch.no_grad():
            if case in "ABG":
                tokens, mask = _t(gold[f"{case}/in/tokens"]), _t(gold[f"{case}/in/mask"])
                logits, attn = model(tokens, mask=mask, return_attn=True)
                np.testing.assert_allclose(logits.numpy(), gold[f"{case}/out/logits"], atol=ATOL)
                if case == "A":
                    emb = model(tokens, mask=mask, return_embeddings=True)
                    np.testing.assert_allclose(emb.numpy(), gold["A/out/embeddings"], atol=ATOL)
                    for i, m in enumerate(attn):
                        np.testing.assert_allclose(m.numpy(), gold[f"A/out/attn_{i}"], atol=ATOL)
            else:
                kw = dict(context=_t(gold["E/in/ctx"]), context_mask=_t(gold["E/in/cmask"])) if case == "E" else {}
                y = model(_t(gold[f"{case}/in/x"]), **kw)
                np.testing.assert_allclose(y.numpy(), gold[f"{case}/out/y"], atol=ATOL)
        if case == "B":
            assert model.attn_layers.layer_types == tuple(gold["B/layer_types"])

    def test_layer_schedules(self, gold):
        got = {
            "par": xt.build_layer_types(4, False, False, False, None, None, 2),
            "sandwich": xt.build_layer_types(4, False, False, False, None, 2, None),
            "cross": xt.build_layer_types(3, True, False, False, None, None, None),
            "only_cross": xt.build_layer_types(3, True, True, False, None, None, None),
        }
        for k, lt in got.items():
            assert lt == tuple(gold[f"F/layer_types/{k}"]), k
            assert lt == jxt.build_layer_types(
                *{"par": (4, False, False, False, None, None, 2), "sandwich": (4, False, False, False, None, 2, None),
                  "cross": (3, True, False, False, None, None, None),
                  "only_cross": (3, True, True, False, None, None, None)}[k])

    @pytest.mark.parametrize("knobs", ["macaron_residual_attn", "only_cross_gru_rmsnorm", "postnorm_topk_memkv"])
    def test_matches_jax(self, knobs):
        """Knobs no golden holds, on seeded port weights carried into JAX by
        its own importer (the reference's keys; a macaron Scale's `fn.` level
        dropped, as JAX's tree has none)."""
        kw = {
            "macaron_residual_attn": dict(macaron=True, residual_attn=True, attn_kwargs=dict(dim_head=8)),
            "only_cross_gru_rmsnorm": dict(cross_attend=True, only_cross=True, gate_residual=True, use_rmsnorm=True,
                                           cross_residual_attn=True, attn_kwargs=dict(dim_head=8),
                                           ff_kwargs=dict(glu=True, mult=2)),
            "postnorm_topk_memkv": dict(pre_norm=False, attn_kwargs=dict(dim_head=8, sparse_topk=3, num_mem_kv=2,
                                                                         talking_heads=True)),
        }[knobs]
        port = xt.AttentionLayers(dim=16, depth=2, heads=2, **kw)
        sd = seeded_numpy_state_dict(port, 21)
        _load(port, sd)
        rng = np.random.RandomState(22)
        x, ctx = rng.randn(2, 6, 16).astype(np.float32), rng.randn(2, 5, 16).astype(np.float32)
        cmask = np.ones((2, 5), bool)
        cmask[1, 3:] = False
        args = dict(context=ctx, context_mask=cmask) if "cross" in knobs else {}
        jsd = {k.replace(".1.fn.net.", ".1.net."): v for k, v in sd.items()}
        params = import_x_transformer_layers(jsd, port.layer_types, gate_residual=kw.get("gate_residual", False),
                                             glu="ff_kwargs" in kw, norm_has_g=kw.get("use_rmsnorm", False))
        ref = jax.jit(jxt.AttentionLayers(dim=16, depth=2, heads=2, **kw).apply)(
            {"params": params}, jnp.asarray(x), **{k: jnp.asarray(v) for k, v in args.items()})
        with torch.no_grad():
            got = port(_t(x), **{k: _t(v) for k, v in args.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    def test_wrapper_matches_jax(self, gold):
        """Case A's wrapper through JAX's importer and the port, embeddings included."""
        sd = _sd(gold, "A")
        lt = jxt.build_layer_types(2, False, False, False, None, None, None)
        jm = jxt.TransformerWrapper(num_tokens=50, max_seq_len=16,
                                    attn_layers=dict(dim=32, depth=2, heads=4, attn_kwargs=dict(dim_head=8)))
        tokens, mask = gold["A/in/tokens"], gold["A/in/mask"]
        ref = jax.jit(lambda p, t, m: jm.apply(p, t, mask=m, return_embeddings=True))(
            {"params": import_x_transformer_params(sd, lt)}, jnp.asarray(tokens), jnp.asarray(mask))
        with torch.no_grad():
            got = _load(GOLDEN_CASES["A"](), sd)(_t(tokens), mask=_t(mask), return_embeddings=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    def test_guards(self):
        with pytest.raises(AssertionError):
            xt.Encoder(dim=8, depth=1, causal=True)
        layers = xt.AttentionLayers(dim=8, depth=1, heads=2, attn_kwargs=dict(dim_head=4))
        with pytest.raises(NotImplementedError):
            layers(torch.zeros(1, 3, 8), mems=[torch.zeros(1, 2, 8)])
        with pytest.raises(NotImplementedError):
            xt.AttentionLayers(dim=8, depth=1, heads=2, attn_kwargs=dict(use_entmax15=True))
