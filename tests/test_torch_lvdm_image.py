"""The port's image-conditioned VC2 pieces and the UNet's switches against
the JAX package and the reference golden: `models/ip_resampler.py`,
`models/image_cond.py`, `VisionTransformer(return_tokens=True)`,
CrossAttention's image branch (tests/goldens/vc2_img_xattn_tiny.npz, the
reference module's output) and tiny UNets with relative position + causal
temporal attention + the scale-shift norm, with the temporal conv /
temporal attention / init_attn / fps switches off, and with the image
branch, each at 2e-4 (PARITY.md).

The weights start on the JAX side, seeded from numpy over the shapes of
`jax.eval_shape(init)` (no zero-initialised tail), and reach the port
through io/convert.py, whose state dicts load strictly. The JAX modules run
under `jax.jit` (the tiny UNet in a quarter of its eager apply's time).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 (one intra-op thread)
from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
from t2v_turbo_tpu.models import UNetModel as JUNet
from t2v_turbo_tpu.models import image_cond as jic
from t2v_turbo_tpu.models import ip_resampler as jip
from t2v_turbo_tpu.rewards import vit as jvit
from t2v_turbo_tpu_torch.io import convert
from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel
from t2v_turbo_tpu_torch.models import image_cond as ic
from t2v_turbo_tpu_torch.models import ip_resampler as ip
from t2v_turbo_tpu_torch.models import layers as players
from t2v_turbo_tpu_torch.models.layers import CrossAttention
from t2v_turbo_tpu_torch.rewards.vit import ViTConfig
from tinymodels import TINY_UNET_KW
from torch_parity import TINY_VIT_KW, to_torch


def seeded_params(module, seed, *args, **kw):
    """`module`'s flax params from seeded numpy over `jax.eval_shape(init)`:
    norm scales 1 + 0.1 N, other vectors 0.1 N, the rest N / sqrt(fan_in)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kw)["params"]
    rng = np.random.RandomState(seed)

    def fill(path, s):
        r = rng.randn(*s.shape).astype(np.float32)
        if len(s.shape) == 1:
            return 1.0 + 0.1 * r if path[-1].key == "scale" else 0.1 * r
        return r / np.sqrt(np.prod(s.shape[:-1]))

    return {"params": jax.tree_util.tree_map_with_path(fill, shapes)}


def _np(x):
    return np.asarray(x, dtype=np.float32)


UNET_CASES = {
    "relpos_causal_scale_shift": dict(use_relative_position=True, use_causal_attention=True,
                                      use_scale_shift_norm=True),
    "switches_off": dict(temporal_conv=False, temporal_attention=False, addition_attention=False, fps_cond=False),
    "image_attention": dict(use_image_attention=True),
}


class TestUNetSwitches:
    @pytest.mark.parametrize("case", sorted(UNET_CASES))
    def test_matches_jax(self, case):
        kw = dict(TINY_UNET_KW, **UNET_CASES[case])
        rng = np.random.RandomState(1)
        n_ctx = 204 if kw.get("use_image_attention") else 7  # 200 text rows + 4 image tokens
        x = rng.randn(2, 4, 8, 8, 4).astype(np.float32)
        ctx = rng.randn(2, n_ctx, 16).astype(np.float32)
        w = rng.randn(2, 8).astype(np.float32)
        ts, fps = np.array([999, 279]), np.array([16.0, 8.0], np.float32)
        junet = JUNet(cfg=JUNetConfig(**kw))
        j_in = (jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx))
        params = seeded_params(junet, 2, *j_in, fps=jnp.asarray(fps), timestep_cond=jnp.asarray(w))
        ref = jax.jit(junet.apply)(params, *j_in, fps=jnp.asarray(fps), timestep_cond=jnp.asarray(w))

        port = UNetModel(UNetConfig(**kw))
        port.load_state_dict(convert.unet_state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
        with torch.no_grad():
            got = port(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx), fps=torch.from_numpy(fps),
                       timestep_cond=torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
        keys = set(port.state_dict())
        n_of = lambda cls: sum(isinstance(m, cls) for m in port.modules())  # noqa: E731
        if case == "relpos_causal_scale_shift":  # both attentions of every temporal transformer
            assert sum(k.endswith("relative_position_k.embeddings_table") for k in keys) == 2 * n_of(
                players.TemporalTransformer)
            assert port.state_dict()["input_blocks.1.0.emb_layers.1.weight"].shape[0] == 2 * 32
        elif case == "switches_off":
            assert not any(k.startswith(("init_attn", "fps_embedding")) or "temopral_conv" in k for k in keys)
            assert n_of(players.TemporalTransformer) == 0
        else:  # attn2 of every spatial transformer
            assert sum(k.endswith("attn2.to_k_ip.weight") for k in keys) == n_of(players.SpatialTransformer) > 0

    def test_temporal_cross_attention_is_refused(self):
        with pytest.raises(NotImplementedError, match="context_dim"):
            UNetConfig(temporal_selfatt_only=False)


class TestImageCrossAttention:
    def test_reference_golden(self):
        g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "vc2_img_xattn_tiny.npz"))
        qd, cd, heads, dh = (int(v) for v in g["meta.dims"])
        attn = CrossAttention(qd, cd, heads, dh, img_cross_attention=True)
        attn.load_state_dict(to_torch({k[3:]: g[k] for k in g.files if k.startswith("sd.")}), strict=True)
        with torch.no_grad():
            out = attn(torch.from_numpy(g["in.x"]), torch.from_numpy(g["in.ctx"]))
            np.testing.assert_allclose(out.numpy(), g["out.y"], atol=2e-5, rtol=1e-4)
            with pytest.raises(ValueError, match="text_context_len=200"):
                attn(torch.from_numpy(g["in.x"]), torch.from_numpy(g["in.ctx"][:, :200]))


class TestImageConditioning:
    @pytest.mark.parametrize("s,dtype", [(7, torch.float32), (210, torch.float32), (7, torch.bfloat16)])
    def test_append_image_context(self, s, dtype):
        rng = np.random.RandomState(s)
        text, img = rng.randn(2, s, 8).astype(np.float32), rng.randn(2, 4, 8).astype(np.float32)
        ref = jic.append_image_context(jnp.asarray(text, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
                                       jnp.asarray(img))
        got = ic.append_image_context(torch.from_numpy(text).to(dtype), torch.from_numpy(img))
        assert got.shape == (2, 204, 8) and got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), _np(ref))

    def test_heads_match_jax(self):
        """ImageProjModel and the Resampler alone, through their converters."""
        rng = np.random.RandomState(3)
        emb, feats = rng.randn(2, 16).astype(np.float32), rng.randn(2, 5, 12).astype(np.float32)
        jproj = jip.ImageProjModel(cross_attention_dim=24, clip_extra_context_tokens=4)
        pp = seeded_params(jproj, 4, jnp.asarray(emb))
        port = ip.ImageProjModel(24, 16, 4)
        port.load_state_dict(convert.image_proj_state_dict_from_jax(pp), strict=True)
        jres = jip.Resampler(dim=16, depth=2, dim_head=8, heads=3, num_queries=6, embedding_dim=12, output_dim=24)
        rp = seeded_params(jres, 5, jnp.asarray(feats))
        res = ip.Resampler(dim=16, depth=2, dim_head=8, heads=3, num_queries=6, embedding_dim=12, output_dim=24)
        res.load_state_dict(convert.resampler_state_dict_from_jax(rp), strict=True)
        with torch.no_grad():
            np.testing.assert_allclose(port(torch.from_numpy(emb)).numpy(),
                                       _np(jax.jit(jproj.apply)(pp, jnp.asarray(emb))), atol=1e-5)
            np.testing.assert_allclose(res(torch.from_numpy(feats)).numpy(),
                                       _np(jax.jit(jres.apply)(rp, jnp.asarray(feats))), atol=1e-5)

    @pytest.mark.parametrize("finegrained", [False, True])
    def test_encoder_matches_jax(self, finegrained):
        """A tiny ImageCondEncoder: the ViT (its pooled embedding, or with
        return_tokens its (1 + N)-token output) and its head, against
        JAX's on the same seeded weights and a 40x56 image."""
        jcfg = jvit.ViTConfig(**TINY_VIT_KW)
        img = np.random.RandomState(6).uniform(-1, 1, (2, 40, 56, 3)).astype(np.float32)
        tower = jvit.VisionTransformer(cfg=jcfg)
        tp = seeded_params(tower, 7, jnp.zeros((1, 28, 28, 3)))
        if finegrained:
            proj = jip.Resampler(dim=16, depth=4, dim_head=64, heads=12, num_queries=16, embedding_dim=32,
                                 output_dim=24)
            pp = seeded_params(proj, 8, jnp.zeros((1, 5, 32)))
            head_sd = convert.resampler_state_dict_from_jax(pp)
        else:
            proj = jip.ImageProjModel(cross_attention_dim=24, clip_extra_context_tokens=4)
            pp = seeded_params(proj, 8, jnp.zeros((1, 16)))
            head_sd = convert.image_proj_state_dict_from_jax(pp)
        enc = jic.ImageCondEncoder(tower=tower, tower_params=tp, proj=proj, proj_params=pp, finegrained=finegrained)
        ref = _np(jax.jit(enc.__call__)(jnp.asarray(img)))

        port = ic.ImageCondEncoder(finegrained, 24, ViTConfig(**TINY_VIT_KW))
        port.tower.load_state_dict(convert.vit_state_dict_from_jax(jax.tree.map(np.asarray, tp)), strict=True)
        port.image_proj_model.load_state_dict(head_sd, strict=True)
        with torch.no_grad():
            got = port(torch.from_numpy(img))
            tokens = port.tower(ic.clip_image_preprocess(torch.from_numpy(img), 28), return_tokens=True)
        assert got.shape == (2, 16 if finegrained else 4, 24)
        assert tokens.shape == (2, 1 + 4, 32)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
