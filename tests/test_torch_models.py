"""The port's models (t2v_turbo_tpu_torch/models) against the JAX package's and
against the committed reference goldens, on the CPU, in f32.

Weights: a seeded numpy state dict with no zeros anywhere (a zero-initialised
tail would hide a wrong attention or norm), imported into JAX params with the
JAX package's importer, then carried back into the port through
`io/convert.py` and loaded with `load_state_dict(strict=True)`.

Tolerances (f32, PARITY.md): UNet 2e-4, VAE 3e-4, text tower and single
layers 1e-4 absolute; against the goldens the JAX tests' own bounds.
"""

import goldens
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
from t2v_turbo_tpu.models import UNetModel as JUNet
from t2v_turbo_tpu.models import layers as jlayers
from t2v_turbo_tpu.models.clip_text import CLIPTextConfig as JTextConfig
from t2v_turbo_tpu.models.clip_text import CLIPTextModel as JText
from t2v_turbo_tpu.models.vae import AutoencoderKL as JVAE
from t2v_turbo_tpu.models.vae import VAEConfig as JVAEConfig
from t2v_turbo_tpu_torch.io import convert
from t2v_turbo_tpu_torch.models import (
    AutoencoderKL, CLIPTextConfig, CLIPTextModel, UNetConfig, UNetModel, VAEConfig,
)
from t2v_turbo_tpu_torch.models import layers as players
from torch_parity import (
    GOLDEN_UNET_KW, TINY_TEXT_KW, TINY_UNET_KW, TINY_VAE_KW, assert_no_zeros,
    numpy_state_dict, seeded_numpy_state_dict, to_torch,
)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _same_state_dict(a, b):
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:5]
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.fixture(scope="module")
def unet_pair():
    """(port UNet, JAX UNet, JAX params) sharing one no-zero weight set."""
    port = UNetModel(UNetConfig(**TINY_UNET_KW))
    ref_sd = seeded_numpy_state_dict(port, 0)
    assert_no_zeros(ref_sd)
    cfg = JUNetConfig(**TINY_UNET_KW)
    params = ti.import_unet_params(ref_sd, cfg)
    sd = convert.unet_state_dict_from_jax({"params": params})
    _same_state_dict(_np(sd), ref_sd)  # convert is the exact inverse of the importer
    port.load_state_dict(sd, strict=True)
    return port.eval(), JUNet(cfg=cfg), {"params": params}


class TestUNet:
    def test_matches_jax(self, unet_pair):
        port, junet, params = unet_pair
        rng = np.random.RandomState(1)
        x = rng.randn(2, 4, 8, 8, 4).astype(np.float32)
        ctx = rng.randn(2, 7, 16).astype(np.float32)
        w = rng.randn(2, 8).astype(np.float32)
        ts = np.array([999, 279])
        fps = np.array([16.0, 8.0], np.float32)
        ref = jax.jit(junet.apply)(params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                                   fps=jnp.asarray(fps), timestep_cond=jnp.asarray(w))
        with torch.no_grad():
            got = port(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                       fps=torch.from_numpy(fps), timestep_cond=torch.from_numpy(w))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)

    @pytest.mark.parametrize("case", ["1", "2"])
    def test_matches_reference_golden(self, case):
        g = goldens.load("vc2_unet_tiny")
        port = UNetModel(UNetConfig(**GOLDEN_UNET_KW))
        port.load_state_dict(to_torch(goldens.subdict(g, "sd")), strict=True)
        with torch.no_grad():
            out = port.eval()(
                torch.from_numpy(g[f"in{case}.x"].transpose(0, 2, 3, 4, 1)),  # BCTHW -> BTHWC
                torch.from_numpy(g[f"in{case}.ts"]),
                torch.from_numpy(g[f"in{case}.ctx"]),
                fps=torch.from_numpy(g[f"in{case}.fps"]),
                timestep_cond=torch.from_numpy(g[f"in{case}.w"]),
            )
        np.testing.assert_allclose(out.numpy().transpose(0, 4, 1, 2, 3), g[f"out{case}.y"],
                                   atol=2e-4, rtol=1e-3)


class TestLayers:
    def test_temporal_transformer_normalises_the_whole_clip(self):
        """The TemporalTransformer's GroupNorm spans all frames (JAX
        layers.py:490); checked against the JAX layer on one weight set."""
        port = players.TemporalTransformer(32, 2, 16)
        ref_sd = seeded_numpy_state_dict(port, 3)
        params = ti._transformer({f"m.{k}": v for k, v in ref_sd.items()}, "m", depth=1)
        port.load_state_dict(to_torch(ref_sd), strict=True)
        x = np.random.RandomState(4).randn(1, 4, 3, 5, 32).astype(np.float32)  # (B, T, H, W, C)
        x[:, 0] += 3.0
        jt = jlayers.TemporalTransformer(32, 2, 16)
        ref = jt.apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
        np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(ref), atol=1e-4)


@pytest.fixture(scope="module")
def vae_pair():
    port = AutoencoderKL(VAEConfig(**TINY_VAE_KW))
    ref_sd = seeded_numpy_state_dict(port, 5)
    assert_no_zeros(ref_sd)
    params = ti.import_vae_params(ref_sd, n_levels=2, n_res=1)
    sd = convert.vae_state_dict_from_jax({"params": params}, port.cfg)
    _same_state_dict(_np(sd), ref_sd)
    port.load_state_dict(sd, strict=True)
    return port.eval(), JVAE(cfg=JVAEConfig(**TINY_VAE_KW)), {"params": params}


class TestVAE:
    def test_decode_matches_jax(self, vae_pair):
        port, jvae, params = vae_pair
        z = np.random.RandomState(6).randn(3, 8, 8, 4).astype(np.float32)
        ref = jax.jit(lambda p, z: jvae.apply(p, z, method=jvae.decode))(params, jnp.asarray(z))
        with torch.no_grad():
            got = port.decode(torch.from_numpy(z))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-4)

    def test_encode_matches_jax(self, vae_pair):
        port, jvae, params = vae_pair
        x = np.random.RandomState(7).randn(2, 16, 16, 3).astype(np.float32)
        ref = jax.jit(lambda p, x: jvae.apply(p, x, method=jvae.encode))(params, jnp.asarray(x))
        with torch.no_grad():
            got = port.encode(torch.from_numpy(x))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-4)

    @pytest.mark.parametrize("part", ["encode", "decode"])
    def test_matches_reference_golden(self, part):
        g = goldens.load("vc2_vae_tiny")
        port = AutoencoderKL(VAEConfig(**TINY_VAE_KW))
        port.load_state_dict(to_torch(goldens.subdict(g, "sd")), strict=True)
        with torch.no_grad():
            if part == "encode":
                mean, logvar = port.eval().encode(torch.from_numpy(g["in.enc_x"].transpose(0, 2, 3, 1)))
                ref_mean, ref_logvar = np.split(g["out.moments"], 2, axis=1)
                np.testing.assert_allclose(mean.numpy().transpose(0, 3, 1, 2), ref_mean, atol=2e-4, rtol=1e-3)
                np.testing.assert_allclose(logvar.numpy().transpose(0, 3, 1, 2),
                                           np.clip(ref_logvar, -30, 20), atol=2e-4, rtol=1e-3)
            else:
                out = port.eval().decode(torch.from_numpy(g["in.dec_z"].transpose(0, 2, 3, 1)))
                np.testing.assert_allclose(out.numpy().transpose(0, 3, 1, 2), g["out.dec"],
                                           atol=3e-4, rtol=1e-3)


class TestTextTower:
    def _checkpoint_sd(self, port, seed):
        """An open_clip-style state dict: the run blocks, plus the last block,
        text_projection and logit_scale that the penultimate tower drops."""
        sd = seeded_numpy_state_dict(port, seed)
        rng = np.random.RandomState(seed + 1)
        last = port.cfg.layers - 1
        for k in [k for k in sd if k.startswith("transformer.resblocks.0.")]:
            sd[k.replace("resblocks.0.", f"resblocks.{last}.")] = rng.randn(*sd[k].shape).astype(np.float32)
        sd["text_projection"] = rng.randn(port.cfg.width, port.cfg.width).astype(np.float32)
        sd["logit_scale"] = np.array(4.6, np.float32)
        return sd

    def test_matches_jax(self):
        port = CLIPTextModel(CLIPTextConfig(**TINY_TEXT_KW))
        ckpt = self._checkpoint_sd(port, 8)
        params = ti.import_clip_text_params(ckpt, layers=TINY_TEXT_KW["layers"])
        sd = convert.clip_text_state_dict_from_jax({"params": params})
        assert_no_zeros(sd)
        port.load_state_dict(sd, strict=True)
        tokens = np.random.RandomState(9).randint(0, 50, (2, 8)).astype(np.int32)
        jt = JText(cfg=JTextConfig(**TINY_TEXT_KW))
        ref = jax.jit(jt.apply)({"params": params}, jnp.asarray(tokens))
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(tokens))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)

    def test_checkpoint_loads_strictly_minus_named_keys(self):
        port = CLIPTextModel(CLIPTextConfig(**TINY_TEXT_KW))
        ckpt = to_torch(self._checkpoint_sd(port, 10))
        convert.load_clip_text(port, ckpt)
        unused = set(ckpt) - set(port.state_dict())
        assert unused == {k for k in ckpt if k.startswith("transformer.resblocks.2.")} | {
            "text_projection", "logit_scale"}
        with pytest.raises(RuntimeError):  # anything else missing still fails
            convert.load_clip_text(port, {k: v for k, v in ckpt.items() if k != "ln_final.bias"})


def test_split_vc2_checkpoint():
    sd = {"model.diffusion_model.out.2.bias": 1, "first_stage_model.decoder.conv_in.bias": 2,
          "cond_stage_model.model.ln_final.bias": 3, "model_ema.decay": 4}
    unet, vae, clip = convert.split_vc2_checkpoint(sd)
    assert (unet, vae, clip) == ({"out.2.bias": 1}, {"decoder.conv_in.bias": 2}, {"ln_final.bias": 3})


def test_compute_dtype_keeps_norms_f32():
    m = players.cast_compute_dtype_(players.ResBlock(32, 16, 64), torch.bfloat16)
    assert m.in_layers[0].weight.dtype == torch.float32
    assert m.in_layers[2].weight.dtype == torch.bfloat16
    assert m.temopral_conv.conv1[0].bias.dtype == torch.float32


def test_seeded_init_is_nonzero_and_reproducible():
    a = players.seeded_init_(UNetModel(UNetConfig(**TINY_UNET_KW)), 3)
    b = players.seeded_init_(UNetModel(UNetConfig(**TINY_UNET_KW)), 3)
    sd_a, sd_b = numpy_state_dict(a), numpy_state_dict(b)
    assert_no_zeros(sd_a)
    _same_state_dict(sd_a, sd_b)
