"""The port's VC2 pipeline end to end against the JAX pipeline, on the CPU, in
f32, on tests/test_pipeline.py's tiny models with one no-zero weight set.

- 1 step: both pipelines' `__call__` from the same numpy latents; a 1-step
  run draws no noise, so the comparison is exact up to f32 arithmetic.
- 4 steps: the port is handed the renoise draws the JAX pipeline makes
  inside its scan (reproduced from the same PRNG key).
Tolerance 3e-4 absolute on the [-1, 1] video, the VAE's bound (PARITY.md),
since the decode is the last stage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu.diffusion import DiffusionSchedule as JSchedule
from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
from t2v_turbo_tpu.models import UNetModel as JUNet
from t2v_turbo_tpu.models.clip_text import CLIPTextConfig as JTextConfig
from t2v_turbo_tpu.models.clip_text import CLIPTextModel as JText
from t2v_turbo_tpu.models.vae import AutoencoderKL as JVAE
from t2v_turbo_tpu.models.vae import VAEConfig as JVAEConfig
from t2v_turbo_tpu.pipelines.vc2 import T2VTurboVC2Pipeline as JPipeline
from t2v_turbo_tpu.pipelines.vc2 import video_to_uint8 as j_video_to_uint8
from t2v_turbo_tpu_torch.apps import generate
from t2v_turbo_tpu_torch.config import VC2ModelSpec
from t2v_turbo_tpu_torch.diffusion import DiffusionSchedule
from t2v_turbo_tpu_torch.models import (
    AutoencoderKL, CLIPTextConfig, CLIPTextModel, UNetConfig, UNetModel, VAEConfig,
)
from t2v_turbo_tpu_torch.pipelines.vc2 import T2VTurboVC2Pipeline, video_to_uint8
from torch_parity import TINY_TEXT_KW, TINY_UNET_KW, TINY_VAE_KW, seeded_numpy_state_dict, to_torch

UNET_KW = dict(TINY_UNET_KW, time_cond_proj_dim=256)  # the pipeline's w-embedding width
TEXT_KW = dict(TINY_TEXT_KW, layers=2)
ATOL = 3e-4


class FakeTokenizer:
    """tests/test_pipeline.py's stand-in: ids in the tiny vocabulary."""

    def __call__(self, prompts):
        if isinstance(prompts, str):
            prompts = [prompts]
        rng = np.random.RandomState(sum(len(p) for p in prompts))
        return rng.randint(0, 50, (len(prompts), 8)).astype(np.int32)


@pytest.fixture(scope="module")
def pipelines():
    unet = UNetModel(UNetConfig(**UNET_KW))
    vae = AutoencoderKL(VAEConfig(**TINY_VAE_KW))
    text = CLIPTextModel(CLIPTextConfig(**TEXT_KW))
    sds = [seeded_numpy_state_dict(m, seed) for seed, m in enumerate((unet, vae, text))]
    for m, sd in zip((unet, vae, text), sds):
        m.load_state_dict(to_torch(sd), strict=True)
    port = T2VTurboVC2Pipeline(
        unet=unet.eval(), vae=vae.eval(), text_model=text.eval(), tokenizer=FakeTokenizer(),
        schedule=DiffusionSchedule.create(), device="cpu", vae_scale=2, dtype=torch.float32,
    )
    jcfg = JUNetConfig(**UNET_KW)
    ref = JPipeline(
        unet=JUNet(cfg=jcfg), unet_params={"params": ti.import_unet_params(sds[0], jcfg)},
        vae=JVAE(cfg=JVAEConfig(**TINY_VAE_KW)),
        vae_params={"params": ti.import_vae_params(sds[1], n_levels=2, n_res=1)},
        text_model=JText(cfg=JTextConfig(**TEXT_KW)),
        text_params={"params": ti.import_clip_text_params(sds[2], layers=2)},
        tokenizer=FakeTokenizer(), schedule=JSchedule.create(), vae_scale=2, dtype=jnp.float32,
    )
    return port, ref


def _jax_scan_noise(key, steps, shape):
    """The renoise draws of the JAX pipeline's scan for `key`
    (pipelines/vc2.py: split(key, 3) -> sample key, then one split per step)."""
    _, _, k = jax.random.split(key, 3)
    out = []
    for _ in range(steps):
        k, sub = jax.random.split(k)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return out


@pytest.mark.parametrize("steps", [1, 4])
def test_matches_jax_pipeline(pipelines, steps):
    port, ref = pipelines
    lat = np.random.RandomState(11).randn(1, 4, 4, 4, 4).astype(np.float32)
    key = jax.random.PRNGKey(3)
    kw = dict(prompt="a cat", height=8, width=8, frames=4, num_inference_steps=steps)
    want = np.asarray(ref(key=key, latents=jnp.asarray(lat), **kw))
    noise = _jax_scan_noise(key, steps, lat.shape) if steps > 1 else None
    got = port(latents=torch.from_numpy(lat), noise=noise, **kw)
    assert got.shape == (1, 4, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # uint8 conversion: the same up to one level where a value sits on a rounding edge
    u8 = video_to_uint8(got).astype(int) - j_video_to_uint8(jnp.asarray(want)).astype(int)
    assert np.abs(u8).max() <= 1


def test_latent_output_and_generator(pipelines):
    port, _ = pipelines
    kw = dict(prompt="a dog", height=8, width=8, frames=4, num_inference_steps=2, output_type="latent")
    a = port(generator=torch.Generator().manual_seed(7), **kw)
    b = port(generator=torch.Generator().manual_seed(7), **kw)
    c = port(generator=torch.Generator().manual_seed(8), **kw)
    assert a.shape == (1, 4, 4, 4, 4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float((a - c).abs().max()) > 1e-6


def test_rejects_sizes_the_unet_cannot_split(pipelines):
    port, _ = pipelines
    with pytest.raises(ValueError):
        port(prompt="x", height=6, width=8, frames=4)


def test_generate_builds_a_seeded_pipeline_on_cpu():
    spec = VC2ModelSpec(unet=UNetConfig(**dict(UNET_KW, context_dim=64)),
                        vae=VAEConfig(**TINY_VAE_KW),
                        text=CLIPTextConfig(width=64, heads=2, layers=2))
    args = generate.parse_args(["--prompt", "a cat", "--random-weights", "--seed", "5", "--device", "cpu"])
    assert (args.steps, args.frames, args.height, args.width) == (4, 16, 320, 512)
    pipe = generate.build_pipeline(args, spec)
    pipe.vae_scale = 2
    video = pipe(prompt=args.prompt, height=8, width=8, frames=2, num_inference_steps=2,
                 generator=torch.Generator().manual_seed(args.seed))
    assert video.shape == (1, 2, 8, 8, 3) and bool(torch.isfinite(video).all())
    assert video.dtype == torch.float32  # bf16 is for the card


def test_generate_loads_a_reference_checkpoint(tmp_path):
    """--checkpoint: a Lightning-style VideoCrafter2 state dict (with the CLIP
    keys the penultimate tower drops) is split and loaded strictly;
    --unet-ckpt replaces its UNet."""
    spec = VC2ModelSpec(unet=UNetConfig(**dict(UNET_KW, context_dim=64)),
                        vae=VAEConfig(**TINY_VAE_KW),
                        text=CLIPTextConfig(width=64, heads=2, layers=2))
    unet, vae = UNetModel(spec.unet), AutoencoderKL(spec.vae)
    text = CLIPTextModel(CLIPTextConfig(width=64, heads=2, layers=3))  # holds the dropped last block
    parts = {"model.diffusion_model.": seeded_numpy_state_dict(unet, 1),
             "first_stage_model.": seeded_numpy_state_dict(vae, 2),
             "cond_stage_model.model.": seeded_numpy_state_dict(text, 3)}
    full = {p + k: torch.from_numpy(v) for p, sd in parts.items() for k, v in sd.items()}
    full["cond_stage_model.model.text_projection"] = torch.ones(64, 64)
    full["cond_stage_model.model.logit_scale"] = torch.tensor(4.6)
    ckpt, unet_ckpt = tmp_path / "model.ckpt", tmp_path / "unet.pt"
    torch.save({"state_dict": full}, ckpt)
    student = to_torch(seeded_numpy_state_dict(unet, 4))
    torch.save(student, unet_ckpt)

    args = generate.parse_args(["--prompt", "a cat", "--checkpoint", str(ckpt), "--unet-ckpt",
                                str(unet_ckpt), "--device", "cpu"])
    pipe = generate.build_pipeline(args, spec)
    for k, v in pipe.unet.state_dict().items():
        torch.testing.assert_close(v, student[k], rtol=0, atol=0)
    for k, v in pipe.vae.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), parts["first_stage_model."][k])
    for k, v in pipe.text_model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), parts["cond_stage_model.model."][k])
    pipe.vae_scale = 2
    video = pipe(prompt="a cat", height=8, width=8, frames=2, num_inference_steps=1)
    assert video.shape == (1, 2, 8, 8, 3) and bool(torch.isfinite(video).all())
