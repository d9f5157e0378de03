"""Shared helpers for the tests that hold the PyTorch port (t2v_turbo_tpu_torch)
against the JAX package.

Weights and inputs come from seeded numpy; data crosses between the two
frameworks as numpy arrays. The tiny configurations are the ones the JAX
tests already use (tests/test_pipeline.py, tests/test_torch_import.py).
"""

import numpy as np
import torch

# The port's CPU tests run their tiny models on one intra-op thread. The
# suite runs several xdist workers on the machine's cores, and torch's
# default of one thread per core in every worker oversubscribes them: the
# trainer's checkpoint/resume test alone took 31 s on 8 threads and 9 s on
# one, and far longer beside five other busy workers.
torch.set_num_threads(1)

# tests/test_pipeline.py's tiny UNet / VAE / text tower
TINY_UNET_KW = dict(
    model_channels=32,
    num_res_blocks=1,
    attention_resolutions=(2, 1),
    channel_mult=(1, 2),
    num_head_channels=16,
    context_dim=16,
    time_cond_proj_dim=8,
)
TINY_VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
TINY_TEXT_KW = dict(vocab_size=50, width=16, heads=2, layers=3, context_length=8)
# tests/test_torch_import.py's golden UNet (context 24)
GOLDEN_UNET_KW = dict(TINY_UNET_KW, context_dim=24)
# tests/test_rewards.py's tiny reward towers
TINY_VIT_KW = dict(image_size=28, patch_size=14, width=32, layers=2, heads=4, output_dim=16)
TINY_REWARD_TEXT_KW = dict(vocab_size=60, width=32, heads=4, layers=2, context_length=8, penultimate=False)


class FakeTok:
    """tests/test_rewards.py's tokenizer: EOT (the largest id) at a text-dependent place."""

    def __call__(self, texts):
        out = np.zeros((len(texts), 8), np.int32)
        for i, t in enumerate(texts):
            n = min(len(t) % 5 + 2, 8)
            out[i, :n] = (np.arange(n) + len(t)) % 59 + 1
        return out


TEXTS = ["a cat", "waves at sunset", "an astronaut"]


def reward_model_pair(video: bool, quick_gelu: bool = False, num_frames: int = 4):
    """(port model, its open_clip / ViCLIP-keyed numpy state dict, the JAX
    reward model built from that state dict by the JAX importer)."""
    from t2v_turbo_tpu.io import torch_import as ti
    from t2v_turbo_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig
    from t2v_turbo_tpu.rewards import reward_fn as jrf
    from t2v_turbo_tpu.rewards import vit as jvit
    from t2v_turbo_tpu_torch.models.clip_text import CLIPTextConfig
    from t2v_turbo_tpu_torch.rewards import reward_fn as R
    from t2v_turbo_tpu_torch.rewards.vit import VideoViTConfig, ViTConfig

    tkw = dict(TINY_REWARD_TEXT_KW, quick_gelu=quick_gelu)
    if video:
        port = R.VideoRewardModel(VideoViTConfig(**TINY_VIT_KW, num_frames=num_frames), CLIPTextConfig(**tkw),
                                  tokenizer=FakeTok())
        sd = seeded_numpy_state_dict(port, 31)
        jax_rm = jrf.build_video_reward_model(
            weights=ti.import_viclip_params({**sd, "temp": np.float32(0.01)}), tokenizer=FakeTok(),
            vit_cfg=jvit.VideoViTConfig(**TINY_VIT_KW, num_frames=num_frames), text_cfg=JCLIPTextConfig(**tkw))
        port.load_viclip(to_torch({**sd, "temp": np.float32(0.01)}))
    else:
        port = R.ImageRewardModel(ViTConfig(**TINY_VIT_KW), CLIPTextConfig(**tkw), tokenizer=FakeTok())
        visual = seeded_numpy_state_dict(port.visual, 32)
        text = seeded_numpy_state_dict(port.text, 33)
        sd = {**{f"visual.{k}": v for k, v in visual.items()}, **text,
              "logit_scale": np.float32(np.log(50.0))}
        jax_rm = jrf.build_image_reward_model(
            weights=ti.import_openclip_params(sd), tokenizer=FakeTok(), vit_cfg=jvit.ViTConfig(**TINY_VIT_KW),
            text_cfg=JCLIPTextConfig(**tkw))
        port.load_open_clip(to_torch(sd))
    return port, sd, jax_rm


def numpy_state_dict(module):
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def seeded_numpy_state_dict(module, seed):
    """A state dict of the module's shapes filled from numpy with non-zero
    values: norm weights 1 + 0.1 N, vectors 0.1 N, matrices N / sqrt(fan_in)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        r = rng.randn(*shape).astype(np.float32)
        if len(shape) <= 1:
            is_norm_weight = k.endswith(".weight") and _is_norm(module, k)
            r = 1.0 + 0.1 * r if is_norm_weight else 0.1 * r
        else:
            r = r / np.sqrt(np.prod(shape[1:]))
        out[k] = r.astype(np.float32)
    return out


def _is_norm(module, key):
    from t2v_turbo_tpu_torch.models.layers import GroupNorm, LayerNorm
    from t2v_turbo_tpu_torch.rewards.internvideo2 import RMSNorm

    sub = module.get_submodule(key.rsplit(".", 1)[0])
    return isinstance(sub, (GroupNorm, LayerNorm, RMSNorm))


def to_torch(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def lcd_unet_pair(seed):
    """[(port student, JAX student, its params), (port teacher, JAX teacher,
    its params)] at tests/tinymodels.py's UNet, from seeded numpy weights."""
    from t2v_turbo_tpu.io import torch_import as ti
    from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
    from t2v_turbo_tpu.models import UNetModel as JUNet
    from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel
    from tinymodels import TINY_UNET_KW as JAX_TINY_KW

    port_kw = {k: v for k, v in JAX_TINY_KW.items() if k != "temporal_length"}
    out = []
    for i, tcp in enumerate((port_kw["time_cond_proj_dim"], None)):
        port = UNetModel(UNetConfig(**{**port_kw, "time_cond_proj_dim": tcp}))
        sd = seeded_numpy_state_dict(port, seed + i)
        port.load_state_dict(to_torch(sd), strict=True)
        jcfg = JUNetConfig(**{**JAX_TINY_KW, "time_cond_proj_dim": tcp})
        out.append((port, JUNet(cfg=jcfg), {"params": ti.import_unet_params(sd, jcfg)}))
    return out


def seeded_lora_factors(model, seed, rank):
    """Port-layout LoRA factors for every target of `model`, non-zero `up`s."""
    from t2v_turbo_tpu_torch import lora as L

    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in L.target_shapes(model).items():
        out[name] = {
            "down": torch.from_numpy(rng.randn(rank, *shape[1:]).astype(np.float32) / rank),
            "up": torch.from_numpy(0.1 * rng.randn(shape[0], rank, *([1] * (len(shape) - 2)))
                                   .astype(np.float32)),
        }
    return out


def jax_lcd_draws(key, jcfg, latents_shape):
    """The port's LCDDraws holding the draws JAX's `lcd_loss` takes from its
    key (t2v_turbo_tpu/training/lcd.py:86-109)."""
    import jax
    import jax.numpy as jnp

    from t2v_turbo_tpu_torch.training.lcd import LCDDraws

    b = latents_shape[0]
    k_idx, k_noise, k_w = jax.random.split(key, 3)
    return LCDDraws(
        index=torch.from_numpy(np.array(jax.random.randint(k_idx, (b,), 0, jcfg.num_ddim_timesteps))).long(),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, latents_shape, jnp.float32))),
        w=torch.from_numpy(np.array(jcfg.w_min + (jcfg.w_max - jcfg.w_min) * jax.random.uniform(k_w, (b,)))),
    )


def assert_lora_grads_close(got, ref):
    """Port factor gradients (converted to the JAX layout) against JAX's:
    each within 1e-3 x its largest entry, floored at f32 round-off of the
    largest gradient of all (1e-7 x gmax): the timestep-embedding path's
    gradient is zero in exact math in the tiny UNets (32 channels in 32
    GroupNorm groups cancel a per-channel shift), so both sides hold noise."""
    assert set(got) == set(ref)
    gmax = max(float(np.abs(np.asarray(f[n])).max()) for f in ref.values() for n in ("down", "up"))
    for k in ref:
        for n in ("down", "up"):
            r = np.asarray(ref[k][n])
            atol = max(1e-3 * float(np.abs(r).max()), 1e-7 * gmax)
            np.testing.assert_allclose(got[k][n], r, atol=atol, err_msg=f"{k} {n}")


def assert_no_zeros(sd):
    for k, v in sd.items():
        v = np.asarray(v)
        assert np.count_nonzero(v) == v.size, f"{k} holds zeros"
