"""The port's reward models (rewards/, models/clip_text.py's pooled tower)
against the JAX package's, on the CPU.

Weights are seeded numpy values in the reference checkpoints' layout
(open_clip's `visual.*` and text keys with `logit_scale`, ViCLIP's
`vision_encoder.*` / `text_encoder.*`): the port loads them strictly, the
JAX package imports them with its own key tables
(t2v_turbo_tpu/io/torch_import.py), and the port's `io/convert.py` must turn
the JAX trees back into exactly the same state dicts. Configurations are
the JAX reward tests' tiny towers (tests/test_rewards.py).

Tolerances (f32): tower outputs and scores 1e-5 absolute (values of O(1),
sums of at most 128 terms in another order); gradients with respect to the
pixels 1e-5 x their largest entry (a chain of the same ops, backwards);
`preprocess_images` 1e-5 in [0, 1] pixel units, before the division by
CLIP's std (~0.27) (the antialiased bicubic resize; the default
`F.interpolate` is off by ~0.5 at 320x512).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu.rewards import reward_fn as jrf
from t2v_turbo_tpu_torch.io import convert
from t2v_turbo_tpu_torch.models.clip_text import CLIPTextConfig
from t2v_turbo_tpu_torch.rewards import reward_fn as R
from t2v_turbo_tpu_torch.rewards.vit import VideoViTConfig, ViTConfig
from torch_parity import (TEXTS, TINY_REWARD_TEXT_KW as TEXT_KW, TINY_VIT_KW as VIT_KW, FakeTok,
                          reward_model_pair, to_torch)

ATOL = 1e-5


@pytest.fixture(scope="module")
def image_models():
    return reward_model_pair(video=False)


@pytest.fixture(scope="module")
def video_models():
    return reward_model_pair(video=True, quick_gelu=True)


@pytest.mark.parametrize("shape,size", [((2, 320, 512, 3), 224), ((3, 16, 24, 3), 28), ((1, 2, 40, 64, 3), 28)],
                         ids=["320x512_to_224", "tiny_upsample", "video_tiny_downsample"])
def test_preprocess_matches_jax_resize(shape, size):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    ref = np.asarray(jrf.preprocess_images(jnp.asarray(x), size=size))
    got = R.preprocess_images(torch.from_numpy(x), size=size).numpy()
    assert got.shape == ref.shape == shape[:-3] + (size, size, 3)
    std = np.asarray(R.CLIP_STD, np.float32)
    np.testing.assert_allclose(got * std, ref * std, atol=ATOL)


def test_vision_tower_matches_jax(image_models):
    port, sd, jax_rm = image_models
    px = np.random.RandomState(1).randn(2, 28, 28, 3).astype(np.float32)
    ref = np.asarray(jax_rm.vision.apply(jax_rm.vision_params, jnp.asarray(px)))
    with torch.no_grad():
        got = port.visual(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # the JAX tree converts back to exactly the loaded weights
    back = convert.vit_state_dict_from_jax(jax_rm.vision_params)
    assert set(back) == {k[len("visual."):] for k in sd if k.startswith("visual.")}
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[f"visual.{k}"], err_msg=k)


@pytest.mark.parametrize("frames", [4, 1], ids=["T4", "T1_mean_temporal_pos"])
def test_video_tower_matches_jax(video_models, frames):
    port, sd, jax_rm = video_models
    px = np.random.RandomState(2).randn(2, frames, 28, 28, 3).astype(np.float32)
    ref = np.asarray(jax_rm.vision.apply(jax_rm.vision_params, jnp.asarray(px)))
    with torch.no_grad():
        got = port.vision_encoder(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    back = convert.video_vit_state_dict_from_jax(jax_rm.vision_params)
    assert back["conv1.weight"].shape == (32, 3, 1, 14, 14)  # the reference's Conv3d
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[f"vision_encoder.{k}"], err_msg=k)


@pytest.mark.parametrize("which", ["image_open_clip", "video_viclip_quick_gelu"])
def test_pooled_text_tower_matches_jax(image_models, video_models, which):
    port, sd, jax_rm = image_models if which.startswith("image") else video_models
    tower = port.text_tower()
    tokens = FakeTok()(TEXTS)
    ref = np.asarray(jax_rm.text.apply(jax_rm.text_params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tower(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(port.encode_texts(TEXTS).numpy(), np.asarray(jax_rm.encode_texts(TEXTS)),
                               atol=ATOL)
    back = convert.clip_text_pooled_state_dict_from_jax(jax_rm.text_params)
    prefix = "" if which.startswith("image") else "text_encoder."
    assert set(back) == {k for k in tower.state_dict()}
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[prefix + k], err_msg=k)


def _score_and_grad(port, jax_rm, pixels):
    feats = port.encode_texts(TEXTS[:2])
    jfeats = jnp.asarray(feats.numpy())

    def total(x):
        s = jax_rm.score(x, jfeats)
        return s.sum(), s

    (_, ref_scores), ref_grad = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(pixels))
    x = torch.from_numpy(pixels).requires_grad_()
    scores = port.score(x, feats)
    (grad,) = torch.autograd.grad(scores.sum(), x)
    return scores.detach().numpy(), np.asarray(ref_scores), grad.numpy(), np.asarray(ref_grad)


@pytest.mark.parametrize("which", ["image", "video"])
def test_scores_and_pixel_grads_match_jax(image_models, video_models, which):
    video = which == "video"
    port, _, jax_rm = video_models if video else image_models
    shape = (2, 4, 40, 64, 3) if video else (2, 40, 64, 3)  # downsampled to 28: the antialiased path
    pixels = np.random.RandomState(3).rand(*shape).astype(np.float32)
    got, ref, grad, ref_grad = _score_and_grad(port, jax_rm, pixels)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert np.abs(ref_grad).max() > 0
    np.testing.assert_allclose(grad, ref_grad, atol=1e-5 * float(np.abs(ref_grad).max()))
    if not video:
        np.testing.assert_allclose(port.score(torch.from_numpy(pixels), port.encode_texts(TEXTS[:2]),
                                              logits=True).detach().numpy(), 50.0 * got, rtol=1e-5)


def test_checkpoints_load_strictly(image_models, video_models):
    """Each checkpoint layout loads with nothing missing and nothing left
    over: an extra or a missing key raises."""
    for port, sd, _ in (image_models, video_models):
        load = port.load_open_clip if isinstance(port, R.ImageRewardModel) else port.load_viclip
        load(to_torch(sd))
        with pytest.raises(RuntimeError):
            load(to_torch({**sd, "visual.extra": np.zeros(1, np.float32)}))
        missing = dict(sd)
        missing.pop(next(k for k in sd if k.endswith("ln_post.weight")))
        with pytest.raises(RuntimeError):
            load(to_torch(missing))


def test_get_reward_fn_names():
    kw = dict(vit_cfg=ViTConfig(**VIT_KW), text_cfg=CLIPTextConfig(**TEXT_KW), tokenizer=FakeTok())
    for name in ("clip", "hpsv2", "pick"):
        assert isinstance(R.get_reward_fn(name, **kw), R.ImageRewardModel)
    vkw = dict(kw, vit_cfg=VideoViTConfig(**VIT_KW, num_frames=4))
    assert isinstance(R.get_reward_fn("vi_clip", **vkw), R.VideoRewardModel)
    weighted = R.get_reward_fn("weighted_hpsv2_clip", **kw)
    images = torch.rand(2, 28, 28, 3)
    assert weighted(images, TEXTS[:2]).shape == (2,)
    from t2v_turbo_tpu_torch.rewards import blip, internvideo2

    ir = R.get_reward_fn("img_reward", vit_cfg=blip.BlipViTConfig(image_size=32, patch_size=16, width=32, layers=1,
                                                                  heads=4),
                         bert_cfg=blip.BertConfig(vocab_size=60, hidden=24, layers=1, heads=4, intermediate=48,
                                                  max_position=16), head_dims=(8, 1))
    assert isinstance(ir, blip.ImageRewardModel)
    v2 = R.get_reward_fn("vi_clip2", vision_cfg=internvideo2.IV2VisionConfig(
        img_size=28, patch_size=14, width=32, depth=1, heads=4, mlp_hidden=48, num_frames=2, clip_embed_dim=16,
        attn_pool_heads=4), text_cfg=blip.BertConfig(vocab_size=60, hidden=24, layers=1, heads=4, intermediate=48,
                                                     max_position=16, cross_attention=False), embed_dim=8)
    assert isinstance(v2, internvideo2.InternVideo2RewardModel)
    with pytest.raises(ValueError):
        R.get_reward_fn("nope")


def _hf_layout(sd):
    """The open_clip-keyed state dict in HF transformers' CLIPModel layout
    (PickScore's): q, k, v unpacked, the projections as Linear weights,
    and the `position_ids` buffers HF keeps."""
    out = {"logit_scale": sd["logit_scale"], "text_projection.weight": sd["text_projection"].T,
           "visual_projection.weight": sd["visual.proj"].T,
           "text_model.embeddings.token_embedding.weight": sd["token_embedding.weight"],
           "text_model.embeddings.position_embedding.weight": sd["positional_embedding"],
           "text_model.embeddings.position_ids": np.arange(8)[None],
           "vision_model.embeddings.patch_embedding.weight": sd["visual.conv1.weight"],
           "vision_model.embeddings.class_embedding": sd["visual.class_embedding"],
           "vision_model.embeddings.position_embedding.weight": sd["visual.positional_embedding"]}
    for oc, hf in (("ln_final", "text_model.final_layer_norm"), ("visual.ln_pre", "vision_model.pre_layrnorm"),
                   ("visual.ln_post", "vision_model.post_layernorm")):
        for n in ("weight", "bias"):
            out[f"{hf}.{n}"] = sd[f"{oc}.{n}"]
    for oc, hf in (("transformer", "text_model"), ("visual.transformer", "vision_model")):
        for i in range(TEXT_KW["layers"]):
            src, dst = f"{oc}.resblocks.{i}", f"{hf}.encoder.layers.{i}"
            for n in ("weight", "bias"):
                for p, part in zip("qkv", np.split(sd[f"{src}.attn.in_proj_{n}"], 3)):
                    out[f"{dst}.self_attn.{p}_proj.{n}"] = part
                for o, h in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"), ("attn.out_proj", "self_attn.out_proj"),
                             ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
                    out[f"{dst}.{h}.{n}"] = sd[f"{src}.{o}.{n}"]
    return out


def test_hf_clip_checkpoint_loads_strictly_and_matches_jax(image_models):
    """PickScore's HF CLIPModel layout: `load_hf_clip` gives the weights the
    open_clip load gives, scores as the JAX package's model built by
    `import_hf_clip_params` from the same dict, and refuses a missing or an
    extra key."""
    from t2v_turbo_tpu.io import torch_import as ti
    from t2v_turbo_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig
    from t2v_turbo_tpu.rewards import vit as jvit

    port, sd, _ = image_models
    hf = _hf_layout(sd)
    loaded = R.build_image_reward_model(to_torch(hf), vit_cfg=ViTConfig(**VIT_KW), text_cfg=CLIPTextConfig(**TEXT_KW),
                                        tokenizer=FakeTok())
    for k, v in port.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0, msg=k)
    jax_rm = jrf.build_image_reward_model(
        weights=ti.import_hf_clip_params({k: np.asarray(v) for k, v in hf.items()}), tokenizer=FakeTok(),
        vit_cfg=jvit.ViTConfig(**VIT_KW), text_cfg=JCLIPTextConfig(**TEXT_KW))
    pixels = np.random.RandomState(5).rand(2, 40, 64, 3).astype(np.float32)
    feats = loaded.encode_texts(TEXTS[:2])
    np.testing.assert_allclose(feats.numpy(), np.asarray(jax_rm.encode_texts(TEXTS[:2])), atol=ATOL)
    np.testing.assert_allclose(loaded.score(torch.from_numpy(pixels), feats).detach().numpy(),
                               np.asarray(jax_rm.score(jnp.asarray(pixels), jnp.asarray(feats.numpy()))), atol=ATOL)
    with pytest.raises(RuntimeError, match="outside"):
        loaded.load_hf_clip(to_torch({**hf, "vision_model.extra.weight": np.zeros(1, np.float32)}))
    missing = dict(hf)
    missing.pop("vision_model.post_layernorm.bias")
    with pytest.raises(KeyError):
        loaded.load_hf_clip(to_torch(missing))
