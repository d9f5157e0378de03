"""The port's InternVideo2 reward (rewards/internvideo2.py, the `vi_clip2`
training facade) against the JAX package's on the CPU, and the CLI's
training step with both new rewards (`--reward-fn img_reward --video-rm-fn
vi_clip2 --tiny-model`) against the JAX package's reward fns.

Weights are seeded numpy values in the Stage2 checkpoint's layout: the port
loads them strictly, the JAX package imports them with
`import_internvideo2_params`. The tower is the JAX tests' tiny one
(tests/test_internvideo2.py): 2 frames at 28 px in patches of 14, 32 wide,
2 blocks; a BERT 24 wide, 2 layers, for the text.

Tolerances (f32): features and scores within 1e-4 absolute, the gradients
with respect to the pixels within 1e-4 x their largest entry; the CLI
step's reward terms within 1e-5 relative of the JAX reward fns' on the
step's own prediction, and the gradient with respect to that prediction
within 1e-3 x its largest entry, as tests/test_torch_reward_training.py
holds the LCD step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models.vae import AutoencoderKL as JVAE
from t2v_turbo_tpu.models.vae import VAEConfig as JVAEConfig
from t2v_turbo_tpu.rewards import blip as jblip
from t2v_turbo_tpu.rewards import internvideo2 as jiv2
from t2v_turbo_tpu.rewards import reward_fn as jrf
from t2v_turbo_tpu.training import reward_adapters as jra
from t2v_turbo_tpu_torch.apps import train_v1
from t2v_turbo_tpu_torch.rewards import internvideo2 as I
from t2v_turbo_tpu_torch.rewards import reward_fn as R
from t2v_turbo_tpu_torch.rewards.blip import BertConfig
from torch_parity import numpy_state_dict, seeded_numpy_state_dict, to_torch

ATOL = 1e-4
VISION_KW = dict(img_size=28, patch_size=14, width=32, depth=2, heads=4, mlp_hidden=48, num_frames=2,
                 clip_embed_dim=16, attn_pool_heads=4)
TEXT_KW = dict(vocab_size=30524, hidden=24, layers=2, heads=4, intermediate=48, max_position=40,
               cross_attention=False, encoder_width=24)
TEXTS = ["a cat", "waves crash at sunset, cinematic lighting"]


def _jax_model(sd, vision_kw, text_kw, embed_dim):
    return jiv2.build_internvideo2_reward(
        vision_cfg=jiv2.IV2VisionConfig(**vision_kw), text_cfg=jblip.BertConfig(**text_kw), embed_dim=embed_dim,
        weights=ti.import_internvideo2_params(sd))


@pytest.fixture(scope="module")
def models():
    """(port model, its Stage2-keyed numpy state dict, the JAX model)."""
    port = I.InternVideo2RewardModel(I.IV2VisionConfig(**VISION_KW), BertConfig(**TEXT_KW), embed_dim=8)
    sd = seeded_numpy_state_dict(port, 60)
    port.load_stage2(to_torch(sd))
    return port, sd, _jax_model(sd, VISION_KW, TEXT_KW, 8)


def test_vision_features_match_jax(models):
    port, _, jax_rm = models
    px = np.random.RandomState(1).randn(2, 2, 28, 28, 3).astype(np.float32)
    ref = np.asarray(jax.jit(jax_rm.vision.apply)(jax_rm.vision_params, jnp.asarray(px)))
    with torch.no_grad():
        got = port.vision_encoder(torch.from_numpy(px)).numpy()
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_text_features_match_jax(models):
    """The hashed ids (max length 40) with their mask, as JAX's facade
    makes them; and a tokenizer's (ids, mask) pair reaches the encoder
    with its mask."""
    port, _, jax_rm = models
    train = R.InternVideo2TrainReward(port, image_size=28)
    ids, mask = jrf._HashTokenizer(max_length=40)(TEXTS)  # what JAX's facade encodes
    ref = np.asarray(jax.jit(jax_rm.encode_texts_tokens)(jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(train.encode_texts(TEXTS).numpy(), ref, atol=ATOL)
    ids, mask = R._HashTokenizer(max_length=10)(TEXTS)
    with_mask = port.encode_texts_tokens(ids, mask)
    assert float((with_mask - port.encode_texts_tokens(ids)).abs().max()) > 1e-4
    port.tokenizer = lambda texts: R._HashTokenizer(max_length=10)(texts)
    try:
        torch.testing.assert_close(port.encode_texts(TEXTS), with_mask, rtol=0, atol=0)
    finally:
        port.tokenizer = None


@pytest.fixture(scope="module")
def score_case(models):
    """Videos in [0, 1] (shrunk to 28 px: the antialiased path), text
    features, and JAX's facade's scores and video gradient (one compile)."""
    port, _, jax_rm = models
    videos = np.random.RandomState(2).rand(2, 2, 40, 64, 3).astype(np.float32)
    feats = R.InternVideo2TrainReward(port, image_size=28).encode_texts(TEXTS)
    jtrain, jfeats = jrf.InternVideo2TrainReward(jax_rm, image_size=28), jnp.asarray(feats.numpy())

    def total(v):
        s = jtrain.score(v, jfeats)
        return s.sum(), s

    (_, ref), ref_grad = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(videos))
    return videos, feats, np.asarray(ref), np.asarray(ref_grad)


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_score_and_video_grad_match_jax(models, score_case, remat):
    """The facade's score and its gradient with respect to the frames; with
    remat on, each block recomputed in the backward, the same numbers."""
    port, _, _ = models
    videos, feats, ref, ref_grad = score_case
    port.vision_encoder.remat = remat
    try:
        x = torch.from_numpy(videos).requires_grad_()
        s = R.InternVideo2TrainReward(port, image_size=28).score(x, feats)
        (grad,) = torch.autograd.grad(s.sum(), x)
    finally:
        port.vision_encoder.remat = False
    np.testing.assert_allclose(s.detach().numpy(), ref, atol=ATOL)
    gmax = float(np.abs(ref_grad).max())
    assert gmax > 0
    np.testing.assert_allclose(grad.numpy(), ref_grad, atol=ATOL * gmax)


def test_checkpoint_layout_loads_strictly(models):
    port, sd, _ = models
    for key in ("vision_encoder.blocks.1.attn.q_norm.weight", "vision_encoder.blocks.0.ls1.gamma",
                "vision_encoder.clip_projector.cross_attn.v_bias",
                "text_encoder.bert.encoder.layer.1.output.dense.bias", "vision_proj.weight", "text_proj.bias"):
        assert key in sd
    patch = "vision_encoder.patch_embed.proj.weight"
    assert sd[patch].shape == (32, 3, 1, 14, 14)  # the reference's tubelet-1 Conv3d
    port.load_stage2(to_torch({**sd, "temp": np.float32(0.07), patch: sd[patch][:, :, 0]}))  # 4-D accepted
    np.testing.assert_array_equal(port.state_dict()[patch].numpy(), sd[patch])
    with pytest.raises(RuntimeError):
        port.load_stage2(to_torch({**sd, "vision_encoder.blocks.1.attn.q_bias": np.zeros(32, np.float32)}))
    missing = dict(sd)
    missing.pop("vision_encoder.blocks.1.ls2.gamma")
    with pytest.raises(RuntimeError):
        port.load_stage2(to_torch(missing))
    built = R.get_reward_fn("vi_clip2", to_torch(sd), vision_cfg=I.IV2VisionConfig(**VISION_KW),
                            text_cfg=BertConfig(**TEXT_KW), embed_dim=8)
    assert isinstance(built, I.InternVideo2RewardModel)
    for k, v in built.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_cli_reward_step_matches_jax(tmp_path):
    """One step of `train_v1 --tiny-model --reward-fn img_reward --video-rm-fn
    vi_clip2`: BLIP's token ids stay int32 from the batch to its text
    branch; the step's reward_loss and video_rm_loss equal the masked means
    of the JAX package's reward fns (BlipTrainReward, InternVideo2TrainReward
    behind make_image_reward_fn / make_video_reward_fn, on the same VAE and
    towers) at the step's own prediction, and so does their gradient with
    respect to it."""
    args = train_v1.parse_args(["--tiny-model", "--synthetic-data", "--random-weights", "--device", "cpu",
                                "--output-dir", str(tmp_path), "--lora-rank", "4", "--max-steps", "1",
                                "--reward-fn", "img_reward", "--video-rm-fn", "vi_clip2"])
    trainer, data, _ = train_v1.build_trainer(args)
    host = next(data)
    assert host["reward_text_feats"].dtype == np.int32 and host["reward_text_feats"].shape == (4, 35)
    assert host["video_text_feats"].dtype == np.float32 and host["video_text_feats"].shape == (4, 16)
    seen, fns = {}, (trainer.reward_fn, trainer.video_reward_fn)

    def spy(i):
        def fn(model_pred, batch):
            seen.setdefault("pred", model_pred.detach().clone())
            seen.setdefault("batch", batch)
            return fns[i](model_pred, batch)
        return fn

    trainer.reward_fn, trainer.video_reward_fn = spy(0), spy(1)
    metrics = trainer.step_once(host)
    assert seen["batch"]["reward_text_feats"].dtype == torch.int32

    cpu = torch.device("cpu")
    vae, image_rm, video_rm = (train_v1.build_vae(args, cpu, torch.float32), train_v1.build_image_reward(args, cpu),
                               train_v1.build_video_reward(args, cpu))
    jvae = JVAE(cfg=JVAEConfig(**train_v1.TINY_VAE_KW))
    vae_params = {"params": ti.import_vae_params(numpy_state_dict(vae), n_levels=2, n_res=1)}
    jblip_rm = jblip.build_image_reward_blip(
        vit_cfg=jblip.BlipViTConfig(**train_v1.TINY_BLIP_VIT_KW), bert_cfg=jblip.BertConfig(**train_v1.TINY_BERT_KW),
        head_dims=(8, 1), weights=ti.import_image_reward_params(numpy_state_dict(image_rm.rm)))
    jiv2_rm = _jax_model(numpy_state_dict(video_rm.rm), train_v1.TINY_IV2_KW,
                         {**train_v1.TINY_BERT_KW, "cross_attention": False}, 16)
    rf = jra.make_image_reward_fn(jvae, vae_params, jrf.BlipTrainReward(jblip_rm), decode_chunk=16)
    vrf = jra.make_video_reward_fn(jvae, vae_params, jrf.InternVideo2TrainReward(jiv2_rm, image_size=28),
                                   decode_chunk=16)
    jbatch = {k: jnp.asarray(v) for k, v in host.items() if not k.startswith("_")}

    def masked(pred):
        terms = [-(fn(pred, jbatch) * jbatch[m]).sum() / jbatch[m].sum()
                 for fn, m in ((rf, "reward_mask"), (vrf, "video_reward_mask"))]
        return terms[0] + terms[1], terms

    (_, ref_terms), ref_grad = jax.jit(jax.value_and_grad(masked, has_aux=True))(jnp.asarray(seen["pred"].numpy()))
    for name, ref in zip(("reward_loss", "video_rm_loss"), ref_terms):
        assert float(ref) != 0
        np.testing.assert_allclose(float(metrics[name]), float(ref), rtol=1e-5, err_msg=name)

    pred = seen["pred"].clone().requires_grad_()
    batch = {k: v for k, v in seen["batch"].items()}
    total = sum(-(fn(pred, batch) * batch[m]).sum() / batch[m].sum()
                for fn, m in zip(fns, ("reward_mask", "video_reward_mask")))
    (grad,) = torch.autograd.grad(total, pred)
    ref_grad = np.asarray(ref_grad)
    gmax = float(np.abs(ref_grad).max())
    assert gmax > 0
    np.testing.assert_allclose(grad.numpy(), ref_grad, atol=1e-3 * gmax)


@pytest.mark.parametrize("flags", [["--reward-fn", "img_reward", "--reward-ckpt", "ImageReward.pt"],
                                   ["--video-rm-fn", "vi_clip2", "--video-rm-ckpt", "stage2.pt"]])
def test_cli_refuses_a_bert_checkpoint_without_its_vocab(tmp_path, flags):
    """A BERT tower loading real weights never falls back to the hashed
    token ids: the build stops before the checkpoint is read."""
    args = train_v1.parse_args(["--tiny-model", "--synthetic-data", "--random-weights", "--device", "cpu",
                                "--output-dir", str(tmp_path), *flags])
    with pytest.raises(SystemExit, match="--bert-vocab"):
        train_v1.build_trainer(args)
