"""The port's BLIP towers and ImageReward model (rewards/blip.py), its BERT
tokenizer (utils/bert_tokenizer.py) and the `img_reward` training facade
against the JAX package's, on the CPU.

Weights are seeded numpy values in the ImageReward checkpoint's layout: the
port loads them strictly, the JAX package imports them with
`import_image_reward_params`. Configurations are the JAX tests' tiny towers
(tests/test_blip.py, tests/test_rewards.py): a ViT 32 wide, 2 layers, at
32 px in patches of 16; a BERT 24 wide, 2 layers, cross-attending to the
image states; the published head's five Linears, narrowed.

Tolerances (f32): features and scores within 1e-4 absolute, the gradients
with respect to the pixels within 1e-4 x their largest entry (~5e-3 here,
so tighter than 1e-4 absolute): the same ops summed in another order. The
tokenizers id for id.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.rewards import blip as jblip
from t2v_turbo_tpu.rewards import reward_fn as jrf
from t2v_turbo_tpu.utils.bert_tokenizer import BertWordPieceTokenizer as JaxBertTokenizer
from t2v_turbo_tpu_torch.rewards import blip as B
from t2v_turbo_tpu_torch.rewards import reward_fn as R
from t2v_turbo_tpu_torch.utils.bert_tokenizer import BertWordPieceTokenizer
from torch_parity import seeded_numpy_state_dict, to_torch

ATOL = 1e-4
VIT_KW = dict(image_size=32, patch_size=16, width=32, layers=2, heads=4)
BERT_KW = dict(vocab_size=30524, hidden=24, layers=2, heads=4, intermediate=48, max_position=40, encoder_width=32)
HEAD = (16, 8, 4, 2, 1)  # five Linears, as the published head: indices 0, 2, 4, 6, 7
TEXTS = ["a cat", "Waves crash at sunset, cinematic", "an astronaut rides a horse on the moon"]


@pytest.fixture(scope="module")
def models():
    """(port model, its ImageReward-keyed numpy state dict, the JAX model)."""
    port = B.ImageRewardModel(B.BlipViTConfig(**VIT_KW), B.BertConfig(**BERT_KW), HEAD)
    sd = seeded_numpy_state_dict(port, 50)
    port.load_image_reward(to_torch(sd))
    jax_rm = jblip.build_image_reward_blip(
        vit_cfg=jblip.BlipViTConfig(**VIT_KW), bert_cfg=jblip.BertConfig(**BERT_KW), head_dims=HEAD,
        weights=ti.import_image_reward_params(sd))
    return port, sd, jax_rm


def _assert_grad_close(grad, ref_grad):
    ref_grad = np.asarray(ref_grad)
    gmax = float(np.abs(ref_grad).max())
    assert gmax > 0
    np.testing.assert_allclose(grad.numpy(), ref_grad, atol=ATOL * gmax)


def _tokens():
    ids, mask = R._HashTokenizer(max_length=12, vocab_size=BERT_KW["vocab_size"])(TEXTS[:2])
    return ids, mask


def test_vit_matches_jax(models):
    port, _, jax_rm = models
    px = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    ref = np.asarray(jax.jit(jax_rm.vit.apply)(jax_rm.vit_params, jnp.asarray(px)))
    with torch.no_grad():
        got = port.blip.visual_encoder(torch.from_numpy(px)).numpy()
    assert got.shape == (2, 5, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("cross", [True, False], ids=["cross_attention_masked", "text_only_unmasked"])
def test_bert_matches_jax(models, cross):
    port, _, jax_rm = models
    ids, mask = _tokens()
    states = np.random.RandomState(2).randn(2, 5, 32).astype(np.float32)
    kw = dict(image_states=jnp.asarray(states), mask=jnp.asarray(mask)) if cross else {}
    ref = np.asarray(jax.jit(jax_rm.bert.apply)(jax_rm.bert_params, jnp.asarray(ids), **kw))
    with torch.no_grad():
        got = port.blip.text_encoder.bert(torch.from_numpy(ids), *(
            (torch.from_numpy(states), torch.from_numpy(mask)) if cross else ())).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_score_and_pixel_grad_match_jax(models):
    port, _, jax_rm = models
    ids, mask = _tokens()
    px = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)

    def total(x):
        s = jax_rm.score(x, jnp.asarray(ids), jnp.asarray(mask))
        return s.sum(), s

    (_, ref), ref_grad = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(px))
    x = torch.from_numpy(px).requires_grad_()
    scores = port.score(x, torch.from_numpy(ids), torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(scores.sum(), x)
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(ref), atol=ATOL)
    _assert_grad_close(grad, ref_grad)


def test_train_reward_matches_jax(models):
    """`BlipTrainReward`: the same token ids as JAX's (hashed, max length 35,
    integers), and its score (bicubic resize of [0, 1] frames to the ViT's
    size, CLIP normalisation, -relu(-r + 2)) and pixel gradient."""
    port, _, jax_rm = models
    jtrain, train = jrf.BlipTrainReward(jax_rm), R.BlipTrainReward(port)
    ids = train.encode_texts(TEXTS)
    assert ids.dtype == torch.int32 and ids.shape == (3, 35)
    np.testing.assert_array_equal(ids.numpy(), jtrain.encode_texts(TEXTS))
    ids = ids.remainder(BERT_KW["vocab_size"])
    imgs = np.random.RandomState(4).rand(3, 40, 64, 3).astype(np.float32)  # shrunk: the antialiased path
    jids = jnp.asarray(ids.numpy())
    ref, ref_grad = jax.jit(jax.value_and_grad(lambda x: jtrain.score(x, jids).sum()))(jnp.asarray(imgs))
    x = torch.from_numpy(imgs).requires_grad_()
    s = train.score(x, ids)
    (grad,) = torch.autograd.grad(s.sum(), x)
    assert s.shape == (3,) and bool((s <= 0).all())
    np.testing.assert_allclose(float(s.detach().sum()), float(ref), atol=ATOL)
    _assert_grad_close(grad, ref_grad)
    with pytest.raises(TypeError, match="token ids"):
        train.score(x, ids.float())


def test_checkpoint_layout_loads_strictly(models):
    port, sd, _ = models
    assert sorted({int(k.split(".")[2]) for k in sd if k.startswith("mlp.layers.")}) == [0, 2, 4, 6, 7]
    for key in ("blip.visual_encoder.blocks.1.attn.qkv.weight", "blip.visual_encoder.patch_embed.proj.bias",
                "blip.text_encoder.bert.encoder.layer.1.crossattention.self.key.weight",
                "blip.text_encoder.bert.embeddings.LayerNorm.bias"):
        assert key in sd
    port.load_image_reward(to_torch({**sd, "blip.text_encoder.bert.embeddings.position_ids": np.arange(40)[None]}))
    with pytest.raises(RuntimeError):
        port.load_image_reward(to_torch({**sd, "mlp.layers.1.weight": np.zeros((8, 16), np.float32)}))
    missing = dict(sd)
    missing.pop("blip.visual_encoder.norm.weight")
    with pytest.raises(RuntimeError):
        port.load_image_reward(to_torch(missing))
    built = R.get_reward_fn("img_reward", to_torch(sd), vit_cfg=B.BlipViTConfig(**VIT_KW),
                            bert_cfg=B.BertConfig(**BERT_KW), head_dims=HEAD)
    for k, v in built.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


VOCAB = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
    "a", "an", "the", "cat", "dog", "run", "##s", "##ning", "wave", "##s", "at", "sun", "##set", ",", ".", "!",
    "cafe", "naive", "astro", "##naut", "ride", "##s", "horse", "on", "moon", "中", "文", "x", "##y", "##z"]


@pytest.mark.parametrize("max_length", [35, 40, 6])
def test_bert_tokenizer_matches_jax(tmp_path, max_length):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    texts = ["A cat runs at sunset!", "The dog's running, naïve CAFÉ.", "astronaut rides the horse on the moon",
             "中文 text​with\ttabs and xyz", "unknownword " * 30, "", "Ünïcödé ﬁ ligature"]
    port, jax_tok = BertWordPieceTokenizer(str(vocab), max_length=max_length), JaxBertTokenizer(
        str(vocab), max_length=max_length)
    for got, ref in zip(port(texts), jax_tok(texts)):
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    assert port(texts)[0][0, :5].tolist()[:2] == [101, 104]  # [CLS], then "a"
    with pytest.raises(FileNotFoundError):
        BertWordPieceTokenizer(str(tmp_path / "missing.txt"))


def test_hash_tokenizer_matches_jax():
    texts = ["a cat", "An Astronaut riding a horse", "x " * 50]
    for n in (35, 40):
        for got, ref in zip(R._HashTokenizer(max_length=n)(texts), jrf._HashTokenizer(max_length=n)(texts)):
            np.testing.assert_array_equal(got, ref)
