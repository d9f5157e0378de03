"""The ModelScope backbone in the port (models/unet_ms.py, pipelines/ms.py,
io/ms.py, io/lora_import.py's MS half, generate --backbone ms) against the
JAX package's, on the CPU, in f32.

- the MS UNet against tests/goldens/ms_unet_tiny.npz (tests/ms_oracle.py's
  diffusers block math) at PARITY.md's 2e-4, its state dict loading
  strictly;
- the MS UNet against the JAX UNet on shared seeded weights through
  `import_ms_unet_params`, at 2e-4;
- the diffusers-VAE rename: the golden VAE's original-layout state dict,
  renamed to diffusers' as tests/test_ms_components.py does, comes back to
  the bit, loads strictly, and JAX's `import_diffusers_vae_params` of the
  diffusers dict equals its `import_vae_params` of ours;
- the HF CLIPTextModel tower (transformers' own, both gelu variants)
  against `import_hf_clip_text_model_params`' JAX tower, at 2e-5;
- the safetensors reader against the `safetensors` package on F32, F16,
  BF16, I64, a scalar and an empty tensor, to the bit;
- `load_ms_components` on a small folder written here (a .safetensors UNet
  with 1x1-conv projections, a diffusers VAE, an HF text tower and its
  config.json), through generate's `build_ms_pipeline`, against JAX's loader;
- the MS LoRA order against JAX's and the fold against `apply_lora_pt_ms`
  (the two trees to 1e-5);
- a tiny generate --backbone ms pipeline against the JAX MS pipeline, with
  the JAX scan's renoise draws fed in, at the VAE's 3e-4 on the video.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import goldens
import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu.diffusion import DiffusionSchedule as JSchedule
from t2v_turbo_tpu.io import lora_import as jlora
from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models.clip_text import CLIPTextConfig as JTextConfig
from t2v_turbo_tpu.models.clip_text import CLIPTextModel as JText
from t2v_turbo_tpu.models.unet_ms import MSUNet3DConditionModel as JMSUNet
from t2v_turbo_tpu.models.unet_ms import MSUNetConfig as JMSConfig
from t2v_turbo_tpu.models.vae import AutoencoderKL as JVAE
from t2v_turbo_tpu.models.vae import VAEConfig as JVAEConfig
from t2v_turbo_tpu.pipelines.ms import T2VTurboMSPipeline as JMSPipeline
from t2v_turbo_tpu.utils.tokenizer import CLIPTokenizer as JTokenizer
from t2v_turbo_tpu_torch.apps import generate
from t2v_turbo_tpu_torch.io import lora_import, ms
from t2v_turbo_tpu_torch.models import AutoencoderKL, CLIPTextConfig, CLIPTextModel, VAEConfig
from t2v_turbo_tpu_torch.models.unet_ms import MSUNet3DConditionModel, MSUNetConfig
from t2v_turbo_tpu_torch.rewards.reward_fn import hf_clip_text_to_open_clip
from test_ms_components import _orig_to_diffusers_names
from test_torch_pipeline import _jax_scan_noise
from torch_parity import TINY_VAE_KW, seeded_numpy_state_dict, to_torch

TINY = dict(block_out_channels=(32, 64), layers_per_block=1, attention_head_dim=16, cross_attention_dim=24,
            time_cond_proj_dim=8)
LEVELS = dict(layers_per_block=1, n_levels=2)


def _tree_close(a, b, atol, path=()):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b))[:5])
        for k in a:
            _tree_close(a[k], b[k], atol, path + (k,))
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, err_msg=str(path))


def test_ms_unet_matches_the_golden():
    g = goldens.load("ms_unet_tiny")
    model = MSUNet3DConditionModel(MSUNetConfig(**TINY)).eval()
    model.load_state_dict(to_torch(goldens.subdict(g, "sd")), strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(g["in.x"].transpose(0, 2, 3, 4, 1)), torch.from_numpy(g["in.ts"]),
                  torch.from_numpy(g["in.ctx"]), timestep_cond=torch.from_numpy(g["in.w"]))
    np.testing.assert_allclose(y.numpy().transpose(0, 4, 1, 2, 3), g["out.y"], atol=2e-4, rtol=1e-3)


def test_ms_unet_matches_jax_on_shared_weights():
    model = MSUNet3DConditionModel(MSUNetConfig(**TINY)).eval()
    sd = seeded_numpy_state_dict(model, 120)
    model.load_state_dict(to_torch(sd), strict=True)
    rng = np.random.RandomState(121)
    x, ctx, w = rng.randn(2, 4, 8, 8, 4), rng.randn(2, 7, 24), rng.randn(2, 8)
    ts = np.array([17, 903])
    want = jax.jit(JMSUNet(cfg=JMSConfig(**TINY)).apply)(
        {"params": ti.import_ms_unet_params(sd, **LEVELS)}, *(jnp.asarray(a, jnp.float32) for a in (x, ts, ctx)),
        timestep_cond=jnp.asarray(w, jnp.float32))
    with torch.no_grad():
        got = model(*(torch.tensor(a, dtype=torch.float32) for a in (x, ts, ctx)),
                    timestep_cond=torch.tensor(w, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    with torch.device("meta"):
        n = sum(p.numel() for p in MSUNet3DConditionModel(MSUNetConfig(time_cond_proj_dim=256)).parameters())
    assert 1.2e9 < n < 1.6e9  # JAX's bound for the full config


def _diffusers_vae(orig_sd):
    """tests/test_ms_components.py's diffusers-layout VAE (Linear mid attention)."""
    out = {}
    for k, v in _orig_to_diffusers_names(orig_sd, n_levels=2).items():
        out[k] = v[:, :, 0, 0] if ".attentions.0.to_" in k and k.endswith(".weight") and v.ndim == 4 else v
    return out


def test_diffusers_vae_rename_matches_jax():
    orig = goldens.subdict(goldens.load("vc2_vae_tiny"), "sd")
    diff = _diffusers_vae(orig)
    got = ms.diffusers_vae_to_orig(to_torch(diff))
    assert set(got) == set(orig)
    for k, v in orig.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    AutoencoderKL(VAEConfig(**TINY_VAE_KW)).load_state_dict(got, strict=True)
    _tree_close(ti.import_diffusers_vae_params(diff),
                ti.import_vae_params({k: v.numpy() for k, v in got.items()}, n_levels=2, n_res=1), 0.0)


def _hf_text(act, seed):
    from transformers import CLIPTextConfig as HFCfg
    from transformers import CLIPTextModel as HFText

    torch.manual_seed(seed)
    return HFText(HFCfg(vocab_size=64, hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=2, max_position_embeddings=16, hidden_act=act)).eval()


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_hf_text_tower_matches_jax(act):
    hf = _hf_text(act, 122)
    sd = hf.state_dict()
    cfg = ms.hf_clip_text_config(sd, {"hidden_act": act, "num_attention_heads": 2})
    assert (cfg.layers, cfg.width, cfg.heads, cfg.context_length, cfg.penultimate, cfg.quick_gelu) == (
        2, 32, 2, 16, False, act == "quick_gelu")
    tower = CLIPTextModel(cfg).eval()
    tower.load_state_dict(hf_clip_text_to_open_clip(sd), strict=True)
    params, kw = ti.import_hf_clip_text_model_params({k: v.numpy() for k, v in sd.items()},
                                                     quick_gelu=act == "quick_gelu")
    tokens = np.random.RandomState(123).randint(0, 64, size=(2, 16))
    want = jax.jit(JText(cfg=JTextConfig(**dict(kw, heads=2))).apply)({"params": params},
                                                                       jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = tower(torch.from_numpy(tokens))
        ref = hf(input_ids=torch.from_numpy(tokens)).last_hidden_state
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=1e-4)


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(124)
    tensors = {"f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
               "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(), "i64": torch.arange(-3, 9).view(3, 4),
               "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "w.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = ms.read_safetensors(path), load_file(path)
    assert set(got) == set(want) == set(tensors)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    assert ms.load_state_dict_any(path).keys() == got.keys()
    with open(tmp_path / "bad.safetensors", "wb") as f:
        f.write((10**6).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="runs past"):
        ms.read_safetensors(str(tmp_path / "bad.safetensors"))


def _lora_list(cfg, model, rank, seed, scale=0.05):
    """A [up, down, ...] list in the MS order, shaped from the modules."""
    rng = np.random.RandomState(seed)
    out = []
    for name, kind in lora_import.lora_module_order_ms(cfg):
        w = model.get_submodule(name).weight
        tail = (1,) * (w.dim() - 2)
        out += [torch.from_numpy(scale * rng.randn(w.shape[0], rank, *tail).astype(np.float32)),
                torch.from_numpy(scale * rng.randn(rank, *w.shape[1:]).astype(np.float32))]
    return out


def test_ms_lora_order_and_fold_match_jax():
    for kw in (dict(time_cond_proj_dim=256), {}, TINY):
        cfg = MSUNetConfig(**kw)
        assert lora_import.lora_module_order_ms(cfg) == jlora.lora_module_order_ms(JMSConfig(**kw))
    assert len(lora_import.lora_module_order_ms(MSUNetConfig(time_cond_proj_dim=256))) == 575
    model = MSUNet3DConditionModel(MSUNetConfig(**TINY))
    sd = seeded_numpy_state_dict(model, 125)
    weights = _lora_list(MSUNetConfig(**TINY), model, 4, 126)
    got = lora_import.apply_lora_pt_ms(to_torch(sd), weights, MSUNetConfig(**TINY))
    want = jlora.apply_lora_pt_ms({"params": ti.import_ms_unet_params(sd, **LEVELS)},
                                  [w.numpy() for w in weights], JMSConfig(**TINY))
    _tree_close(ti.import_ms_unet_params({k: v.numpy() for k, v in got.items()}, **LEVELS), want["params"], 1e-5)
    assert any(not np.array_equal(got[k].numpy(), sd[k]) for k in sd)
    with pytest.raises(ValueError, match="expected"):
        lora_import.apply_lora_pt_ms(to_torch(sd), weights[:-2], MSUNetConfig(**TINY))


def test_load_ms_components_and_generate_from_the_folder(tmp_path):
    """A small diffusers folder: unet/ as .safetensors with 1x1-conv
    projections and no cond_proj (a teacher), vae/ in diffusers' names,
    text_encoder/ an HF tower with config.json; generate --backbone ms
    --ms-dir loads every module strictly (cond_proj zero-filled) with the
    LoRA folded in, and JAX's loader reads the same weights."""
    from safetensors.torch import save_file

    teacher_cfg = MSUNetConfig(**dict(TINY, time_cond_proj_dim=None))
    teacher = MSUNet3DConditionModel(teacher_cfg)
    unet_sd = seeded_numpy_state_dict(teacher, 127)
    as_conv = {k: (v[:, :, None, None] if k.endswith(("proj_in.weight", "proj_out.weight")) and ".attentions." in k
                   else v) for k, v in unet_sd.items()}
    assert any(v.ndim == 4 and "proj_in" in k for k, v in as_conv.items())
    for sub in ("unet", "vae", "text_encoder"):
        os.makedirs(tmp_path / sub)
    save_file(to_torch(as_conv), str(tmp_path / "unet" / "diffusion_pytorch_model.safetensors"))
    orig_vae = goldens.subdict(goldens.load("vc2_vae_tiny"), "sd")
    torch.save(to_torch(_diffusers_vae(orig_vae)), tmp_path / "vae" / "diffusion_pytorch_model.bin")
    hf = _hf_text("gelu", 128)
    torch.save(hf.state_dict(), tmp_path / "text_encoder" / "pytorch_model.bin")
    with open(tmp_path / "text_encoder" / "config.json", "w") as f:
        json.dump({"hidden_act": "gelu", "num_attention_heads": 2}, f)

    ucfg = MSUNetConfig(**TINY)
    lora = _lora_list(ucfg, MSUNet3DConditionModel(ucfg), 4, 129)
    torch.save(lora, tmp_path / "unet_lora.pt")
    with pytest.raises(SystemExit):
        generate.build_pipeline(generate.parse_args(["--prompt", "x", "--backbone", "ms", "--device", "cpu"]))
    args = generate.parse_args(["--prompt", "x", "--backbone", "ms", "--ms-dir", str(tmp_path), "--device", "cpu",
                                "--lora-ckpt", str(tmp_path / "unet_lora.pt")])
    pipe = generate.build_ms_pipeline(args, unet_cfg=ucfg, vae_cfg=VAEConfig(**TINY_VAE_KW))
    assert pipe.text_model.cfg.quick_gelu is False and pipe.text_model.cfg.layers == 2

    base = {**unet_sd, "time_embedding.cond_proj.weight": np.zeros((32, 8), np.float32)}
    want_unet = lora_import.apply_lora_pt_ms(to_torch(base), lora, ucfg)
    got_unet = pipe.unet.state_dict()
    assert set(got_unet) == set(want_unet)
    for k, v in want_unet.items():
        torch.testing.assert_close(got_unet[k], v, rtol=0, atol=0)
    jcomps = ti.load_ms_components(str(tmp_path), unet_kwargs=LEVELS)
    _tree_close(jcomps["unet"], ti.import_ms_unet_params(unet_sd, **LEVELS), 0.0)
    _tree_close(jcomps["vae"], ti.import_vae_params(
        {k: v.numpy() for k, v in pipe.vae.state_dict().items()}, n_levels=2, n_res=1), 0.0)
    _tree_close(jcomps["text"], ti.import_clip_text_params(
        {k: v.numpy() for k, v in pipe.text_model.state_dict().items()}, layers=2, penultimate=False), 0.0)
    assert jcomps["text_cfg"]["quick_gelu"] is False


def test_generate_ms_matches_the_jax_pipeline():
    """generate's seeded MS pipeline (tiny configs; the CLIP tokenizer) and
    the JAX MS pipeline on its weights: 2 steps from the same latents, the
    JAX scan's renoise draw fed in; the call's size defaults are 256x256."""
    args = generate.parse_args(["--prompt", "a cat", "--backbone", "ms", "--random-weights", "--seed", "5",
                                "--device", "cpu"])
    ucfg = MSUNetConfig(**dict(TINY, time_cond_proj_dim=256))
    tcfg = CLIPTextConfig(width=24, heads=4, layers=2, penultimate=False)
    pipe = generate.build_ms_pipeline(args, unet_cfg=ucfg, vae_cfg=VAEConfig(**TINY_VAE_KW), text_cfg=tcfg)
    pipe.vae_scale = 2
    sds = [{k: v.numpy() for k, v in m.state_dict().items()} for m in (pipe.unet, pipe.vae, pipe.text_model)]
    ref = JMSPipeline(
        unet=JMSUNet(cfg=JMSConfig(**dict(TINY, time_cond_proj_dim=256))),
        unet_params={"params": ti.import_ms_unet_params(sds[0], **LEVELS)},
        vae=JVAE(cfg=JVAEConfig(**TINY_VAE_KW)), vae_params={"params": ti.import_vae_params(sds[1], 2, 1)},
        text_model=JText(cfg=JTextConfig(width=24, heads=4, layers=2, penultimate=False)),
        text_params={"params": ti.import_clip_text_params(sds[2], layers=2, penultimate=False)},
        tokenizer=JTokenizer(), schedule=JSchedule.create(), vae_scale=2, dtype=jnp.float32)
    lat = np.random.RandomState(130).randn(1, 4, 4, 4, 4).astype(np.float32)
    key = jax.random.PRNGKey(6)
    kw = dict(prompt=args.prompt, height=8, width=8, frames=4, num_inference_steps=2)
    want = np.asarray(ref(key=key, latents=jnp.asarray(lat), **kw))
    got = pipe(latents=torch.from_numpy(lat), noise=_jax_scan_noise(key, 2, lat.shape), **kw)
    assert got.shape == (1, 4, 8, 8, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4)
    with pytest.raises(ValueError):
        pipe(prompt="x", height=8, width=8, frames=2, use_motion_cond=True)
