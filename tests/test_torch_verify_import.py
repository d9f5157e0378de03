"""apps/verify_import.py of the port against the JAX package's, on the same
synthetic checkpoints (tests/test_verify_import.py's: the committed tiny
UNet and VAE goldens, a schema-faithful tiny open_clip text tower, EMA
shadows and schedule buffers), on the CPU.

For each case of the JAX dry run (a clean checkpoint, an unmapped UNet key,
an unknown top-level prefix) both reports must agree on ok, on every
family's key counts and on the unconsumed keys they name; the port's
roundtrip (the meta-device modules' state dicts after the strict
`assign=True` load) must give back every consumed UNet tensor to the bit
and agree with JAX's exporter roundtrip on what it compares and misses. Also the
ModelScope layout: a small diffusers folder (1x1-conv UNet projections,
renamed VAE keys, an HF text tower) through the port's verify_ms, whose
roundtrip undoes the reshapes and renames to the bit.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu.apps import verify_import as jverify
from t2v_turbo_tpu_torch.apps import verify_import as pverify
from t2v_turbo_tpu_torch.config import VC2ModelSpec
from t2v_turbo_tpu_torch.models import CLIPTextConfig, UNetConfig, VAEConfig
from test_verify_import import HEADS, LAYERS, TINY_UNET_CFG, TINY_VAE_CFG, W, _tiny_spec, synth_ckpt  # noqa: F401

PORT_UNET_CFG = {k: v for k, v in TINY_UNET_CFG.items() if k != "temporal_length"}
FAMILIES = ("unet", "vae", "text")


def _port_spec():
    return VC2ModelSpec(unet=UNetConfig(**PORT_UNET_CFG), vae=VAEConfig(**TINY_VAE_CFG))


def _reports(path):
    from t2v_turbo_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig

    want = jverify.verify_vc2(path, _tiny_spec(), clip_layers=LAYERS,
                              text_cfg=JCLIPTextConfig(width=W, heads=HEADS, layers=LAYERS), smoke_shape=(4, 64, 64))
    got = pverify.verify_vc2(path, _port_spec(), clip_layers=LAYERS,
                             text_cfg=CLIPTextConfig(width=W, heads=HEADS, layers=LAYERS), smoke_shape=(4, 64, 64))
    return want, got


def _corrupt(path, tmp_path, key, value):
    obj = torch.load(path, map_location="cpu", weights_only=False)
    obj["state_dict"][key] = value
    bad = tmp_path / "bad.ckpt"
    torch.save(obj, str(bad))
    return str(bad)


@pytest.mark.parametrize("case", ["clean", "unmapped_unet_key", "unknown_top_level_prefix"])
def test_reports_agree_with_jax(synth_ckpt, tmp_path, case):  # noqa: F811
    path = {"clean": lambda: synth_ckpt,
            "unmapped_unet_key": lambda: _corrupt(synth_ckpt, tmp_path, "model.diffusion_model.bogus.weight",
                                                  torch.zeros(3, 3)),
            "unknown_top_level_prefix": lambda: _corrupt(synth_ckpt, tmp_path, "mystery_tower.weight",
                                                         torch.zeros(2))}[case]()
    want, got = _reports(path)
    assert got["ok"] == want["ok"] == (case == "clean")
    assert got["top_level_gaps"] == want["top_level_gaps"]
    for fam in FAMILIES:
        for key in ("keys_total", "keys_consumed", "unconsumed_expected", "unconsumed_gaps", "ok"):
            assert got[fam][key] == want[fam][key], (fam, key, got[fam], want[fam])
    rt, jrt = got["unet"]["roundtrip"], want["unet"]["roundtrip"]
    for key in ("ok", "keys_compared", "max_abs_delta", "missing_from_export"):
        assert rt[key] == jrt[key], (key, rt, jrt)
    assert rt["max_abs_delta"] == 0.0 and rt["keys_compared"] == got["unet"]["keys_consumed"]
    assert set(got) - {"_modules"} == set(want) - {"_params"}
    assert got["forward"]["ok"]
    if case == "unmapped_unet_key":
        assert "bogus.weight" in got["unet"]["unconsumed_gaps"]
    if case == "unknown_top_level_prefix":
        assert "mystery_tower.weight" in got["top_level_gaps"]


def test_ms_folder_roundtrip(tmp_path):
    """A small diffusers folder through verify_ms: every key consumed, the
    UNet's 1x1-conv projections and the VAE's renames undone to the bit."""
    from t2v_turbo_tpu_torch.models import AutoencoderKL
    from t2v_turbo_tpu_torch.models.unet_ms import MSUNet3DConditionModel, MSUNetConfig
    from test_ms_components import _orig_to_diffusers_names
    from torch_parity import seeded_numpy_state_dict, to_torch

    ucfg = MSUNetConfig(block_out_channels=(32, 64), layers_per_block=1, attention_head_dim=16,
                        cross_attention_dim=24, time_cond_proj_dim=8)
    vcfg = VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    unet = to_torch(seeded_numpy_state_dict(MSUNet3DConditionModel(ucfg), 1))
    # the diffusers checkpoint's spatial projections as 1x1 convs
    unet = {k: (v[:, :, None, None] if k.endswith(("proj_in.weight", "proj_out.weight")) and ".attentions." in k
                else v) for k, v in unet.items()}
    vae = _orig_to_diffusers_names(seeded_numpy_state_dict(AutoencoderKL(vcfg), 2), n_levels=2)
    rng = np.random.RandomState(3)
    text = {"text_model.embeddings.token_embedding.weight": rng.randn(49408, 24),
            "text_model.embeddings.position_embedding.weight": rng.randn(77, 24),
            "text_model.embeddings.position_ids": np.arange(77)[None],
            "text_model.final_layer_norm.weight": rng.randn(24), "text_model.final_layer_norm.bias": rng.randn(24)}
    for i in range(2):
        p = f"text_model.encoder.layers.{i}."
        for n, shape in (("self_attn.q_proj", (24, 24)), ("self_attn.k_proj", (24, 24)),
                         ("self_attn.v_proj", (24, 24)), ("self_attn.out_proj", (24, 24)),
                         ("mlp.fc1", (96, 24)), ("mlp.fc2", (24, 96))):
            text[f"{p}{n}.weight"], text[f"{p}{n}.bias"] = rng.randn(*shape), rng.randn(shape[0])
        for n in ("layer_norm1", "layer_norm2"):
            text[f"{p}{n}.weight"], text[f"{p}{n}.bias"] = rng.randn(24), rng.randn(24)
    for sub, sd in (("unet", unet), ("vae", vae), ("text_encoder", text)):
        (tmp_path / sub).mkdir()
        torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                   str(tmp_path / sub / "diffusion_pytorch_model.bin"))
    (tmp_path / "text_encoder" / "config.json").write_text('{"num_attention_heads": 2, "hidden_act": "gelu"}')
    report = pverify.verify_ms(str(tmp_path), unet_cfg=ucfg, vae_cfg=vcfg, smoke_shape=(2, 32, 32))
    assert report["ok"], {k: report[k] for k in ("unet", "vae", "text")}
    for fam in ("unet", "vae"):
        rt = report[fam]["roundtrip"]
        assert rt["max_abs_delta"] == 0.0 and rt["keys_compared"] == report[fam]["keys_total"]
    assert report["unet"]["keys_consumed"] == len(unet)
    assert report["text"]["unconsumed_expected"] == 1  # position_ids


def test_tracking_sd():
    t = pverify.TrackingSD({"a": 1, "b": 2, "ema.c": 3})
    _ = t["a"]
    cov = t.coverage(ignorable=(r"^ema\.",))
    assert (cov["keys_consumed"], cov["unconsumed_gaps"], cov["unconsumed_expected"], cov["ok"]) == (1, ["b"], 1, False)
    _ = t["b"]
    assert t.coverage(ignorable=(r"^ema\.",))["ok"]
