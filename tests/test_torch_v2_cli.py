"""The port's v2 CLIs (apps/preprocess.py, apps/train_v2.py, generate's
motion flags) on the CPU at --tiny-model size, and train_v2's reward-field
selection against the JAX CLI's (tests/test_v2_surface.py's oracle, run on
both packages with the same seed: the same masks, captions and frames).

End to end: preprocess writes 3 pickles with the motion prior and 1
without; train_v2 takes 2 steps on them with the motion embedding, the EMA
target network, the temporal group and both rewards; the exported unet.pt
and target_unet.pt load strictly into the port's UNet and the JAX importer
reads them.
"""

import argparse
import json
import pickle

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu.apps.train_v2 import add_v2_reward_fields as jax_add_v2_reward_fields
from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
from t2v_turbo_tpu_torch.apps import generate, preprocess, train_v1, train_v2
from t2v_turbo_tpu_torch.config import VC2ModelSpec
from t2v_turbo_tpu_torch.data.datasets import MP4LatentDataset
from t2v_turbo_tpu_torch.io import convert
from t2v_turbo_tpu_torch.models import CLIPTextConfig, UNetConfig, UNetModel, VAEConfig


class FakeRM:
    def encode_texts(self, texts):
        # a feature per text that says which caption won
        return np.array([[float(len(t))] for t in texts], np.float32)


def _args(**kw):
    ns = argparse.Namespace(seed=0, reward_frames=2, reward_batch=2, video_rm_frames=4, video_rm_batch=1,
                            webvid_no_reward=False)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _batch(short):
    b = len(short)
    return {"z_t": np.zeros((b, 8, 4, 4, 4), np.float32), "txt": [f"full caption number {i}" for i in range(b)],
            "short_txt": list(short)}


@pytest.mark.parametrize("short,webvid", [(["", "cat", "", "dog"], False), ([""] * 4, False), ([""] * 4, True),
                                          (["", "cat", "", ""], True)])
def test_v2_reward_fields_match_jax(short, webvid):
    """The short-caption preference, the random choice without short
    captions and the webvid opt-out: field for field the JAX CLI's."""
    want = next(jax_add_v2_reward_fields(iter([_batch(short)]), _args(webvid_no_reward=webvid), FakeRM(), FakeRM()))
    got = next(train_v2.add_v2_reward_fields(iter([_batch(short)]), _args(webvid_no_reward=webvid), FakeRM(),
                                             FakeRM()))
    assert set(got) == set(want)
    for k in ("reward_frame_idx", "reward_text_feats", "reward_mask", "video_frame_idx", "video_text_feats",
              "video_reward_mask"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    if any(short):
        assert set(np.flatnonzero(got["reward_mask"])) <= {i for i, s in enumerate(short) if s}
        assert (got["video_text_feats"][:, 0] > 3).all()  # the video reward scores the full captions
    elif webvid:
        assert got["reward_mask"].sum() == 0 and got["video_reward_mask"].sum() == 0


def test_preprocess_then_train_v2_end_to_end(tmp_path):
    lat = tmp_path / "latents"
    common = ["--random-weights", "--synthetic-data", "--tiny-model", "--device", "cpu"]
    preprocess.main(common + ["--num-samples", "3", "--output-dir", str(lat / "motion")])
    preprocess.main(common + ["--num-samples", "1", "--seed", "1", "--no-motion-prior",
                              "--output-dir", str(lat / "plain")])
    paths = sorted(str(p) for p in lat.glob("*/*.pkl"))
    assert len(paths) == 4
    samples = [MP4LatentDataset([p])[0] for p in paths]
    assert [s["use_motion_guide"] for s in samples] == [True, True, True, False]
    assert all(35 <= int(s["index"]) < 50 and s["z_t"].shape == (4, 8, 8, 4) for s in samples)
    assert ["z_example" in s for s in samples] == [True, True, True, False]

    out = tmp_path / "run"
    train_v2.main(["--random-weights", "--tiny-model", "--device", "cpu", "--latent-glob", str(lat / "*/*.pkl"),
                   "--output-dir", str(out), "--max-steps", "2", "--batch-size", "2", "--use-motion-cond",
                   "--use-target-unet", "--temporal-lr", "3e-5", "--reward-fn", "hpsv2", "--video-rm-fn",
                   "vi_clip", "--reward-scale", "0.2", "--video-reward-scale", "0.5"])
    rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r[k]) for r in rows for k in ("loss", "distill_loss", "reward_loss", "video_rm_loss"))
    assert (out / "checkpoints" / "step_00000002.pt").exists()
    cfg = UNetConfig(**train_v1.TINY_UNET_KW, motion_cond_proj_dim=8)
    jcfg = JUNetConfig(**train_v1.TINY_UNET_KW, motion_cond_proj_dim=8)
    for name in ("unet.pt", "target_unet.pt"):
        sd = torch.load(out / name, weights_only=True)
        assert all(v.dtype == torch.float32 for v in sd.values())
        UNetModel(cfg).load_state_dict(sd, strict=True)
        params = ti.import_unet_params(ti.load_torch_state_dict(str(out / name)), jcfg)
        assert {"motion_cond_proj", "combine_proj", "time_cond_proj"} <= set(params)
    ema = torch.load(out / "target_unet.pt", weights_only=True)
    student = torch.load(out / "unet.pt", weights_only=True)
    assert any(not torch.equal(ema[k], student[k]) for k in student)


def test_train_v2_from_a_teacher_checkpoint(tmp_path):
    """A VC2 checkpoint's UNet starts the student with a zero
    time_cond_proj; with --use-motion-cond a checkpoint without the motion
    projections is refused, naming them."""
    teacher = UNetModel(UNetConfig(**dict(train_v1.TINY_UNET_KW, time_cond_proj_dim=None)))
    ckpt = tmp_path / "model.ckpt"
    torch.save({"state_dict": {f"model.diffusion_model.{k}": v for k, v in teacher.state_dict().items()}}, ckpt)
    lat = tmp_path / "latents"
    preprocess.main(["--random-weights", "--synthetic-data", "--tiny-model", "--device", "cpu", "--num-samples",
                     "2", "--no-motion-prior", "--output-dir", str(lat)])
    argv = ["--checkpoint", str(ckpt), "--tiny-model", "--device", "cpu", "--latent-glob", str(lat / "*.pkl"),
            "--output-dir", str(tmp_path / "run"), "--batch-size", "2"]
    trainer, data, _ = train_v2.build_trainer(train_v2.parse_args(argv))
    sd = trainer.export_student_params()
    assert not sd["time_cond_proj.weight"].any()
    for k, v in teacher.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    assert np.isfinite(float(trainer.step_once(next(data))["loss"]))
    with pytest.raises(KeyError, match="motion_cond_proj.weight"):
        train_v2.build_trainer(train_v2.parse_args(argv + ["--use-motion-cond"]))
    with pytest.raises(SystemExit):
        train_v2.build_trainer(train_v2.parse_args(argv[:6] + ["--latent-glob", str(tmp_path / "none*.pkl")]))


def test_generate_with_the_motion_embedding():
    """generate's v2 flags reach the pipeline; a motion-conditioned UNet
    renders at the v2 operating point (16 steps from origin 200)."""
    args = generate.parse_args(["--prompt", "a cat", "--random-weights", "--device", "cpu", "--use-motion-cond",
                                "--motion-gs", "0.05", "--percentage", "0.3", "--steps", "16",
                                "--lcm-origin-steps", "200"])
    assert (args.use_motion_cond, args.motion_gs, args.percentage) == (True, 0.05, 0.3)
    spec = VC2ModelSpec(unet=UNetConfig(**dict(train_v1.TINY_UNET_KW, context_dim=64, time_cond_proj_dim=256,
                                               motion_cond_proj_dim=256)),
                        vae=VAEConfig(**train_v1.TINY_VAE_KW), text=CLIPTextConfig(width=64, heads=2, layers=2))
    pipe = generate.build_pipeline(args, spec)
    pipe.vae_scale = 2
    kw = dict(prompt="a cat", height=8, width=8, frames=2, num_inference_steps=args.steps,
              lcm_origin_steps=args.lcm_origin_steps, use_motion_cond=True, percentage=args.percentage)
    a = pipe(generator=torch.Generator().manual_seed(1), motion_gs=args.motion_gs, **kw)
    b = pipe(generator=torch.Generator().manual_seed(1), motion_gs=0.0, **kw)
    assert a.shape == (1, 2, 8, 8, 3) and bool(torch.isfinite(a).all())
    assert float((a - b).abs().max()) > 0
    with pytest.raises(KeyError):  # a v1 student checkpoint has no motion projections
        convert.student_unet_state_dict(UNetModel(UNetConfig(**train_v1.TINY_UNET_KW)).state_dict(), spec.unet)
