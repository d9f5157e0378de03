"""v1 training on real video data in the port (apps/train_v1.py's
--data-shards / --data-csv path, models/vae.py's encode side, the trainer's
prefetcher) against the JAX package, on the CPU at small sizes: the VAE's
encode_video, posterior_kl and posterior_nll; the --tiny-model real-data
batch against the JAX CLI's (the port's tiny VAE weights carried to JAX by
its importer); the full-width branch's composition at 2 frames of 64x64;
the CLI end to end; the prefetcher in `LCDTrainer.run`.
"""

import csv
import io
import itertools
import json
import os
import tarfile
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu.apps import train_v1 as jtrain_v1
from t2v_turbo_tpu.data import videoio as jvio
from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models import vae as jvae_mod
from t2v_turbo_tpu_torch.apps import time_prefetch, train_v1
from t2v_turbo_tpu_torch.data import videoio as pvio
from t2v_turbo_tpu_torch.models import vae as pvae_mod
from t2v_turbo_tpu_torch.models.layers import seeded_init_
from torch_parity import TINY_VAE_KW, numpy_state_dict

NATIVE = jvio.available() and pvio.available()


# ---------------------------------------------------------------------------
# the VAE's encode side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_vae_pair():
    port = pvae_mod.AutoencoderKL(pvae_mod.VAEConfig(**TINY_VAE_KW))
    seeded_init_(port, 3)
    params = {"params": ti.import_vae_params(numpy_state_dict(port), n_levels=2, n_res=1)}
    return port.eval(), jvae_mod.AutoencoderKL(cfg=jvae_mod.VAEConfig(**TINY_VAE_KW)), params


def _close(got, ref, rtol=1e-5):
    """|got - ref| <= rtol * max|ref| on every element (f32)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


def test_encode_video_matches_jax(tiny_vae_pair):
    port, jvae, params = tiny_vae_pair
    video = np.random.RandomState(0).uniform(-1, 1, (2, 3, 16, 16, 3)).astype(np.float32)
    ref = jvae_mod.encode_video(jvae, params, jnp.asarray(video))
    with torch.no_grad():
        got = pvae_mod.encode_video(port, torch.from_numpy(video))
        chunked = pvae_mod.encode_video(port, torch.from_numpy(video), frame_chunk=4)
    assert got.shape == ref.shape == (2, 3, 8, 8, 4)
    _close(got.numpy(), ref)
    torch.testing.assert_close(chunked, got, rtol=0, atol=0)  # chunks of 4, 2 frames: the same frames
    # a sample: mean + exp(logvar / 2) * the generator's N(0, 1) draw
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        sampled = pvae_mod.encode_video(port, torch.from_numpy(video), generator=g, scale_factor=1.0)
        mean, logvar = port.encode(torch.from_numpy(video).reshape(6, 16, 16, 3))
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(sampled.reshape(mean.shape), mean + torch.exp(0.5 * logvar) * noise)


def test_posterior_kl_and_nll_match_jax():
    r = np.random.RandomState(1)
    mean, logvar, om, olv, sample = (r.randn(3, 4, 5, 2).astype(np.float32) for _ in range(5))
    t = [torch.from_numpy(a) for a in (mean, logvar, om, olv, sample)]
    j = [jnp.asarray(a) for a in (mean, logvar, om, olv, sample)]
    _close(pvae_mod.posterior_kl(t[0], t[1]).numpy(), jvae_mod.posterior_kl(j[0], j[1]))
    _close(pvae_mod.posterior_kl(*t[:4]).numpy(), jvae_mod.posterior_kl(*j[:4]))
    _close(pvae_mod.posterior_nll(t[0], t[1], t[4]).numpy(), jvae_mod.posterior_nll(j[0], j[1], j[4]))
    _close(pvae_mod.posterior_nll(t[0], t[1], t[4], dims=(1, 2)).numpy(),
           jvae_mod.posterior_nll(j[0], j[1], j[4], axes=(1, 2)))


# ---------------------------------------------------------------------------
# real-data batches
# ---------------------------------------------------------------------------


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two tar shards of 3 mp4 + txt samples each (48x64, 12 frames at 8
    fps, written by the JAX binding) and a CSV of the same mp4s."""
    if not NATIVE:
        pytest.skip("native videoio not built")
    d = tmp_path_factory.mktemp("real")
    rows = []
    for s in range(2):
        with tarfile.open(str(d / f"s{s}.tar"), "w") as tf:
            for i in range(3):
                key = f"{s}_{i}"
                mp4 = str(d / f"{key}.mp4")
                rng = np.random.RandomState(zlib.crc32(key.encode()))
                jvio.encode(mp4, (rng.rand(12, 48, 64, 3) * 255).astype(np.uint8), fps=8)
                _add(tf, f"{key}.mp4", open(mp4, "rb").read())
                _add(tf, f"{key}.txt", f"a clip number {key}".encode())
                rows.append({"path": mp4, "text": f"a clip number {key}"})
    index = str(d / "index.csv")
    with open(index, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["path", "text"])
        w.writeheader()
        w.writerows(rows)
    return str(d / "*.tar"), index


def test_tiny_real_data_batch_matches_jax(shards, monkeypatch):
    """--tiny-model --data-shards: the port's batches against the JAX CLI's
    make_data_iter, with the port's tiny VAE weights imported into the JAX
    VAE: latents within 3e-4, the contexts, fps and captions equal."""
    pattern, _ = shards
    flags = ["--tiny-model", "--random-weights", "--data-shards", pattern, "--height", "16", "--width", "16"]
    args = train_v1.parse_args(flags + ["--device", "cpu"])
    shape = train_v1.DataShape(4, 4, (8, 8), 7, 16)
    vae = train_v1.build_vae(args, torch.device("cpu"), torch.float32)
    port = train_v1.make_data_iter(args, shape, train_v1.raw_video_batches(args, 4, 4), vae)

    params = {"params": ti.import_vae_params(numpy_state_dict(vae), n_levels=2, n_res=1)}
    monkeypatch.setattr(jvae_mod.AutoencoderKL, "init", lambda self, *a, **k: params)
    ref = jtrain_v1.make_data_iter(jtrain_v1.parse_args(flags), 16, (8, 8), 4, 4, None)
    for got, want in zip(itertools.islice(port, 2), itertools.islice(ref, 2)):
        assert got["latents"].shape == want["latents"].shape == (4, 4, 8, 8, 4)
        np.testing.assert_allclose(got["latents"].numpy(), want["latents"], atol=3e-4, rtol=0)
        for k in ("ctx", "uncond_ctx", "fps"):
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert got["_texts"] == want["_texts"]


def test_full_width_branch_composes(shards, monkeypatch):
    """The full-width branch (the VC2 VAE and the ViT-H text tower, seeded)
    at 2 frames of 64x64: the latents are encode_video's on the decoded
    batch and the context is the tower's on the tokenised captions; the
    empty prompt's context is repeated over the batch."""
    pattern, _ = shards
    build_text_tower = train_v1.build_text_tower
    args = train_v1.parse_args(["--random-weights", "--data-shards", pattern, "--n-frames", "2", "--height", "64",
                                "--width", "64", "--device", "cpu"])
    shape = train_v1.DataShape(1, 2, (8, 8), 77, 1024)
    vae = train_v1.build_vae(args, torch.device("cpu"), torch.float32)
    towers = []
    monkeypatch.setattr(train_v1, "build_text_tower", lambda *a: towers.append(build_text_tower(*a)) or towers[-1])
    (batch,) = itertools.islice(train_v1.make_data_iter(args, shape, train_v1.raw_video_batches(args, 2, 1), vae), 1)
    (raw,) = itertools.islice(train_v1.raw_video_batches(args, 2, 1), 1)
    (text,) = towers  # the seeded ViT-H tower the branch built
    assert sum(p.numel() for p in text.parameters()) == 340_387_840 and not text.training
    embed = train_v1.text_embedder(text)
    with torch.no_grad():
        latents = pvae_mod.encode_video(vae, torch.from_numpy(raw["video"]), scale_factor=0.18215)
        ctx, uncond = embed(raw["txt"]), embed([""])
    assert batch["latents"].shape == (1, 2, 8, 8, 4) and batch["ctx"].shape == (1, 77, 1024)
    assert not batch["latents"].requires_grad and not batch["latents"].is_inference()
    torch.testing.assert_close(batch["latents"], latents, rtol=0, atol=0)
    torch.testing.assert_close(batch["ctx"], ctx, rtol=0, atol=0)
    torch.testing.assert_close(batch["uncond_ctx"], uncond, rtol=0, atol=0)
    assert batch["_texts"] == raw["txt"] and float(batch["fps"][0]) == 16.0


@pytest.mark.parametrize("source", ["shards", "csv"])
def test_cli_trains_on_real_data(shards, source, tmp_path):
    pattern, index = shards
    data = ["--data-shards", pattern, "--prefix-weights", f"{os.path.dirname(pattern)}/s0=1,"
            f"{os.path.dirname(pattern)}/s1=3"] if source == "shards" else ["--data-csv", index]
    train_v1.main(["--tiny-model", "--random-weights", *data, "--height", "16", "--width", "16", "--device", "cpu",
                   "--max-steps", "2", "--lora-rank", "4", "--output-dir", str(tmp_path)])
    assert os.path.exists(tmp_path / "unet_lora.npz") and os.path.exists(tmp_path / "unet_lora.pt")
    rows = [l for l in open(tmp_path / "metrics.jsonl")]
    assert len(rows) == 2 and all('"data_wait_frac"' in r for r in rows)


def test_build_trainer_takes_injected_raw_batches(tmp_path):
    """build_trainer(raw_videos=...) encodes the given decoded batches with
    the trainer's own VAE, as make_data_iter does, and the trainer steps on
    them (the wiring chip_smoke.py's real-data phase drives on the card)."""
    args = train_v1.parse_args(["--tiny-model", "--random-weights", "--device", "cpu", "--output-dir", str(tmp_path),
                                "--lora-rank", "4", "--max-steps", "2"])
    trainer, data, _ = train_v1.build_trainer(args, raw_videos=time_prefetch.decoded_clips(4, (16, 16)))
    vae = train_v1.build_vae(args, torch.device("cpu"), torch.float32)
    shape = train_v1.DataShape(1, 4, (8, 8), 7, 16)
    want = next(train_v1.make_data_iter(args, shape, time_prefetch.decoded_clips(4, (16, 16)), vae))
    got = next(data)
    assert got["latents"].shape == (1, 4, 8, 8, 4) and got["_texts"] == want["_texts"]
    for k in ("latents", "ctx", "uncond_ctx", "fps"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    trainer.run(data)
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["loss"]) for r in rows)


def test_cli_refuses_without_data(tmp_path):
    with pytest.raises(SystemExit, match="--data-shards, --data-csv or --synthetic-data"):
        train_v1.build_trainer(train_v1.parse_args(["--tiny-model", "--random-weights", "--device", "cpu",
                                                    "--output-dir", str(tmp_path)]))


# ---------------------------------------------------------------------------
# the trainer's prefetcher
# ---------------------------------------------------------------------------


def _tiny_trainer(out_dir):
    args = train_v1.parse_args(["--tiny-model", "--synthetic-data", "--random-weights", "--device", "cpu",
                                "--output-dir", str(out_dir), "--lora-rank", "4", "--max-steps", "2"])
    return train_v1.build_trainer(args)


def test_run_through_the_prefetcher_takes_the_same_steps(tmp_path):
    """`run` (batches through the prefetcher) gives the losses and factors
    of the same steps taken one by one with `step_once`."""
    trainer, data, _ = _tiny_trainer(tmp_path / "run")
    trainer.run(data)
    run_losses = [float(json.loads(l)["loss"]) for l in open(tmp_path / "run" / "metrics.jsonl")]
    direct, data2, _ = _tiny_trainer(tmp_path / "direct")
    losses = [float(direct.step_once(next(data2))["loss"]) for _ in range(2)]
    assert run_losses == losses
    torch.testing.assert_close(trainer.flat, direct.flat, rtol=0, atol=0)


def test_a_data_error_reaches_the_caller_of_run(tmp_path):
    trainer, data, _ = _tiny_trainer(tmp_path)

    def failing():
        yield next(data)
        raise IOError("a shard went away")

    with pytest.raises(IOError, match="a shard went away"):
        trainer.run(failing())
    assert trainer.step == 1


@pytest.mark.parametrize("source", ["shards", "csv"])
def test_v2_preprocess_on_real_data(shards, source, tmp_path):
    """apps/preprocess.py on decoded, centre-cropped clips, encoded by the
    tiny VAE with per-caption contexts: 2 samples with the motion prior,
    read back by MP4LatentDataset with their captions."""
    from t2v_turbo_tpu_torch.apps import preprocess
    from t2v_turbo_tpu_torch.data.datasets import MP4LatentDataset

    pattern, index = shards
    data = ["--data-shards", pattern] if source == "shards" else ["--data-csv", index]
    preprocess.main(["--tiny-model", "--random-weights", *data, "--height", "16", "--width", "16", "--n-frames", "4",
                     "--num-samples", "2", "--device", "cpu", "--output-dir", str(tmp_path)])
    paths = sorted(str(p) for p in tmp_path.glob("*.pkl"))
    assert [os.path.basename(p) for p in paths] == ["sample_000000.pkl", "sample_000001.pkl"]
    for p in paths:
        d = MP4LatentDataset([p])[0]
        assert d["z_t"].shape == (4, 8, 8, 4) and d["prompt_emb"].shape == (7, 16)
        assert d["txt"].startswith("a clip number") and np.abs(d["score"]).max() > 0
