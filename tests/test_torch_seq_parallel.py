"""Data-, sequence- and tensor-parallel VC2 sampling of the port on the CPU:
the tiny UNet and pipeline over (data, seq, model) meshes of gloo ranks
against the port's single-process run, and against the JAX package's
sharded pipeline.

Ranks are spawned with `subprocess` (tests/torch_dist_worker.py, case
"sampling", which never imports JAX): a world of 2 runs the (1, 2) and
(1, 1, 2) meshes and a world of 4 the (1, 4) mesh (one frame a rank), the
(2, 2) mesh and, with a model axis, (1, 2, 2), (2, 1, 2) and (1, 1, 4)
(where the tiny UNet's level-0 attention, 2 heads, stays whole). Every
rank draws nothing itself: the global latents, the renoise of each step and
the contexts come from the test (numpy, and the JAX pipeline's scan draws
of tests/test_torch_pipeline.py's `_jax_scan_noise`) and each rank keeps
its block, as every rank does with its generator's global draws.

- The UNet's output block of every rank against the single-process UNet's,
  and rank 0's video against the single-process pipeline's: 1e-5 (f32; the
  whole-clip GroupNorm statistics are summed in another order). The
  gathered latents, whose values reach ~100 at random weights: 1e-5 *
  max(1, |ref|).
- Rank 0's video at (2, 2), (1, 2, 2) and (2, 1, 2) against the JAX
  pipeline over a (data=2, seq=2) mesh of 4 of the 8 virtual CPU devices,
  on tests/test_torch_pipeline.py's weights: 2e-4 absolute, the UNet's
  bound (PARITY.md; the VAE's is 3e-4). JAX's tensor-parallel forward
  equals its replicated one (tests/test_tensor_parallel.py).
- With a model axis, the model all-reduce's calls in one UNet pass equal
  the plan's row layers that split.
- A mesh of one rank runs the single-device path: the video equals the
  pipeline's without a mesh to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu.diffusion import DiffusionSchedule as JSchedule
from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
from t2v_turbo_tpu.models import UNetModel as JUNet
from t2v_turbo_tpu.models.vae import AutoencoderKL as JVAE
from t2v_turbo_tpu.models.vae import VAEConfig as JVAEConfig
from t2v_turbo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from t2v_turbo_tpu.pipelines.vc2 import T2VTurboVC2Pipeline as JPipeline
from test_torch_pipeline import _jax_scan_noise
from torch_parity import TINY_UNET_KW, TINY_VAE_KW, seeded_numpy_state_dict

# (data x seq[ x model]): the world that runs it (torch_dist_worker.SAMPLING_MESHES)
MESHES = {W.mesh_name(*m): world for world, ms in W.SAMPLING_MESHES.items() for m in ms}
MODEL_MESHES = [n for n in MESHES if n.count("x") == 2]
TOL = 1e-5
JAX_TOL = 2e-4
KW = dict(height=16, width=16, frames=4, num_inference_steps=2)


def _jax_video(lat, ctx, key):
    """The JAX pipeline's video over a (data=2, seq=2) mesh of 4 virtual devices."""
    unet, vae = W.tiny_models()
    sds = [seeded_numpy_state_dict(m, seed) for seed, m in ((0, unet), (1, vae))]
    jcfg = JUNetConfig(**dict(TINY_UNET_KW, time_cond_proj_dim=256))
    pipe = JPipeline(
        unet=JUNet(cfg=jcfg), unet_params={"params": ti.import_unet_params(sds[0], jcfg)},
        vae=JVAE(cfg=JVAEConfig(**TINY_VAE_KW)), vae_params={"params": ti.import_vae_params(sds[1], n_levels=2, n_res=1)},
        text_model=None, text_params=None, tokenizer=None, schedule=JSchedule.create(), vae_scale=2,
        dtype=jnp.float32, mesh=jax_make_mesh(devices=jax.devices()[:4], data=2, seq=2))
    return np.asarray(pipe(prompt_embeds=jnp.asarray(ctx), latents=jnp.asarray(lat), key=key, **KW))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    lat, _, ctx = W.sampling_inputs()
    key = jax.random.PRNGKey(3)
    noise = np.stack([n.numpy() for n in _jax_scan_noise(key, 2, lat.shape)])
    w_emb = np.random.RandomState(3).randn(2, 256).astype(np.float32)
    dirs = {world: tmp_path_factory.mktemp(f"world{world}") for world in (2, 4)}
    for d in dirs.values():
        np.savez(d / "inputs.npz", lat=lat, noise=noise, ctx=ctx, w_emb=w_emb)
    procs = {world: W.start_ranks("sampling", world, d) for world, d in dirs.items()}
    jax_video = _jax_video(lat, ctx, key)  # while the ranks run
    pipe = W.tiny_pipeline()
    L, NZ, C = (torch.from_numpy(a) for a in (lat, noise, ctx))
    with torch.no_grad():
        unet = pipe.unet(L, torch.full((2,), 500), C, fps=torch.full((2,), 16.0), timestep_cond=torch.from_numpy(w_emb))
        video = pipe(prompt_embeds=C, latents=L, noise=list(NZ), **KW)
        latent = pipe(prompt_embeds=C, latents=L, noise=list(NZ), output_type="latent", **KW)
    for world, ps in procs.items():
        codes, outs = W.finish(ps)
        assert codes == [0] * world, f"world {world} failed:\n" + "\n".join(outs)
    return dict(dirs=dirs, unet=unet.numpy(), video=video.numpy(), latent=latent.numpy(), jax=jax_video,
                lat=L, noise=NZ, ctx=C)


def _arrays(sharded, name, rank):
    return np.load(sharded["dirs"][MESHES[name]] / f"arrays_{rank}.npz")


def _axes(name):
    """(data, seq, model) of a mesh name."""
    data, seq, model = (list(map(int, name.split("x"))) + [1])[:3]
    return data, seq, model


@pytest.mark.parametrize("name", MESHES)
def test_unet_blocks_match_single_process(sharded, name):
    data, seq, model = _axes(name)
    bl, tl = 2 // data, 4 // seq
    for rank in range(MESHES[name]):
        d, s = divmod(rank // model, seq)  # every model rank of (d, s) holds the whole block
        got = _arrays(sharded, name, rank)[f"unet_{name}"]
        np.testing.assert_allclose(got, sharded["unet"][d * bl:(d + 1) * bl, s * tl:(s + 1) * tl], atol=TOL, rtol=0)


@pytest.mark.parametrize("name", MESHES)
def test_video_matches_single_process(sharded, name):
    np.testing.assert_allclose(_arrays(sharded, name, 0)[f"video_{name}"], sharded["video"], atol=TOL, rtol=0)
    for rank in range(MESHES[name]):
        rep = W.read_report(sharded["dirs"][MESHES[name]], rank)
        assert rep[f"video {name}"] == (rank == 0)  # rank 0 alone returns the video
        assert f"video_{name}" not in _arrays(sharded, name, rank) or rank == 0
        latent = _arrays(sharded, name, rank)[f"latent_{name}"]  # every rank: the gathered latents
        ref = sharded["latent"]
        np.testing.assert_allclose(latent, ref, atol=TOL * max(1.0, float(np.abs(ref).max())), rtol=0)


@pytest.mark.parametrize("name", MESHES)
def test_divisibility_error(sharded, name):
    data, seq, _ = _axes(name)
    rep = W.read_report(sharded["dirs"][MESHES[name]], 0)
    want = "none" if seq == 1 else (f"sharded inference needs batch 2 divisible by the data axis ({data}) and "
                                    f"frames 3 by the seq axis ({seq})")
    assert rep[f"divisibility {name}"] == want  # the model axis adds no condition: 3 frames sample at seq 1


def test_matches_jax_sharded_pipeline(sharded):
    got = _arrays(sharded, "2x2", 0)["video_2x2"]
    assert got.shape == sharded["jax"].shape == (2, 4, 16, 16, 3)
    np.testing.assert_allclose(got, sharded["jax"], atol=JAX_TOL, rtol=0)


@pytest.mark.parametrize("name", ["1x2x2", "2x1x2"])
def test_model_axis_matches_jax_sharded_pipeline(sharded, name):
    got = _arrays(sharded, name, 0)[f"video_{name}"]
    assert got.shape == sharded["jax"].shape == (2, 4, 16, 16, 3)
    np.testing.assert_allclose(got, sharded["jax"], atol=JAX_TOL, rtol=0)


@pytest.mark.parametrize("name", MODEL_MESHES)
def test_model_all_reduces_a_pass_equal_the_row_layers(sharded, name):
    data, seq, model = _axes(name)
    for rank in range(MESHES[name]):
        rep = W.read_report(sharded["dirs"][MESHES[name]], rank)
        calls, rows = rep[f"model all-reduces {name}"]
        assert calls == rows and rows > 0
        assert rep[f"model coords {name}"] == [rank // (seq * model), (rank // model) % seq, rank % model]
    if name == "1x1x4":  # the level-0 attention's 2 heads do not split 4 ways: fewer row layers than at 2
        two = W.read_report(sharded["dirs"][2], 0)["model all-reduces 1x1x2"][1]
        assert W.read_report(sharded["dirs"][4], 0)["model all-reduces 1x1x4"][1] < two


def test_mesh_of_one_rank_is_the_single_device_path(sharded, monkeypatch):
    from t2v_turbo_tpu_torch.models import layers
    from t2v_turbo_tpu_torch.parallel import multihost
    from t2v_turbo_tpu_torch.parallel.mesh import make_mesh

    def refuse(*_a, **_k):
        raise AssertionError("a sequence-parallel entry ran in a world of one rank")

    for name in ("group_norm_partials", "group_norm_from_partials", "group_norm_affine_from_partials",
                 "fused_gn_silu_conv_ab"):
        monkeypatch.setattr(layers, name, refuse)
    multihost.initialize(f"localhost:{W.free_port()}", 1, 0, device_type="cpu", timeout_s=60)
    try:
        pipe = W.tiny_pipeline(make_mesh(device="cpu"))
        with torch.no_grad():
            got = pipe(prompt_embeds=sharded["ctx"], latents=sharded["lat"], noise=list(sharded["noise"]), **KW)
    finally:
        multihost.shutdown()
    np.testing.assert_array_equal(got.numpy(), sharded["video"])
