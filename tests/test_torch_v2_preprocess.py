"""The offline v2 producer in the port (training/preprocess.py) against the
JAX package's (t2v_turbo_tpu/training/preprocess.py `make_preprocess_fn`),
on the CPU, in f32, through a one-level version of torch_parity's tiny
teacher (a shorter JAX compile) with one no-zero weight set and a 10-point
DDIM grid (the JAX tests' own).

The port is fed the draws the JAX core makes from its key (the index, then
the noise). Tolerances: z_t 1e-6 (the same f32 noising); z_example 1e-3
(up to 10 inversion steps of the UNet, 2e-4 a call, PARITY.md); the score
1e-3 x its largest entry (a gradient through the UNet); the conditional and
unconditional outputs 2e-4. The pickle's keys, numpy dtypes and shapes
equal JAX's, and each package's MP4LatentDataset reads the other's files.
One JAX gradient compile (the motion core); the no-prior core has none.

Under sequence parallelism, on two gloo ranks at (data, seq) = (1, 2)
(tests/torch_dist_worker.py's `v2_capture`, started with the module's
fixture so the ranks run while JAX compiles), against one process: a
two-block TemporalTransformer's capture (each rank's probabilities are one
process's rows of its columns, 1e-6; the output 1e-5); the teacher's nine-
layer-style capture in the output blocks (1e-5), the rank loss summed over
the ranks (1e-5 relative) and the motion score (1e-5 x its largest entry);
and `preprocess_sample(mesh=)` on the JAX motion sample's draws (key 5):
rank 0's pickle against one process at 1e-5 and against JAX at the
tolerances above, with the teacher's calls (index + 4) on each rank and
JAX's schema; rank 1 returns None.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu import diffusion as J
from t2v_turbo_tpu.data.datasets import MP4LatentDataset as JMP4LatentDataset
from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
from t2v_turbo_tpu.models import UNetModel as JUNet
from t2v_turbo_tpu.training import preprocess as jpre
from t2v_turbo_tpu_torch import diffusion as P
from t2v_turbo_tpu_torch.data.datasets import MP4LatentDataset
from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel
from t2v_turbo_tpu_torch.training import preprocess as ppre
import torch_dist_worker as W
from torch_parity import TINY_UNET_KW, seeded_numpy_state_dict, to_torch

KW = dict(TINY_UNET_KW, time_cond_proj_dim=None, channel_mult=(1,), attention_resolutions=(1,))  # one level: a shorter JAX compile
N = 10


class Counting(torch.nn.Module):
    """The teacher, counting its calls."""

    def __init__(self, unet):
        super().__init__()
        self.unet, self.calls = unet, 0

    def forward(self, *args, **kw):
        self.calls += 1
        return self.unet(*args, **kw)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny teacher in both packages and the sample's inputs; the
    sequence-parallel ranks start here on the motion sample's draws."""
    port = UNetModel(UNetConfig(**KW))
    sd = seeded_numpy_state_dict(port, 70)
    port.load_state_dict(to_torch(sd), strict=True)
    jcfg = JUNetConfig(**KW)
    junet, params = JUNet(cfg=jcfg), {"params": ti.import_unet_params(sd, jcfg)}
    rng = np.random.RandomState(71)
    data = dict(latents=0.2 * rng.randn(1, 4, 8, 8, 4).astype(np.float32),
                ctx=rng.randn(1, 7, 16).astype(np.float32), uncond=np.zeros((1, 7, 16), np.float32))
    jsched = J.DiffusionSchedule.create()
    jsolver = J.DDIMSolver.create(np.asarray(jsched.alphas_cumprod), ddim_timesteps=N)
    ranks_dir = tmp_path_factory.mktemp("v2_capture")
    draws = _jax_draws(jax.random.PRNGKey(5), data["latents"].shape)
    W.write_inputs(ranks_dir, {"unet": KW, "n": N}, **data, index=np.int64(draws.index), noise=draws.noise.numpy(),
                   **{"unet." + k: v for k, v in sd.items()})
    ranks = W.start_ranks("v2_capture", 2, ranks_dir)
    yield dict(port=Counting(port.requires_grad_(False).eval()), junet=junet, params=params, data=data,
               jsched=jsched, jsolver=jsolver, ranks=ranks, ranks_dir=ranks_dir, jax={})
    for p in ranks:  # nothing left running after a failure
        if p.poll() is None:
            p.kill()
            p.wait()


def _jax_sample(s, motion, key, txt):
    """JAX's sample (kept: the sequence-parallel case reuses the motion one)."""
    name = (motion, tuple(np.asarray(key).tolist()), txt)
    if name not in s["jax"]:
        s["jax"][name] = _jax_sample_uncached(s, motion, key, txt)
    return s["jax"][name]


def _jax_sample_uncached(s, motion, key, txt):
    apply = lambda p, z, ts, c, fps=None: s["junet"].apply(p, z, ts, c, fps=fps)
    apply_mut = lambda p, z, ts, c, fps=None: s["junet"].apply(
        p, z, ts, c, fps=fps, record_probs=True, mutable=["intermediates"])
    run = jpre.make_preprocess_fn(teacher_apply=apply, teacher_apply_mutable=apply_mut if motion else None,
                                  sched=s["jsched"], solver=s["jsolver"],
                                  cfg=jpre.PreprocessConfig(num_ddim_timesteps=N, with_motion_prior=motion))
    d = {k: jnp.asarray(v) for k, v in s["data"].items()}
    return run(s["params"], d["latents"], d["ctx"], d["uncond"], key, txt=txt)


def _jax_draws(key, shape):
    """The draws the JAX core takes from its key (training/preprocess.py:77-81)."""
    k_idx, k_noise = jax.random.split(key)
    lo = int((1.0 - 0.3) * N)
    index = int(np.asarray(jax.random.randint(k_idx, (1,), lo, N))[0])
    return ppre.PreprocessDraws(index, torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))))


def _port_sample(s, motion, draws, txt):
    sched = P.DiffusionSchedule.create()
    solver = P.DDIMSolver.create(sched.alphas_cumprod.numpy(), ddim_timesteps=N)
    t = {k: torch.from_numpy(v) for k, v in s["data"].items()}
    s["port"].calls = 0
    out = ppre.preprocess_sample(s["port"], t["latents"], t["ctx"], t["uncond"], draws, sched=sched, solver=solver,
                                 cfg=ppre.PreprocessConfig(num_ddim_timesteps=N, with_motion_prior=motion), txt=txt)
    return out, s["port"].calls


def _same_schema(a, b):
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        x, y = a[k], b[k]
        assert type(x) is type(y) or (np.ndim(x) == 0 and np.asarray(x).dtype == np.asarray(y).dtype), (k, type(x),
                                                                                                         type(y))
        if isinstance(x, np.ndarray) or isinstance(x, np.generic):
            assert np.asarray(x).dtype == np.asarray(y).dtype and np.shape(x) == np.shape(y), (k, x.dtype, y.dtype)


@pytest.mark.parametrize("motion", [True, False])
def test_sample_matches_jax(setup, motion, tmp_path):
    key = jax.random.PRNGKey(5 if motion else 6)
    want = _jax_sample(setup, motion, key, "a cat")
    draws = _jax_draws(key, setup["data"]["latents"].shape)
    assert draws.index == int(want["index"])
    got, calls = _port_sample(setup, motion, draws, "a cat")
    # index + 1 inversion steps, the reference capture, the capture with gradient, the unconditional output
    assert calls == (draws.index + 4 if motion else 2)
    _same_schema(got, want)
    assert got["use_motion_guide"] is motion and got["txt"] == "a cat" and got["short_txt"] == ""
    np.testing.assert_allclose(got["z_t"], want["z_t"], atol=1e-6)
    np.testing.assert_allclose(got["cond_teacher_out"], want["cond_teacher_out"], atol=2e-4)
    np.testing.assert_allclose(got["uncond_teacher_out"], want["uncond_teacher_out"], atol=2e-4)
    np.testing.assert_array_equal(got["prompt_emb"], setup["data"]["ctx"][0])
    if motion:
        np.testing.assert_allclose(got["z_example"], want["z_example"], atol=1e-3)
        smax = float(np.abs(want["score"]).max())
        assert smax > 0
        np.testing.assert_allclose(got["score"], want["score"], atol=1e-3 * smax)
    else:
        assert not np.abs(got["score"]).any() and not np.abs(want["score"]).any()

    # each package's dataset reads the other's pickle
    port_path = ppre.save_sample(str(tmp_path), "port", got)
    jax_path = jpre.save_sample(str(tmp_path), "jax", want)
    from_jax = MP4LatentDataset([jax_path])[0]
    from_port = JMP4LatentDataset([port_path])[0]
    np.testing.assert_array_equal(from_jax["z_t"], want["z_t"])
    np.testing.assert_array_equal(from_port["z_t"], got["z_t"])
    assert int(from_port["index"]) == int(from_jax["index"]) == draws.index
    batch = next(MP4LatentDataset([port_path, jax_path]).batches(2, shuffle=False, loop=False))
    assert batch["z_t"].shape == (2, 4, 8, 8, 4) and batch["index"].dtype == np.int32


@pytest.fixture(scope="module")
def seq_ranks(setup):
    """The two ranks' reports, once both have ended."""
    codes, outs = W.finish(setup["ranks"])
    assert codes == [0, 0], "v2_capture ranks failed:\n" + "\n".join(outs)
    return [W.read_report(setup["ranks_dir"], r) for r in range(2)]


def test_temporal_transformer_capture_at_1x2(seq_ranks):
    for rep in seq_ranks:
        tt = rep["tt"]
        assert tt["layers"] == [2, 2] and tt["rows"] == [[2 * 6 * 2, 4, 4]] * 2  # B * H*W / seq * heads rows
        assert tt["probs"] <= 1e-6 and tt["out"] <= 1e-5


def test_unet_capture_rank_loss_and_score_at_1x2(seq_ranks):
    for rep in seq_ranks:
        u = rep["unet"]
        assert u["layers"][0] == u["layers"][1] > 0 and u["capture"] <= 1e-5 and u["cond"] <= 1e-5
        for got, want in (u["rank loss"], u["score loss"]):
            assert want > 0 and got == pytest.approx(want, rel=1e-5)
        assert u["score max"] > 0 and u["score"] <= 1e-5 * u["score max"]


def test_sharded_preprocess_matches_one_process_and_jax(setup, seq_ranks):
    key = jax.random.PRNGKey(5)
    want = _jax_sample(setup, True, key, "a cat")
    draws = _jax_draws(key, setup["data"]["latents"].shape)
    one, _ = _port_sample(setup, True, draws, "a cat")
    assert [r["preprocess"] for r in seq_ranks] == [{"calls": draws.index + 4, "returned": r == 0} for r in range(2)]
    with open(setup["ranks_dir"] / "sharded.pkl", "rb") as f:
        got = pickle.load(f)
    _same_schema(got, want)
    for k in ("z_t", "z_example", "score", "cond_teacher_out", "uncond_teacher_out"):
        np.testing.assert_allclose(got[k], one[k], atol=1e-5 * max(1.0, float(np.abs(one[k]).max())), rtol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(got["z_t"], one["z_t"])  # the same elementwise noising of each frame
    np.testing.assert_allclose(got["z_t"], want["z_t"], atol=1e-6)
    np.testing.assert_allclose(got["z_example"], want["z_example"], atol=1e-3)
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-3 * float(np.abs(want["score"]).max()))
    for k in ("cond_teacher_out", "uncond_teacher_out"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, err_msg=k)


def test_draws_stay_in_the_band():
    cfg = ppre.PreprocessConfig(num_ddim_timesteps=50, max_percentage=0.3)
    g = torch.Generator().manual_seed(0)
    idx = [ppre.sample_preprocess_draws(cfg, (1, 2, 2, 2, 4), g).index for _ in range(200)]
    assert min(idx) >= 35 and max(idx) <= 49 and len(set(idx)) > 5


def test_save_sample_is_one_pickled_dict(tmp_path):
    path = ppre.save_sample(str(tmp_path / "out"), "x", {"index": np.int32(3)})
    with open(path, "rb") as f:
        assert pickle.load(f) == {"index": 3}
    assert [p.name for p in (tmp_path / "out").iterdir()] == ["x.pkl"]
