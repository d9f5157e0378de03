"""Training under the (data, seq) mesh in the port, on the CPU over gloo ranks.

Rank processes are spawned with `subprocess` (tests/torch_dist_worker.py,
which never imports JAX) and write what they measured; this process holds
the one-process references and the JAX package's sharded step.

- A world of 2 (case "train"): each collective's backward against autograd
  through the one-process op on the global tensors (f64: data movement and
  sums of two, exact); a TemporalConvBlock's and a TemporalTransformer's
  parameter gradients summed over the seq ranks and their input gradients
  at (1, 2) against one process (1e-5 x max(1, |ref|)); two v1 LoRA steps
  of the dryrun's smallest UNet at (1, 2) and (2, 1), with a reward that needs
  every frame at (1, 2), with --fsdp at (2, 1) and there with two micro-steps
  an update (the accumulation), against one process on the global batch with the
  same draws (the factors after each step, and the summed gradient over its
  largest entry, to 1e-5; the loss and grad_norm to 1e-5 relative; the l2
  loss, since Huber's slope of 1 / c at |pred - target| ~ c = 1e-3 makes a
  reordered f32 sum 1e-4 of the gradient); three v2 full-model steps with
  --fsdp at (2, 1) (int8 moments, the EMA, the text-encoder group) against
  one process (the whole master and EMA to 1e-5, loss and grad_norm to 1e-5
  relative), its step-2 checkpoint resumed on one process and one
  process's resumed at (2, 1), each to the uninterrupted step 3; a
  LatentWebDataset step whose data ranks read their own shards; a SIGTERM
  to rank 1 inside `run`, after which both ranks stop at one step with one
  checkpoint; the validation render at (1, 2), rank 0 alone writing, within
  one uint8 level of one process's.
- A world of 4 (case "train4"): the v1 step at (2, 2) on JAX's draws against
  one process (1e-5) and against JAX's `make_train_step` jitted over a
  (data=2, seq=2) mesh of 4 virtual CPU devices on the same weights (2e-4:
  the loss, grad_norm and the factors after the step). JAX runs in this
  process while the ranks run.
- torchrun: `train_v1 --tiny-model --seq-shards 2 --device cpu` on 2 ranks
  against the one-process CLI (metrics and unet_lora.npz to 1e-5).
In process: the split entries' and B7-on-(a, b)'s backward against
autograd of their plain twins (f32, 1e-5), the data-rank shard split, and
the refusals (train_v2 --seq-shards 2; a world --seq-shards does not
divide).
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_dist_worker as W
import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu_torch.io import convert
from t2v_turbo_tpu_torch.ops import fused_conv as FC
from t2v_turbo_tpu_torch.ops import norms as N

TOL, JAX_TOL = 1e-5, 2e-4
CLI_V1 = ["--tiny-model", "--synthetic-data", "--random-weights", "--device", "cpu", "--lora-rank", "4",
          "--max-steps", "2", "--optimizer", "adamw", "--learning-rate", "1e-6", "--seed", "7"]


def _jax_step(out_dir, then):
    """JAX's make_train_step on the dryrun's smallest UNet with the workers'
    weights and factors, jitted over a (data=2, seq=2) mesh of 4 virtual
    devices (conftest's). Writes its draws and the batch for the (2, 2)
    ranks (inputs.npz) and calls `then` before it traces; returns its
    loss, grad_norm, the factors after the step (keyed as
    convert.lora_to_jax keys them) and its draws."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from t2v_turbo_tpu import diffusion as J
    from t2v_turbo_tpu import lora as jlora
    from t2v_turbo_tpu.io import torch_import as ti
    from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
    from t2v_turbo_tpu.models import UNetModel as JUNet
    from t2v_turbo_tpu.parallel.mesh import make_mesh
    from t2v_turbo_tpu.training.lcd import LCDConfig as JLCDConfig
    from t2v_turbo_tpu.training.lcd import make_train_step
    from t2v_turbo_tpu.training.optim import make_optimizer
    from torch_parity import jax_lcd_draws

    batch = {k: v for k, v in W.v1_batch().items() if k != "reward_mask"}
    key = jax.random.PRNGKey(4)
    jcfg = JLCDConfig(w_embedding_dim=8, loss_type="l2")
    draws = jax_lcd_draws(key, jcfg, batch["latents"].shape)
    np.savez(os.path.join(out_dir, "inputs.npz"), **batch, index=draws.index.numpy(), noise=draws.noise.numpy(),
             w=draws.w.numpy())
    then()
    ssd, tsd, factors = W.v1_state_dicts()
    ucfg = dict(W.V1_UNET_KW, temporal_length=4)
    scfg, tcfg = JUNetConfig(**ucfg), JUNetConfig(**{**ucfg, "time_cond_proj_dim": None})
    sp, tp = ({"params": ti.import_unet_params(sd, c)} for sd, c in ((ssd, scfg), (tsd, tcfg)))
    jstudent, jteacher = JUNet(cfg=scfg), JUNet(cfg=tcfg)
    lora = {k: {n: jnp.asarray(a) for n, a in f.items()} for k, f in convert.lora_to_jax(factors).items()}
    sched = J.DiffusionSchedule.create()
    opt = make_optimizer("adamw", W.V1_LR, eps=1.0)
    step = make_train_step(
        opt, student_apply=lambda lf, z, t, c, fps=None, timestep_cond=None: jstudent.apply(
            jlora.merge_lora(sp, lf), z, t, c, fps=fps, timestep_cond=timestep_cond),
        teacher_apply=lambda p, z, t, c, fps=None: jteacher.apply(p, z, t, c, fps=fps), sched=sched,
        solver=J.DDIMSolver.create(np.asarray(sched.alphas_cumprod)), cfg=jcfg, max_grad_norm=W.V1_MAX_NORM)
    mesh = make_mesh(devices=jax.devices()[:4], data=2, seq=2)
    specs = {"latents": P("data", "seq")}
    jbatch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, specs.get(k, P("data")))) for k, v in batch.items()}
    with mesh:
        new, _, metrics = jax.jit(step)(lora, opt.init(lora), tp, jbatch, key)
    return dict(loss=float(metrics["loss"]), gnorm=float(metrics["grad_norm"]), draws=draws,
                lora={k: {n: np.asarray(a) for n, a in f.items()} for k, f in new.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-process run, all started together once JAX's draws are
    written; JAX's sharded step and the one-process references run here
    meanwhile."""
    from t2v_turbo_tpu_torch.apps import train_v1

    dirs = {k: tmp_path_factory.mktemp(k) for k in ("train", "train4", "cli")}
    out = {"dirs": dirs}
    groups = {"train": W.start_ranks("train", 2, dirs["train"])}

    def start_the_rest():  # the (2, 2) ranks read JAX's draws
        groups["train4"] = W.start_ranks("train4", 4, dirs["train4"])
        groups["cli"] = W.start_torchrun("train_cli", 2, dirs["cli"], *CLI_V1, "--seq-shards", "2",
                                         "--output-dir", str(dirs["cli"] / "sharded"))
    try:
        out["jax"] = _jax_step(dirs["train4"], start_the_rest)
        # one process: the v1 steps on the global batch, without and with the reward, and accumulated
        states = W.v1_state_dicts()
        batch = {k: torch.from_numpy(v) for k, v in W.v1_batch().items()}
        for reward, accum in ((False, 1), (True, 1), (False, 2)):
            trainer = W.v1_trainer(dirs["train"] / f"one_{reward}_{accum}", None, reward, states=states, accum=accum)
            out[f"one reward={reward} accum={accum}"] = W.v1_steps(trainer, batch)
        train_v1.main(CLI_V1 + ["--output-dir", str(dirs["cli"] / "one")])
        trainer = W.v1_trainer(dirs["train4"] / "one", None, states=states)
        jbatch = {k: v for k, v in batch.items() if k != "reward_mask"}
        out["one jax draws"] = W.v1_steps(trainer, jbatch, n=1, draws=out["jax"]["draws"])[0]
        out["one factors jax draws"] = convert.lora_to_jax(trainer.factors)
        for name, ps in groups.items():
            codes, outs = W.finish(ps)
            assert codes == [0] * len(ps), f"{name} ranks failed:\n" + "\n".join(outs)
    finally:  # nothing left running after a failure
        for p in [p for ps in groups.values() for p in ps]:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _arrays(runs, name, rank):
    return np.load(runs["dirs"][name] / f"arrays_{rank}.npz")


def _report(runs, name, rank):
    return W.read_report(runs["dirs"][name], rank)


@pytest.mark.parametrize("op", ["halo_exchange", "gather_partials", "seq_to_space", "space_to_seq",
                                "gather_to_all"])
def test_collective_backward_matches_one_process(runs, op):
    for rank in range(2):
        assert _report(runs, "train", rank)["vjp"][op] <= 1e-12, op


def test_data_parallel_collectives(runs):
    for rank in range(2):
        vjp = _report(runs, "train", rank)["vjp"]
        assert vjp["all_reduce_"] == 0.0 and vjp["reduce_scatter_flat"] == 0.0
        assert vjp["all_gather_flat"] == [0.0] * 3 + [1.0] * 3
        assert vjp["gathered counts"] == [5, 5, 2] * 2


@pytest.mark.parametrize("layer", ["TemporalConvBlock", "TemporalTransformer"])
def test_temporal_layer_gradients_at_1x2(runs, layer):
    for rank in range(2):
        rep = _report(runs, "train", rank)["layers"][layer]
        assert rep["n_params"] > 0 and rep["params"] <= TOL
        assert rep["input"] <= TOL * max(1.0, rep["input_scale"])


def _close_steps(got, ref, name, steps):
    for i in range(steps):
        loss, gnorm, grad, flat = ref[i]
        assert float(got[f"{name}_{i}_loss"]) == pytest.approx(loss, rel=TOL, abs=1e-7)
        assert float(got[f"{name}_{i}_gnorm"]) == pytest.approx(gnorm, rel=TOL)
        np.testing.assert_allclose(got[f"{name}_{i}_flat"], flat, atol=TOL, rtol=0, err_msg=f"{name} step {i}")
        np.testing.assert_allclose(got[f"{name}_{i}_grad"], grad, atol=TOL * float(np.abs(grad).max()), rtol=0)


@pytest.mark.parametrize("name", ["v1_1x2", "v1_2x1", "v1_1x2_reward", "v1_2x1_fsdp", "v1_2x1_fsdp_accum"])
def test_v1_lora_steps_match_one_process(runs, name):
    ref = runs[f"one reward={name.endswith('reward')} accum={2 if name.endswith('accum') else 1}"]
    assert ref[0][2].any() and np.isfinite(ref[1][0])
    for rank in range(2):
        _close_steps(_arrays(runs, "train", rank), ref, name, 2)


def test_v1_lora_step_at_2x2_matches_one_process_and_jax(runs):
    ref, jx = runs["one jax draws"], runs["jax"]
    for rank in range(4):
        got = _arrays(runs, "train4", rank)
        _close_steps(got, [ref], "v1_2x2", 1)
        assert float(got["v1_2x2_0_loss"]) == pytest.approx(jx["loss"], rel=JAX_TOL)
        assert float(got["v1_2x2_0_gnorm"]) == pytest.approx(jx["gnorm"], rel=JAX_TOL)
        assert [tuple(r) for r in (_report(runs, "train4", rank)["coords"],)] == [(rank // 2, rank % 2, 0)]
    got = runs["one factors jax draws"]
    assert set(got) == set(jx["lora"])
    for k in got:
        for n in ("down", "up"):
            np.testing.assert_allclose(got[k][n], jx["lora"][k][n], atol=JAX_TOL, rtol=0, err_msg=f"{k} {n}")


@pytest.mark.parametrize("name, ref, step", [("v2_fsdp", "v2_one", 0), ("v2_fsdp", "v2_one", 1),
                                             ("v2_fsdp", "v2_one", 2), ("v2_fsdp_from_one", "v2_one", None),
                                             ("v2_one_from_fsdp", "v2_one", None)])
def test_v2_fsdp_steps_and_checkpoints_cross_world_sizes(runs, name, ref, step):
    """(2, 1) --fsdp against one process at each step; step 3 after a resume
    across world sizes (saved at (2, 1) -> one process, and the reverse)
    against the uninterrupted run's."""
    one = _arrays(runs, "train", 0)
    i_got, i_ref = (0, 2) if step is None else (step, step)
    for rank in ((0,) if name == "v2_one_from_fsdp" else (0, 1)):
        got = _arrays(runs, "train", rank)
        assert float(got[f"{name}_{i_got}_loss"]) == pytest.approx(float(one[f"{ref}_{i_ref}_loss"]), rel=TOL)
        assert float(got[f"{name}_{i_got}_gnorm"]) == pytest.approx(float(one[f"{ref}_{i_ref}_gnorm"]), rel=TOL)
        for k in ("master", "ema"):
            np.testing.assert_allclose(got[f"{name}_{i_got}_{k}"], one[f"{ref}_{i_ref}_{k}"], atol=TOL, rtol=0)
    reps = [_report(runs, "train", r) for r in range(2)]
    local = [r["v2 fsdp local"] for r in reps]
    # each data rank keeps its slices of the master and EMA: together the whole, once
    assert local[0][3] == reps[0]["v2 one slots"] == local[0][2] + local[1][2]
    assert local[0][0] < local[0][3] and local[0][1] < local[0][3]
    assert all(r["v2 resumed from one process at"] == 2 for r in reps) and reps[0]["v2 one resumed from fsdp at"] == 2


def test_latent_webdata_step_at_2x1(runs):
    reps = [_report(runs, "train", r) for r in range(2)]
    assert [r["webdata shards"] for r in reps] == [["latents_0.tar"], ["latents_1.tar"]]
    assert reps[0]["webdata txt"][0].startswith("shard 0") and reps[1]["webdata txt"][0].startswith("shard 1")
    loss, gnorm = reps[0]["webdata step"]
    assert np.isfinite(loss) and gnorm > 0 and reps[1]["webdata step"] == [loss, gnorm]


def test_validation_render_over_the_mesh(runs, tmp_path):
    """Both ranks of (1, 2) render (the UNet's seq layers are collective);
    rank 0 alone writes, the video of one process within one uint8 level."""
    from t2v_turbo_tpu_torch.apps import train_v1

    reps = [_report(runs, "train", r) for r in range(2)]
    assert reps[0]["validation files"] == reps[1]["validation files"] == ["index.jsonl", "step0000001_s2_p0.npy"]
    args = train_v1.parse_args(W.VALIDATION_ARGS + ["--output-dir", str(tmp_path)])
    trainer, _, _ = train_v1.build_trainer(args, validation=True)
    train_v1.build_validation_fn(args, trainer, max_prompts=1, step_counts=(2,), suffix=".npy")(1, trainer.student)
    name = "validation/step0000001_s2_p0.npy"
    got, want = np.load(runs["dirs"]["train"] / "validation" / name), np.load(tmp_path / name)
    assert got.shape == want.shape and np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sigterm_to_one_rank_stops_both_at_one_step(runs):
    reps = [_report(runs, "train", r)["sigterm"] for r in range(2)]
    step = reps[0]["last_step"]
    assert 0 < step < 50 and reps[1]["last_step"] == step and reps[0]["logged"] == step
    assert reps[0]["checkpoints"] == [step] == reps[1]["checkpoints"]


def test_train_v1_cli_under_torchrun_matches_one_process(runs):
    d = runs["dirs"]["cli"]
    rows = {k: [json.loads(line) for line in open(d / k / "metrics.jsonl")] for k in ("one", "sharded")}
    assert len(rows["sharded"]) == len(rows["one"]) == 2  # rank 0 alone logs
    for a, b in zip(rows["sharded"], rows["one"]):
        assert a["step"] == b["step"]
        assert a["loss"] == pytest.approx(b["loss"], rel=TOL) and a["grad_norm"] == pytest.approx(b["grad_norm"],
                                                                                                 rel=TOL)
    got, want = (np.load(d / k / "unet_lora.npz") for k in ("sharded", "one"))
    assert set(got.files) == set(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)
    assert [_report(runs, "cli", r) for r in range(2)] == [{"ran": True}] * 2


# ---- in process ----

def _grads_match(fn, plain, inputs, wanted, seed=0):
    """autograd of fn against autograd of plain on the same inputs, through a
    random cotangent of every output."""
    def run(f):
        leaves = [t.detach().clone().requires_grad_(i in wanted) if t is not None and t.is_floating_point() else t
                  for i, t in enumerate(inputs)]
        outs = f(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o.float() * torch.randn(o.shape, generator=torch.Generator().manual_seed(seed + j))).sum()
                   for j, o in enumerate(outs) if o.is_floating_point())
        return torch.autograd.grad(loss, [leaves[i] for i in wanted])

    for a, b in zip(run(fn), run(plain)):
        torch.testing.assert_close(a, b, atol=TOL * max(1.0, float(b.abs().max())), rtol=0)


def test_split_entries_and_conv_ab_backward_match_their_plain_twins():
    g = torch.Generator().manual_seed(0)
    x = 2.0 * torch.randn(2, 64, 3, 12, generator=g) + 0.5
    w, b = 1.0 + 0.1 * torch.randn(64, generator=g), 0.1 * torch.randn(64, generator=g)
    parts, counts = N.group_norm_partials_plain(x, 32)
    fs, fh = 0.1 * torch.randn(2, 64, generator=g), 0.1 * torch.randn(2, 64, generator=g)
    _grads_match(lambda t: N.group_norm_partials(t, 32), lambda t: N.group_norm_partials_plain(t, 32), [x], [0])
    _grads_match(lambda t, p, n, a, c: N.group_norm_from_partials(t, p, n, a, c, 32, 1e-6, "silu"),
                 lambda t, p, n, a, c: N.group_norm_from_partials_plain(t, p, n, a, c, 32, 1e-6, "silu"),
                 [x, parts, counts, w, b], [0, 1, 3, 4])
    _grads_match(lambda p, n, a, c, s, h: N.group_norm_affine_from_partials(p, n, a, c, 32, 1e-6, s, h),
                 lambda p, n, a, c, s, h: N.group_norm_affine_from_partials_plain(p, n, a, c, 32, 1e-6, s, h),
                 [parts, counts, w, b, fs, fh], [0, 2, 3, 4, 5])
    a, sh = FC.gn_affine_vectors(x, w, b, 32, 1e-6)
    kernel, bias = torch.randn(8, 64, 3, 1, generator=g) / 8.0, 0.1 * torch.randn(8, generator=g)
    _grads_match(FC.fused_gn_silu_conv_ab, FC.fused_gn_silu_conv_ab_plain, [x, a, sh, kernel, bias], [0, 1, 2, 3, 4])
    # the whole chain, partials to B7, against the unsplit plain composition
    _grads_match(lambda t, c1, c2, k_, b_: FC.fused_gn_silu_conv_ab(
        t, *N.group_norm_affine_from_partials(*N.group_norm_partials(t, 32), c1, c2, 32, 1e-6), k_, b_),
        lambda t, c1, c2, k_, b_: FC.fused_gn_silu_conv_plain(t, c1, c2, k_, b_, 32, 1e-6),
        [x, w, b, kernel, bias], [0, 1, 2, 3, 4])


def test_data_rank_shard_split():
    from t2v_turbo_tpu_torch.data.webdata import split_shards_by_host
    from t2v_turbo_tpu_torch.parallel.mesh import Mesh

    shards = [f"s{i}.tar" for i in range(5)]
    got = [split_shards_by_host(shards, mesh=Mesh(2, 2, 1, r, torch.device("cpu"), ())) for r in range(4)]
    assert got == [shards[0::2], shards[0::2], shards[1::2], shards[1::2]]  # the seq ranks of a data index agree
    assert split_shards_by_host(shards, 1, 3) == shards[1::3]


def test_refusals(tmp_path):
    from t2v_turbo_tpu_torch.apps import train_v1, train_v2
    from t2v_turbo_tpu_torch.parallel import multihost

    args = train_v2.parse_args(["--latent-glob", "none", "--seq-shards", "2", "--tiny-model", "--device", "cpu"])
    with pytest.raises(SystemExit, match="temporal attention's probability capture"):
        train_v2.build_trainer(args)
    multihost.initialize(f"localhost:{W.free_port()}", 1, 0, device_type="cpu", timeout_s=60)
    try:
        args = train_v1.parse_args(CLI_V1 + ["--seq-shards", "2", "--output-dir", str(tmp_path)])
        with pytest.raises(SystemExit, match="needs a world of data x 2 ranks, the world has 1"):
            train_v1.build_trainer(args)
    finally:
        multihost.shutdown()
