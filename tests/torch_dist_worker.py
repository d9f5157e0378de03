"""Rank processes for the port's torch.distributed CPU tests
(tests/test_torch_parallel.py, tests/test_torch_seq_parallel.py,
tests/test_torch_sharded_training.py, tests/test_torch_v2_preprocess.py,
tests/test_torch_v2_train.py).

The tests start every rank as its own process with `subprocess` (never by
forking a process that imported JAX): this module imports torch, numpy and
the port only. Each case runs on the CPU over gloo and writes what it
measured to OUT_DIR (report_<rank>.json: {check: value}; arrays in
<name>_<rank>.npz), for the test to assert on.

    python tests/torch_dist_worker.py CASE RANK WORLD PORT OUT_DIR [ARGS...]

Under torchrun (`start_torchrun`) the rank, world and address come from its
environment and CASE and OUT_DIR are the only arguments.
"""

from __future__ import annotations

import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT_S = 120  # a rank that waits longer in a collective fails (the process group's timeout)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]), OMP_NUM_THREADS="1")
    for v in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(v, None)
    return env


def finish(procs, timeout: float = 2 * TIMEOUT_S):
    """Wait for every process (killing all on a timeout); (return codes, outputs)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def _popen(cmd):
    return subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def start_ranks(case: str, world: int, out_dir, *args):
    """Start `case` (with `args`) on `world` rank processes (`finish` waits for them)."""
    port = free_port()
    return [_popen([sys.executable, __file__, case, str(r), str(world), str(port), str(out_dir), *args])
            for r in range(world)]


def start_torchrun(case: str, world: int, out_dir, *args):
    """Start `case` under torchrun on `world` local ranks (one process, `finish` waits for it)."""
    return [_popen([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(world), "--master-addr",
                    "localhost", "--master-port", str(free_port()), __file__, case, str(out_dir), *args])]


def read_report(out_dir, rank: int) -> dict:
    with open(os.path.join(out_dir, f"report_{rank}.json")) as f:
        return json.load(f)


# ---- the tiny models: tests/test_torch_pipeline.py's configs and weights ----

def tiny_models(seed_unet=0, seed_vae=1):
    """The tiny VC2 UNet (w-embedding 256) and VAE with tests/test_torch_pipeline.py's seeded weights."""
    from torch_parity import TINY_UNET_KW, TINY_VAE_KW, seeded_numpy_state_dict, to_torch

    from t2v_turbo_tpu_torch.models import AutoencoderKL, UNetConfig, UNetModel, VAEConfig

    unet = UNetModel(UNetConfig(**dict(TINY_UNET_KW, time_cond_proj_dim=256)))
    vae = AutoencoderKL(VAEConfig(**TINY_VAE_KW))
    for m, seed in ((unet, seed_unet), (vae, seed_vae)):
        m.load_state_dict(to_torch(seeded_numpy_state_dict(m, seed)), strict=True)
    return unet.eval(), vae.eval()


def tiny_pipeline(mesh=None):
    from t2v_turbo_tpu_torch.diffusion import DiffusionSchedule
    from t2v_turbo_tpu_torch.pipelines.vc2 import T2VTurboVC2Pipeline

    unet, vae = tiny_models()
    return T2VTurboVC2Pipeline(unet=unet, vae=vae, text_model=None, tokenizer=None,
                               schedule=DiffusionSchedule.create(), device="cpu", vae_scale=2, dtype=torch.float32,
                               mesh=mesh)


def cli_spec():
    """The small VC2 spec the CLI tests build (test_torch_pipeline.py's)."""
    from torch_parity import TINY_UNET_KW, TINY_VAE_KW

    from t2v_turbo_tpu_torch.config import VC2ModelSpec
    from t2v_turbo_tpu_torch.models import CLIPTextConfig, UNetConfig, VAEConfig

    return VC2ModelSpec(unet=UNetConfig(**dict(TINY_UNET_KW, time_cond_proj_dim=256, context_dim=64)),
                        vae=VAEConfig(**TINY_VAE_KW), text=CLIPTextConfig(width=64, heads=2, layers=2))


CLI_ARGS = ["--random-weights", "--device", "cpu", "--frames", "4", "--height", "16", "--width", "16", "--steps",
            "2", "--seed", "5"]


def sampling_inputs(batch=2, frames=4, latent_hw=8, steps=2, ctx_len=7, ctx_dim=16, seed=11):
    """Global latents, per-step noise and contexts from numpy."""
    rng = np.random.RandomState(seed)
    lat = rng.randn(batch, frames, latent_hw, latent_hw, 4).astype(np.float32)
    noise = rng.randn(steps, *lat.shape).astype(np.float32)
    ctx = rng.randn(batch, ctx_len, ctx_dim).astype(np.float32)
    return lat, noise, ctx


def stand_in_mesh(data=1, seq=1, model=2, rank=0):
    """The mesh `rank` of a (data, seq, model) world sees, built without
    process groups: for what reads only its shape and groups' layout (the
    refusals, a shard plan); no collective can run over it."""
    from t2v_turbo_tpu_torch.parallel.mesh import AXES, AxisGroup, Mesh

    sizes = (data, seq, model)
    here = (rank // (seq * model), (rank // model) % seq, rank % model)
    axes = []
    for i, name in enumerate(AXES):
        ranks = []
        for k in range(sizes[i]):
            c = list(here)
            c[i] = k
            ranks.append((c[0] * seq + c[1]) * model + c[2])
        axes.append(AxisGroup(name, sizes[i], here[i], tuple(ranks), None, "gloo"))
    n = data * seq * model
    axes.append(AxisGroup("world", n, rank, tuple(range(n)), None, "gloo"))
    return Mesh(data, seq, model, rank, torch.device("cpu"), tuple(axes))


# ---- the cases ----

def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def case_ops(rank, world, out_dir):
    """mesh / multihost and the collectives' building blocks on a world of 2."""
    import torch.distributed as dist

    from t2v_turbo_tpu_torch.models.layers import (
        GroupNorm, TemporalConvBlock, TemporalTransformer, clip_partials, gn_silu_conv, gn_silu_conv_seq,
    )
    from t2v_turbo_tpu_torch.ops import norms as N
    from t2v_turbo_tpu_torch.ops.fused_conv import gn_affine_vectors
    from t2v_turbo_tpu_torch.parallel import collectives as C
    from t2v_turbo_tpu_torch.parallel import multihost
    from t2v_turbo_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from torch_parity import seeded_numpy_state_dict, to_torch

    from t2v_turbo_tpu_torch.training.trainer import LCDTrainer

    rep = {}
    # the mesh and its errors (JAX's messages)
    for label, kw, exc in (("not divisible", dict(seq=3), ValueError), ("mismatch", dict(data=1, seq=1), ValueError)):
        try:
            make_mesh(**kw)
            rep[f"mesh error {label}"] = "none"
        except exc as e:
            rep[f"mesh error {label}"] = str(e)
    # the model axis: its mesh is made, and the trainer, which does not take it yet, refuses it
    model_mesh = make_mesh(seq=1, model=2)
    rep["model mesh"] = [model_mesh.data, model_mesh.seq, model_mesh.model, list(model_mesh.coords()),
                         list(model_mesh.axis("model").ranks), model_mesh.axis("model").index]
    try:
        LCDTrainer(student=None, sched=None, solver=None, optimizer=None, cfg=None, mesh=model_mesh)
        rep["mesh error model"] = "none"
    except NotImplementedError as e:
        rep["mesh error model"] = str(e)
    seq_mesh, data_mesh = make_mesh(seq=2), make_mesh()
    rep["seq mesh"] = [seq_mesh.data, seq_mesh.seq, seq_mesh.model, list(seq_mesh.coords()),
                       list(seq_mesh.axis("seq").ranks), seq_mesh.axis("seq").index]
    rep["data mesh"] = [data_mesh.data, data_mesh.seq, list(data_mesh.coords()), list(data_mesh.axis("data").ranks)]

    # host_local_batch_to_global (tests/test_multihost.py's check): each rank
    # passes different rows; over data they stay local, over seq T splits
    rows = np.full((2, 4, 8, 8, 4), float(rank), np.float32)
    vec = np.full((2,), float(rank), np.float32)
    b = multihost.host_local_batch_to_global(data_mesh, {"latents": rows, "fps": vec, "_text": ["dropped"]})
    total = b["fps"].sum()
    dist.all_reduce(total, group=data_mesh.axis("data").pg)
    rep["batch data"] = [sorted(b), list(b["latents"].shape), float(total) / (2 * world)]
    b = multihost.host_local_batch_to_global(seq_mesh, {"latents": np.arange(2 * 4 * 3, dtype=np.float32).reshape(
        2, 4, 3, 1, 1)})
    rep["batch seq frames"] = b["latents"][0, :, 0, 0, 0].tolist()
    sb = shard_batch(seq_mesh, {"x": torch.arange(16.0).view(1, 4, 2, 2, 1), "rows": torch.arange(1.0),
                                "s": torch.tensor(3.0)})
    rep["shard_batch"] = [list(sb["x"].shape), float(sb["x"][0, 0, 0, 0, 0]), list(sb["rows"].shape), float(sb["s"])]

    group = seq_mesh.axis("seq")
    g = torch.Generator().manual_seed(3)
    b_, c_, t_, h_, w_ = 2, 64, 6, 3, 4  # T = 6: 3 frames a rank; L = 2 * 3 * 12 = 72 a rank's row part
    clip = 3.0 * torch.randn(b_, c_, t_, h_, w_, generator=g) + 1.0
    t0 = rank * t_ // world
    mine = clip[:, :, t0:t0 + t_ // world].contiguous()
    weight, bias = 1.0 + 0.1 * torch.randn(c_, generator=g), 0.1 * torch.randn(c_, generator=g)
    # B4's partials -> gather -> apply over the whole clip, chunks of 7 (a short last chunk mid-row once gathered)
    parts, counts = N.group_norm_partials_plain(mine, 32, chunk=7)
    rep["partial counts"] = counts.tolist()
    parts, counts = C.gather_partials(parts, counts, group)
    rep["gathered counts"] = counts.tolist()
    y = N.group_norm_from_partials(mine, parts, counts, weight, bias, 32, 1e-6, "silu")
    ref = N.group_norm_plain(clip, weight, bias, 32, 1e-6, "silu")[:, :, t0:t0 + t_ // world]
    rep["partials chain max_err"] = _err(y, ref)
    a, sh = N.group_norm_affine_from_partials(parts, counts, weight, bias, 32, 1e-6)
    ra, rb = gn_affine_vectors(clip, weight, bias, 32, 1e-6)
    rep["affine from partials max_err"] = max(_err(a, ra), _err(sh, rb))
    fs, fh = 0.1 * torch.randn(b_, c_, generator=g), 0.1 * torch.randn(b_, c_, generator=g)
    a, sh = N.group_norm_affine_from_partials(parts, counts, weight, bias, 32, 1e-6, fs, fh)
    ra, rb = gn_affine_vectors(clip, weight, bias, 32, 1e-6, fs, fh)
    rep["affine from partials film max_err"] = max(_err(a, ra), _err(sh, rb))

    # seq_to_space and back
    flat = clip.reshape(b_, c_, t_, h_ * w_)
    cols = h_ * w_ // world
    space = C.seq_to_space(mine.reshape(b_, c_, -1, h_ * w_), group)
    rep["seq_to_space max_err"] = _err(space, flat[:, :, :, rank * cols:(rank + 1) * cols])
    rep["round trip max_err"] = _err(C.space_to_seq(space, group), mine.reshape(b_, c_, -1, h_ * w_))
    try:
        C.seq_to_space(torch.zeros(1, 2, 3, 15), group)
        rep["seq_to_space 15 columns"] = "none"
    except ValueError as e:
        rep["seq_to_space 15 columns"] = str(e)
    halo = C.halo_exchange(mine, group, 2)
    lo, hi = C.halo_sides(group)
    rep["halo"] = [lo, hi, _err(halo, clip[:, :, t0 - lo:t0 + t_ // world + hi])]

    # the halo conv, one stage and the whole block; the temporal transformer
    torch.manual_seed(0)
    block = TemporalConvBlock(c_)
    block.load_state_dict(to_torch(seeded_numpy_state_dict(block, 4)))
    with torch.no_grad():
        whole = gn_silu_conv(block.conv1[0], block.conv1[-1], clip)[:, :, t0:t0 + t_ // world]
        rep["halo conv max_err"] = _err(gn_silu_conv_seq(block.conv1[0], block.conv1[-1], mine, group), whole)
        whole = block(clip)[:, :, t0:t0 + t_ // world]
        block.seq_group = group
        rep["TemporalConvBlock max_err"] = _err(block(mine), whole)
        tt = TemporalTransformer(c_, 2, 32)
        tt.load_state_dict(to_torch(seeded_numpy_state_dict(tt, 5)))
        whole = tt(clip)[:, :, t0:t0 + t_ // world]
        tt.seq_group = group
        rep["TemporalTransformer max_err"] = _err(tt(mine), whole)
    parts, _ = clip_partials(GroupNorm(c_), mine, group)
    rep["clip partials rows"] = list(parts.shape)
    rep["collective calls"] = {k: v["calls"] for k, v in C.read_counters().items()}
    return rep


# (data, seq, model) meshes of each world; a name "DxS" for a mesh without a model axis, "DxSxM" with one
SAMPLING_MESHES = {2: [(1, 2, 1), (1, 1, 2)], 4: [(1, 4, 1), (2, 2, 1), (1, 2, 2), (2, 1, 2), (1, 1, 4)]}


def mesh_name(data, seq, model=1) -> str:
    return f"{data}x{seq}" + (f"x{model}" if model > 1 else "")


def case_sampling(rank, world, out_dir):
    """The tiny UNet and pipeline over every (data, seq, model) mesh this
    world takes, each rank's UNet output and rank 0's video saved; with a
    model axis, the model all-reduce's calls in the UNet pass beside the
    plan's row layers."""
    from t2v_turbo_tpu_torch.parallel import collectives, tp
    from t2v_turbo_tpu_torch.parallel.mesh import make_mesh, shard

    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    lat, noise, ctx = (torch.from_numpy(inputs[k]) for k in ("lat", "noise", "ctx"))
    rep, arrays = {}, {}
    for data, seq, model in SAMPLING_MESHES[world]:
        mesh = make_mesh(data=data, seq=seq, model=model)
        pipe = tiny_pipeline(mesh)
        name = mesh_name(data, seq, model)
        t = torch.full((lat.shape[0],), 500, dtype=torch.long)
        w_emb = torch.from_numpy(inputs["w_emb"])
        collectives.reset_counters()
        with torch.no_grad():
            out = pipe.unet(shard(mesh, lat, ("data", "seq")), shard(mesh, t, ("data",)),
                            shard(mesh, ctx, ("data",)), fps=shard(mesh, torch.full((lat.shape[0],), 16.0), ("data",)),
                            timestep_cond=shard(mesh, w_emb, ("data",)))
        arrays[f"unet_{name}"] = out.numpy()
        if model > 1:
            rep[f"model all-reduces {name}"] = [collectives.model_all_reduce.calls, tp.row_layers(pipe.unet.tp_plan)]
            rep[f"model coords {name}"] = list(mesh.coords())
        video = pipe(prompt_embeds=ctx, latents=lat, noise=list(noise), height=16, width=16, frames=lat.shape[1],
                     num_inference_steps=noise.shape[0])
        rep[f"video {name}"] = video is not None
        if video is not None:
            arrays[f"video_{name}"] = video.numpy()
        latents = pipe(prompt_embeds=ctx, latents=lat, noise=list(noise), height=16, width=16, frames=lat.shape[1],
                       num_inference_steps=noise.shape[0], output_type="latent")
        arrays[f"latent_{name}"] = latents.numpy()
        try:
            pipe(prompt_embeds=ctx, latents=lat[:, :3], height=16, width=16, frames=3, num_inference_steps=1)
            rep[f"divisibility {name}"] = "none"
        except ValueError as e:
            rep[f"divisibility {name}"] = str(e)
    np.savez(os.path.join(out_dir, f"arrays_{rank}.npz"), **arrays)
    return rep


def case_serve(rank, world, out_dir, axis="seq"):
    """apps/serve.py on 2 ranks at --seq-shards 2 (or --model-shards 2,
    axis "model"): rank 0 answers one POST (to itself), the other rank
    follows; then the shutdown."""
    import threading
    import urllib.request

    from t2v_turbo_tpu_torch.apps import serve

    serve.HEARTBEAT_S = 0.2  # several heartbeats while rank 0 idles below
    argv = CLI_ARGS[:3] + ["--port", "0", "--output-dir", os.path.join(out_dir, "served"), f"--{axis}-shards", "2"]
    if rank != 0:
        serve.main(argv, cli_spec())
        return {"followed": True}
    server, pipe, _ = serve.build_server(argv, cli_spec())
    threading.Thread(target=server.serve_forever, daemon=True).start()
    import time

    time.sleep(0.5)  # heartbeats while idle
    body = json.dumps({"prompt": "a cat", "seed": 7, "frames": 4, "height": 16, "width": 16, "steps": 2}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/generate", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
        answer = json.loads(r.read())
    server.shutdown()
    serve.stop(server)
    from t2v_turbo_tpu_torch.parallel import multihost

    multihost.shutdown()
    return {"answer": answer, "relay closed": server.relay.closed}


def case_generate(rank, world, out_dir, name="sharded", *flags):
    """apps/generate.py under torchrun, writing <name>.npy: at --seq-shards 2,
    or at the flags given."""
    from t2v_turbo_tpu_torch.apps import generate

    generate.main(CLI_ARGS + ["--prompt", "a cat", *(flags or ("--seq-shards", "2")), "--output",
                              os.path.join(out_dir, f"{name}.npy")], cli_spec())
    return {"rank": rank}


# ---- training under the mesh (tests/test_torch_sharded_training.py) ----

# the dryrun's smallest UNet (__graft_entry__.py:211, its v2 FSDP step's; its JAX-only temporal_length left out)
V1_UNET_KW = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(1,), channel_mult=(1,),
                  num_head_channels=8, context_dim=32, time_cond_proj_dim=8)
V1_RANK, V1_LR, V1_MAX_NORM = 4, 1e-2, 0.5  # Adam at eps 1: an update smooth in the gradient
# the l2 distillation loss: Huber's at c = 1e-3 has a slope of 1/c where |pred - target| ~ c, which
# turns the f32 round-off of a reordered sum into 1e-4 of the gradient (tests/test_torch_training.py)
# the v2 trainer: tests/test_torch_v2_train.py's one-level motion UNet and text tower
V2_UNET_KW = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(1,), channel_mult=(1,),
                  num_head_channels=16, context_dim=16, time_cond_proj_dim=8, motion_cond_proj_dim=8)
V2_TEXT_KW = dict(vocab_size=64, width=16, heads=4, layers=4, context_length=7)
V2_CFG = dict(w_embedding_dim=8, use_motion_cond=True, motion_gs=0.5, reward_scale=0.3)


# train_v1's tiny trainer with its validation render (VAE and text tower)
VALIDATION_ARGS = ["--tiny-model", "--synthetic-data", "--random-weights", "--device", "cpu", "--lora-rank", "4"]


def v1_batch(b=2, frames=4, seed=30):
    """A global v1 batch (numpy), the second sample outside the reward mask."""
    rng = np.random.RandomState(seed)
    return {"latents": rng.randn(b, frames, 8, 8, 4).astype(np.float32),
            "ctx": rng.randn(b, 7, 32).astype(np.float32), "uncond_ctx": np.zeros((b, 7, 32), np.float32),
            "fps": np.full((b,), 16.0, np.float32), "reward_mask": (np.arange(b) % 2 == 0).astype(np.float32)}


def clip_reward(pred, batch):
    """A reward that needs every frame of a clip: the mean product of
    neighbouring frames of each sample."""
    return (pred[:, 1:] * pred[:, :-1]).mean(dim=(1, 2, 3, 4))


def v1_state_dicts(seed=20):
    """(student, teacher) numpy state dicts of the dryrun's smallest UNet and
    the seeded LoRA factors (non-zero ups)."""
    from torch_parity import seeded_lora_factors, seeded_numpy_state_dict

    from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel

    sds = []
    for i, tcp in enumerate((8, None)):
        with torch.device("meta"):
            m = UNetModel(UNetConfig(**{**V1_UNET_KW, "time_cond_proj_dim": tcp}))
        sds.append(seeded_numpy_state_dict(m, seed + i))
    with torch.device("meta"):
        m = UNetModel(UNetConfig(**V1_UNET_KW))
    return sds[0], sds[1], seeded_lora_factors(m, seed + 2, V1_RANK)


def v1_trainer(out_dir, mesh=None, reward=False, fsdp=False, states=None, accum=1):
    """The v1 LoRA trainer on the dryrun's smallest UNet with the seeded
    weights and factors (`v1_state_dicts`), the l2 loss, Adam at eps 1,
    over `mesh`."""
    from torch_parity import to_torch

    from t2v_turbo_tpu_torch.diffusion import DDIMSolver, DiffusionSchedule
    from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel
    from t2v_turbo_tpu_torch.training.lcd import LCDConfig
    from t2v_turbo_tpu_torch.training.optim import make_optimizer
    from t2v_turbo_tpu_torch.training.trainer import LCDTrainer, TrainerConfig

    ssd, tsd, factors = states or v1_state_dicts()
    student = UNetModel(UNetConfig(**V1_UNET_KW))
    teacher = UNetModel(UNetConfig(**{**V1_UNET_KW, "time_cond_proj_dim": None}))
    for m, sd in ((student, ssd), (teacher, tsd)):
        m.load_state_dict(to_torch(sd), strict=True)
        m.requires_grad_(False)
    sched = DiffusionSchedule.create()
    trainer = LCDTrainer(
        student=student, teacher=teacher, sched=sched, solver=DDIMSolver.create(sched.alphas_cumprod.numpy()),
        lcd_cfg=LCDConfig(w_embedding_dim=8, reward_scale=0.7, loss_type="l2"),
        optimizer=functools.partial(make_optimizer, name="adamw", learning_rate=V1_LR, eps=1.0),
        cfg=TrainerConfig(output_dir=str(out_dir), lora_rank=V1_RANK, seed=5, max_grad_norm=V1_MAX_NORM,
                          log_every=1, checkpoint_every=10**6, fsdp=fsdp, grad_accum_steps=accum),
        reward_fn=clip_reward if reward else None, mesh=mesh)
    with torch.no_grad():
        for n, f in trainer.factors.items():
            for k, t in f.items():
                t.copy_(factors[n][k])
        if trainer._shards is not None:  # with fsdp the optimizer steps this rank's slices of them
            trainer._state.copy_(trainer._shards.take(trainer.flat))
    return trainer


def v1_steps(trainer, batch, n=2, draws=None):
    """n steps on a device batch; [(loss, grad_norm, gradient, factors)] after each."""
    out = []
    for _ in range(n):
        m = trainer.train_step(batch, draws) if draws is not None else trainer.step_device(batch)
        grad = trainer._grad_flat if trainer._shards is None else trainer._whole(trainer._grad_shard)
        out.append((float(m["loss"]), float(m["grad_norm"]), grad.detach().clone().numpy(),
                    trainer.flat.detach().clone().numpy()))
    return out


def v2_models(seed=81):
    from torch_parity import seeded_numpy_state_dict, to_torch

    from t2v_turbo_tpu_torch.models import CLIPTextConfig, CLIPTextModel, UNetConfig, UNetModel

    student, text = UNetModel(UNetConfig(**V2_UNET_KW)), CLIPTextModel(CLIPTextConfig(**V2_TEXT_KW))
    for m, sd_seed in ((student, seed), (text, seed + 1)):
        m.load_state_dict(to_torch(seeded_numpy_state_dict(m, sd_seed)), strict=True)
    return student, text


def v2_batch(b=2, seed=80):
    rng = np.random.RandomState(seed)
    shape = (b, 4, 8, 8, 4)
    return {"index": np.array([45, 10, 40, 20][:b], np.int64), "z_t": rng.randn(*shape).astype(np.float32),
            "cond_teacher_out": rng.randn(*shape).astype(np.float32),
            "uncond_teacher_out": rng.randn(*shape).astype(np.float32),
            "score": rng.randn(*shape).astype(np.float32), "prompt_emb": rng.randn(b, 7, 16).astype(np.float32),
            "use_motion_guide": np.array([True, True, False, True][:b]),
            "tokens": rng.randint(0, 64, size=(b, 7)).astype(np.int64)}


def write_v2_pickles(out_dir, n=4, frames=4):
    """n v2 samples as apps/preprocess.py writes them, at train_v2
    --tiny-model's shapes (v2_batch's rows); the glob."""
    import pickle

    os.makedirs(out_dir, exist_ok=True)
    for i in range(n):
        row = {k: v[0] for k, v in v2_batch(b=1, seed=90 + i).items() if k != "tokens"}
        row.update(index=np.int32([45, 10, 40, 20][i % 4]), use_motion_guide=bool(i % 3), txt=f"clip {i}",
                   short_txt="", **{k: row[k][:frames] for k in ("z_t", "cond_teacher_out", "uncond_teacher_out",
                                                                  "score")})
        with open(os.path.join(out_dir, f"{i:05d}.pkl"), "wb") as f:
            pickle.dump(row, f)
    return os.path.join(out_dir, "*.pkl")


def v2_trainer(out_dir, mesh=None, fsdp=False, text=True):
    """The full-model v2 trainer: int8 moments (eps 1), the EMA target, the
    text-encoder group (with `text`), over `mesh`."""
    from t2v_turbo_tpu_torch.diffusion import DDIMSolver, DiffusionSchedule
    from t2v_turbo_tpu_torch.training import lcd_v2, optim
    from t2v_turbo_tpu_torch.training.trainer import LCDTrainer, TrainerConfig

    student, tower = v2_models()
    sched = DiffusionSchedule.create()
    return LCDTrainer(
        student=student, sched=sched, solver=DDIMSolver.create(sched.alphas_cumprod.numpy()),
        lcd_cfg=lcd_v2.LCDV2Config(**V2_CFG),
        optimizer=functools.partial(optim.make_v2_optimizer, name="adamw8bit", learning_rate=1e-4,
                                    temporal_learning_rate=1e-3, eps=1.0),
        cfg=TrainerConfig(output_dir=str(out_dir), lora_rank=None, seed=3, max_grad_norm=5.0, log_every=1,
                          checkpoint_every=10**6, ema_decay=0.9, fsdp=fsdp),
        loss_fn=lcd_v2.trainer_loss, draws_fn=lcd_v2.trainer_draws, text_encoder=tower if text else None,
        param_label=functools.partial(optim.v2_param_label, unlocked_text_layers=2, text_resblocks=3), mesh=mesh)


def resume_draws(trainer, step):
    """The draws' generator as `run` seeds it when it (re)starts at `step`:
    the continuing runs and the resumed ones draw alike from there on."""
    from t2v_turbo_tpu_torch.training.trainer import draws_seed

    trainer.generator.manual_seed(draws_seed(trainer.cfg.seed, step))


def v2_record(trainer, metrics):
    """(loss, grad_norm, the whole master, the whole EMA) after a step (with
    fsdp a collective)."""
    return (float(metrics["loss"]), float(metrics["grad_norm"]), trainer.whole_master().detach().cpu().numpy().copy(),
            trainer.whole_ema().detach().cpu().numpy().copy())


def _save_steps(arrays, name, steps, keys=("loss", "gnorm", "grad", "flat")):
    for i, st in enumerate(steps):
        for key, v in zip(keys, st):
            arrays[f"{name}_{i}_{key}"] = np.asarray(v)


V2_KEYS = ("loss", "gnorm", "master", "ema")


def _collective_vjps(rank, group):
    """Each collective's gradient on this rank against autograd through the
    one-process op on the global tensors (f64); max |d| each."""
    from t2v_turbo_tpu_torch.parallel import collectives as C

    n = group.size
    g = torch.Generator().manual_seed(40)

    def weights(shape, q):
        return torch.randn(shape, generator=torch.Generator().manual_seed(100 + q), dtype=torch.float64)

    def check(name, full_shape, mine_of, fwd, ref_of):
        """mine_of(X) -> this rank's input; fwd(x) -> its output; ref_of(X,
        q) -> rank q's output from the global X, differentiably."""
        X = torch.randn(full_shape, generator=g, dtype=torch.float64)
        x = mine_of(X, rank).clone().requires_grad_()
        y = fwd(x)
        (y * weights(y.shape, rank)).sum().backward()
        Xg = X.clone().requires_grad_()
        sum((ref_of(Xg, q) * weights(ref_of(X, q).shape, q)).sum() for q in range(n)).backward()
        return float((x.grad - mine_of(Xg.grad, rank)).abs().max())

    def frames(X, q, t=3):
        return X[:, :, q * t:(q + 1) * t]

    def halo_ref(X, q, t=3):
        lo, hi = int(q > 0), int(q < n - 1)
        return X[:, :, q * t - lo:(q + 1) * t + hi]

    rep = {
        "halo_exchange": check("halo", (2, 3, 3 * n, 5), frames, lambda x: C.halo_exchange(x, group, 2), halo_ref),
        "seq_to_space": check("s2s", (1, 2, 3 * n, 4 * n), frames, lambda x: C.seq_to_space(x, group),
                              lambda X, q: X[..., q * 4:(q + 1) * 4]),
        "space_to_seq": check("s2q", (1, 2, 3 * n, 4 * n), lambda X, q: X[..., q * 4:(q + 1) * 4],
                              lambda x: C.space_to_seq(x, group), frames),
        "gather_to_all": check("g2a", (n, 3, 4), lambda X, q: X[q], lambda x: C.gather_to_all(x, group),
                               lambda X, q: X),
    }
    counts = torch.tensor([5, 5, 2], dtype=torch.int32)
    rep["gather_partials"] = check(
        "partials", (2, 3 * n, 2), lambda X, q: X[:, 3 * q:3 * (q + 1)],
        lambda x: C.gather_partials(x, counts, group)[0], lambda X, q: X)
    _, every = C.gather_partials(torch.zeros(2, 3, 2, dtype=torch.float64), counts, group)
    rep["gathered counts"] = every.tolist()
    # the data-parallel helpers (values)
    v = torch.arange(4.0 * n) + 10.0 * rank
    whole = sum(torch.arange(4.0 * n) + 10.0 * q for q in range(n))
    rep["all_reduce_"] = float((C.all_reduce_(v.clone(), group) - whole).abs().max())
    rep["reduce_scatter_flat"] = float((C.reduce_scatter_flat(v, group) - whole[4 * rank:4 * (rank + 1)]).abs().max())
    rep["all_gather_flat"] = C.all_gather_flat(torch.full((3,), float(rank)), group).tolist()
    return rep


def _temporal_layer_grads(rank, group):
    """TemporalConvBlock and TemporalTransformer at (1, 2): the parameter
    gradients summed over the seq ranks and the input gradient of this
    rank's frames against one process's (f32)."""
    from torch_parity import seeded_numpy_state_dict, to_torch

    from t2v_turbo_tpu_torch.models.layers import TemporalConvBlock, TemporalTransformer
    from t2v_turbo_tpu_torch.parallel import collectives as C

    g = torch.Generator().manual_seed(3)
    b, c, t, hh, ww = 2, 64, 6, 3, 4
    clip = 3.0 * torch.randn(b, c, t, hh, ww, generator=g) + 1.0
    w_out = torch.randn(b, c, t, hh, ww, generator=g)
    t0, tl = rank * t // group.size, t // group.size
    rep = {}
    for name, make, seed in (("TemporalConvBlock", lambda: TemporalConvBlock(c), 4),
                             ("TemporalTransformer", lambda: TemporalTransformer(c, 2, 32), 5)):
        layer = make()
        layer.load_state_dict(to_torch(seeded_numpy_state_dict(layer, seed)))
        x = clip.clone().requires_grad_()
        (layer(x) * w_out).sum().backward()
        ref = {k: p.grad.clone() for k, p in layer.named_parameters()}
        ref_x = x.grad[:, :, t0:t0 + tl]
        layer.zero_grad()
        layer.seq_group = group
        mine = clip[:, :, t0:t0 + tl].clone().requires_grad_()
        (layer(mine) * w_out[:, :, t0:t0 + tl]).sum().backward()
        errs = []
        for k, p in layer.named_parameters():
            got = C.all_reduce_(p.grad.clone(), group)
            errs.append(float((got - ref[k]).abs().max()) / max(1.0, float(ref[k].abs().max())))
        rep[name] = {"params": max(errs), "input": float((mine.grad - ref_x).abs().max()),
                     "input_scale": float(ref_x.abs().max()), "n_params": len(errs)}
    return rep


# ---- the motion prior and v2 under the seq axis (tests/test_torch_v2_preprocess.py, test_torch_v2_train.py) ----

def write_inputs(out_dir, config: dict, **arrays) -> None:
    """A test's inputs for its rank case: config.json and inputs.npz."""
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f)
    np.savez(os.path.join(out_dir, "inputs.npz"), **arrays)


def _read_inputs(out_dir):
    with open(os.path.join(out_dir, "config.json")) as f:
        cfg = json.load(f)
    return cfg, dict(np.load(os.path.join(out_dir, "inputs.npz")))


def _unet(kw, arrays, prefix):
    """A UNet of config `kw` with the state dict stored under `prefix` in `arrays`."""
    from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    unet = UNetModel(UNetConfig(**kw))
    unet.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith(prefix)},
                         strict=True)
    return unet


class CountingTeacher(torch.nn.Module):
    """A UNet counting its calls; `set_seq_group` reaches the UNet."""

    def __init__(self, unet):
        super().__init__()
        self.unet, self.calls = unet, 0

    def set_seq_group(self, group):
        self.unet.set_seq_group(group)

    def forward(self, *args, **kw):
        self.calls += 1
        return self.unet(*args, **kw)


def _my_columns(p, b, cols, rank, n):
    """This rank's rows of a one-process capture (B*S*heads, T, T): those of
    its S / n columns."""
    t = p.shape[-1]
    return p.view(b, cols, -1, t, t)[:, rank * cols // n:(rank + 1) * cols // n].reshape(-1, t, t)


def case_v2_capture(rank, world, out_dir):
    """At (1, 2) against one process in the same rank: a two-block
    TemporalTransformer's capture; the tiny teacher's capture, rank loss and
    motion score; `preprocess_sample(mesh=)` on the test's latents and
    draws (rank 0 pickles its sample)."""
    from t2v_turbo_tpu_torch import diffusion as P
    from t2v_turbo_tpu_torch.models.layers import TemporalTransformer
    from t2v_turbo_tpu_torch.parallel import collectives as C
    from t2v_turbo_tpu_torch.parallel.mesh import make_mesh
    from t2v_turbo_tpu_torch.training import motion
    from t2v_turbo_tpu_torch.training import preprocess as ppre
    from torch_parity import seeded_numpy_state_dict, to_torch

    cfg, z = _read_inputs(out_dir)
    mesh = make_mesh(data=1, seq=2)
    group = mesh.axis("seq")
    rep = {}

    # a TemporalTransformer of two blocks: both blocks' probabilities and the output
    g = torch.Generator().manual_seed(3)
    b, c, t, hh, ww = 2, 64, 4, 3, 4
    clip = 3.0 * torch.randn(b, c, t, hh, ww, generator=g) + 1.0
    t0, tl = rank * t // world, t // world
    tt = TemporalTransformer(c, 2, 32, depth=2)
    tt.load_state_dict(to_torch(seeded_numpy_state_dict(tt, 5)))
    with torch.no_grad():
        out, probs = tt(clip, record_probs=True)
        tt.seq_group = group
        mine, mine_probs = tt(clip[:, :, t0:t0 + tl], record_probs=True)
    rep["tt"] = {"layers": [len(probs), len(mine_probs)], "out": _err(mine, out[:, :, t0:t0 + tl]),
                 "probs": max(_err(q, _my_columns(p, b, hh * ww, rank, world)) for p, q in zip(probs, mine_probs)),
                 "rows": [list(q.shape) for q in mine_probs]}

    # the teacher's capture, the rank loss and the score
    unet = _unet(cfg["unet"], z, "unet.").requires_grad_(False).eval()
    lat, ctx, uncond, noise = (torch.from_numpy(z[k]) for k in ("latents", "ctx", "uncond", "noise"))
    index = int(z["index"])
    sched = P.DiffusionSchedule.create()
    solver = P.DDIMSolver.create(sched.alphas_cumprod.numpy(), ddim_timesteps=cfg["n"])
    ts = solver.index_to_timestep(torch.tensor([index]))
    z_t = P.add_noise(sched, lat, noise, ts)
    z_ex = lat + 0.3 * noise  # a reference clip other than z_t
    hw = lat.shape[2] * lat.shape[3]
    with torch.no_grad():
        _, caps = unet(z_t, ts, ctx, record_probs=True)
        _, refs = unet(z_ex, ts, ctx, record_probs=True)
    one_loss = float(motion.motion_rank_loss(caps, refs))
    score, cond, loss = motion.motion_prior_score(unet, z_t, ts, z_ex, ctx, ctx, return_loss=True)
    unet.set_seq_group(group)
    f0, fl = rank * lat.shape[1] // world, lat.shape[1] // world
    frames = lambda x: x[:, f0:f0 + fl]  # noqa: E731
    with torch.no_grad():
        _, my_caps = unet(frames(z_t), ts, ctx, record_probs=True)
        _, my_refs = unet(frames(z_ex), ts, ctx, record_probs=True)
    term = motion.motion_rank_loss(my_caps, my_refs, group=group)
    my_score, my_cond, my_loss = motion.motion_prior_score(unet, frames(z_t), ts, frames(z_ex), ctx, ctx,
                                                           return_loss=True, group=group)
    rep["unet"] = {"layers": [len(caps), len(my_caps)],
                   "capture": max(_err(q, _my_columns(p, 1, hw, rank, world)) for p, q in zip(caps, my_caps)),
                   "rank loss": [float(C.all_reduce_(term.reshape(1).clone(), group)[0]), one_loss],
                   "score loss": [float(my_loss), float(loss)], "score": _err(my_score, frames(score)),
                   "score max": float(score.abs().max()), "cond": _err(my_cond, frames(cond))}

    # the preprocess over the mesh (the test holds rank 0's pickle to one process and to JAX)
    unet.set_seq_group(None)
    teacher = CountingTeacher(unet)
    sample = ppre.preprocess_sample(teacher, lat, ctx, uncond, ppre.PreprocessDraws(index, noise), sched=sched,
                                    solver=solver, cfg=ppre.PreprocessConfig(num_ddim_timesteps=cfg["n"]),
                                    txt="a cat", mesh=mesh)
    rep["preprocess"] = {"calls": teacher.calls, "returned": sample is not None}
    if sample is not None:
        ppre.save_sample(out_dir, "sharded", sample)
    return rep


def case_v2_loss(rank, world, out_dir):
    """`lcd_v2_loss` at (1, 2) on the test's batch and draws, with the EMA
    target and with none: the loss and every student gradient summed over
    the ranks (rank 0 saves them)."""
    from t2v_turbo_tpu_torch import diffusion as P
    from t2v_turbo_tpu_torch.parallel import collectives as C
    from t2v_turbo_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from t2v_turbo_tpu_torch.training import lcd_v2

    cfg, z = _read_inputs(out_dir)
    mesh = make_mesh(data=1, seq=2)
    student, target = _unet(cfg["unet"], z, "student."), _unet(cfg["unet"], z, "target.")
    for m in (student, target):
        m.set_seq_group(mesh.axis("seq"))
    batch = shard_batch(mesh, {k[len("batch."):]: torch.from_numpy(v) for k, v in z.items() if k.startswith("batch.")})
    sched = P.DiffusionSchedule.create()
    solver = P.DDIMSolver.create(sched.alphas_cumprod.numpy())
    names = [n for n, _ in student.named_parameters()]
    arrays, rep = {}, {}
    for name, tgt in (("ema", target), ("none", None)):
        loss, terms = lcd_v2.lcd_v2_loss(student, batch, lcd_v2.LCDV2Draws(torch.from_numpy(z["w"])), target=tgt,
                                         sched=sched, solver=solver, cfg=lcd_v2.LCDV2Config(**cfg["lcd"]),
                                         reward_fn=lambda pred, _: pred.mean(dim=(1, 2, 3, 4)), mesh=mesh)
        grads = torch.autograd.grad(loss, list(student.parameters()), allow_unused=True, materialize_grads=True)
        flat = C.all_reduce_(torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)]),
                             mesh.axis("world"))
        arrays[f"{name}/loss"] = flat[-1].numpy()
        offset = 0
        for n, g in zip(names, grads):
            arrays[f"{name}/{n}"] = flat[offset:offset + g.numel()].view(g.shape).numpy()
            offset += g.numel()
        rep[name] = sorted(terms)
    if rank == 0:
        np.savez(os.path.join(out_dir, "arrays_0.npz"), **arrays)
    return rep


def case_train(rank, world, out_dir):
    """Training on a world of 2 over gloo: the collectives' and the temporal
    layers' gradients, the v1 LoRA steps at (1, 2) and (2, 1), with a
    reward at (1, 2), with --fsdp at (2, 1), and there with two micro-steps
    an update, the v2 --fsdp steps at (2, 1) with the checkpoints
    crossing world sizes and at (1, 2), a LatentWebDataset step, and a
    SIGTERM to rank 1 in `run`; the validation render over the (1, 2)
    mesh."""
    import signal
    import tarfile

    import torch.distributed as dist

    from t2v_turbo_tpu_torch.data.webdata import LatentWebDataset
    from t2v_turbo_tpu_torch.parallel.mesh import make_mesh, shard_batch

    rep, arrays = {}, {}
    meshes = {(1, 2): make_mesh(data=1, seq=2), (2, 1): make_mesh(data=2, seq=1)}
    seq_group = meshes[(1, 2)].axis("seq")
    rep["vjp"] = _collective_vjps(rank, seq_group)
    rep["layers"] = _temporal_layer_grads(rank, seq_group)

    # v1 LoRA: two steps at each layout on the global batch's block
    states = v1_state_dicts()
    batch = {k: torch.from_numpy(v) for k, v in v1_batch().items()}
    for (data, seq), reward, fsdp, accum in (((1, 2), False, False, 1), ((2, 1), False, False, 1),
                                             ((1, 2), True, False, 1), ((2, 1), False, True, 1),
                                             ((2, 1), False, True, 2)):
        mesh = meshes[(data, seq)]
        trainer = v1_trainer(os.path.join(out_dir, f"v1_{data}x{seq}_{rank}"), mesh, reward, fsdp, states=states,
                             accum=accum)
        name = f"v1_{data}x{seq}" + ("_reward" if reward else "") + ("_fsdp" if fsdp else "") + \
            ("_accum" if accum > 1 else "")
        _save_steps(arrays, name, v1_steps(trainer, shard_batch(mesh, batch)))

    # v2 --fsdp at (2, 1): steps 1, 2, a save, step 3; a (2, 1) resume from
    # one process's step-2 checkpoint; rank 0 (one process) the references
    mesh = meshes[(2, 1)]
    vb = {k: torch.from_numpy(v) for k, v in v2_batch().items()}
    one_dir, fsdp_dir, back_dir = (os.path.join(out_dir, d) for d in ("v2_one", "v2_fsdp", "v2_fsdp_resumed"))
    if rank == 0:  # the uninterrupted one-process run, its checkpoint at step 2
        ref = v2_trainer(one_dir)
        recs = []
        for step in range(3):
            recs.append(v2_record(ref, ref.step_device(vb)))
            if step == 1:
                ref.save(2)
                resume_draws(ref, 2)
        _save_steps(arrays, "v2_one", recs, V2_KEYS)
        rep["v2 one slots"] = sum(p.numel() for opt in ref.optimizers.values() for p in opt.params)
    dist.barrier()
    tr = v2_trainer(fsdp_dir, mesh, fsdp=True)
    local = shard_batch(mesh, vb)
    recs = []
    for step in range(3):
        recs.append(v2_record(tr, tr.step_device(local)))
        if step == 1:
            tr.save(2)
            resume_draws(tr, 2)
    _save_steps(arrays, "v2_fsdp", recs, V2_KEYS)
    rep["v2 fsdp local"] = [tr.master.numel(), tr.ema.numel(), tr._shards.size, tr.whole_master().numel()]
    os.makedirs(os.path.join(back_dir, "checkpoints"), exist_ok=True)
    if rank == 0:
        import shutil

        shutil.copy(os.path.join(one_dir, "checkpoints", "step_00000002.pt"),
                    os.path.join(back_dir, "checkpoints", "step_00000002.pt"))
    dist.barrier()
    resumed = v2_trainer(back_dir, mesh, fsdp=True)
    rep["v2 resumed from one process at"] = resumed.resume_if_available()
    resume_draws(resumed, 2)
    _save_steps(arrays, "v2_fsdp_from_one", [v2_record(resumed, resumed.step_device(local))], V2_KEYS)
    if rank == 0:  # one process resuming the (2, 1) checkpoint
        one = v2_trainer(os.path.join(out_dir, "v2_fsdp"), None)
        rep["v2 one resumed from fsdp at"] = one.resume_if_available()
        resume_draws(one, 2)
        _save_steps(arrays, "v2_one_from_fsdp", [v2_record(one, one.step_device(vb))], V2_KEYS)
    dist.barrier()

    # v2 at (1, 2) with --fsdp (one data rank: nothing to shard): two steps on each rank's frames
    mesh12 = meshes[(1, 2)]
    tr = v2_trainer(os.path.join(out_dir, f"v2_1x2_{rank}"), mesh12, fsdp=True)
    local = shard_batch(mesh12, vb)
    _save_steps(arrays, "v2_1x2", [v2_record(tr, tr.step_device(local)) for _ in range(2)], V2_KEYS)
    rep["v2 1x2 sharded"] = tr._shards is not None

    # a LatentWebDataset step at (2, 1): each data rank reads its own shards
    import io
    import pickle

    shards = []
    if rank == 0:
        rng = np.random.RandomState(7)
        for s in range(2):
            path = os.path.join(out_dir, f"latents_{s}.tar")
            with tarfile.open(path, "w") as tf:
                for i in range(4):
                    d = {k: v[0] for k, v in v2_batch(b=1, seed=100 + 4 * s + i).items() if k != "tokens"}
                    d.update(index=int(rng.randint(0, 50)), use_motion_guide=True, txt=f"shard {s} clip {i}")
                    raw = pickle.dumps(d)
                    info = tarfile.TarInfo(f"{s:02d}{i:04d}.pkl")
                    info.size = len(raw)
                    tf.addfile(info, io.BytesIO(raw))
            shards.append(path)
    dist.barrier()
    shards = [os.path.join(out_dir, f"latents_{s}.tar") for s in range(2)]
    ds = LatentWebDataset(shards, num_train_examples=8, per_host_batch_size=1, global_batch_size=2, seed=3,
                          shuffle_buffer_size=1, mesh=mesh)
    rep["webdata shards"] = [os.path.basename(p) for p in ds.shards]
    wtr = v2_trainer(os.path.join(out_dir, f"v2_webdata_{rank}"), mesh, fsdp=True, text=False)
    host = next(iter(ds))
    rep["webdata txt"] = list(host.pop("txt"))
    host.pop("short_txt")
    metrics = wtr.step_once(host)
    rep["webdata step"] = [float(metrics["loss"]), float(metrics["grad_norm"])]

    # the validation render over the (1, 2) mesh: every rank renders, rank 0 writes
    from t2v_turbo_tpu_torch.apps import train_v1

    vargs = train_v1.parse_args(VALIDATION_ARGS + ["--output-dir", os.path.join(out_dir, "validation")])
    vtr, _, _ = train_v1.build_trainer(vargs, validation=True, mesh=meshes[(1, 2)])
    train_v1.build_validation_fn(vargs, vtr, max_prompts=1, step_counts=(2,), suffix=".npy")(1, vtr.student)
    dist.barrier()
    vdir = os.path.join(out_dir, "validation", "validation")
    rep["validation files"] = sorted(os.listdir(vdir))

    # SIGTERM to rank 1 during `run` at (2, 1): both ranks stop at one step
    sig = v1_trainer(os.path.join(out_dir, "sigterm"), mesh, states=states)

    def data():
        rows = {k: v.numpy() for k, v in shard_batch(mesh, batch).items()}
        for i in range(100):
            if rank == 1 and i == 6:
                os.kill(os.getpid(), signal.SIGTERM)
            yield rows

    sig.cfg.max_steps = 50
    last = sig.run(data())
    dist.barrier()  # rank 0 has written its checkpoint
    rep["sigterm"] = {"last_step": sig.step, "logged": last.get("step"),
                      "checkpoints": [s for s, _ in sig._checkpoints()]}
    np.savez(os.path.join(out_dir, f"arrays_{rank}.npz"), **arrays)
    return rep


def case_train4(rank, world, out_dir):
    """The v1 LoRA step at (2, 2) on the JAX case's weights, factors, batch
    and draws (tests/test_torch_sharded_training.py's `jax_case`); the v2
    --fsdp steps at (2, 2) with the checkpoints crossing world sizes."""
    from t2v_turbo_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from t2v_turbo_tpu_torch.training.lcd import LCDDraws

    import shutil

    import torch.distributed as dist

    z = np.load(os.path.join(out_dir, "inputs.npz"))
    states = v1_state_dicts()
    mesh = make_mesh(data=2, seq=2)
    trainer = v1_trainer(os.path.join(out_dir, f"run_{rank}"), mesh, states=states)
    batch = {k: torch.from_numpy(z[k]) for k in ("latents", "ctx", "uncond_ctx", "fps")}
    draws = LCDDraws(*(torch.from_numpy(z[k]) for k in ("index", "noise", "w"))).shard(mesh)
    arrays = {}
    _save_steps(arrays, "v1_2x2", v1_steps(trainer, shard_batch(mesh, batch), n=1, draws=draws))
    rep = {"coords": list(mesh.coords())}

    # v2 --fsdp at (2, 2): steps 1, 2, a save, step 3; a (2, 2) resume from one
    # process's step-2 checkpoint (rank 0 writes it); one process resuming the (2, 2) one
    vb = {k: torch.from_numpy(v) for k, v in v2_batch().items()}
    one_dir, dir22, back_dir = (os.path.join(out_dir, d) for d in ("v2_one", "v2_2x2", "v2_2x2_resumed"))
    if rank == 0:
        ref = v2_trainer(one_dir)
        for _ in range(2):
            ref.step_device(vb)
        ref.save(2)
        os.makedirs(os.path.join(back_dir, "checkpoints"))
        shutil.copy(os.path.join(one_dir, "checkpoints", "step_00000002.pt"), os.path.join(back_dir, "checkpoints"))
    tr = v2_trainer(dir22, mesh, fsdp=True)
    local = shard_batch(mesh, vb)
    recs = []
    for step in range(3):
        recs.append(v2_record(tr, tr.step_device(local)))
        if step == 1:
            tr.save(2)
            resume_draws(tr, 2)
    _save_steps(arrays, "v2_2x2", recs, V2_KEYS)
    rep["v2 2x2 local"] = [tr.master.numel(), tr._shards.size, tr.whole_master().numel()]
    dist.barrier()  # rank 0's one-process checkpoint is written
    resumed = v2_trainer(back_dir, mesh, fsdp=True)
    rep["v2 2x2 resumed from one process at"] = resumed.resume_if_available()
    resume_draws(resumed, 2)
    _save_steps(arrays, "v2_2x2_from_one", [v2_record(resumed, resumed.step_device(local))], V2_KEYS)
    if rank == 0:
        one = v2_trainer(dir22, None)
        rep["v2 one resumed from 2x2 at"] = one.resume_if_available()
        resume_draws(one, 2)
        _save_steps(arrays, "v2_one_from_2x2", [v2_record(one, one.step_device(vb))], V2_KEYS)
    np.savez(os.path.join(out_dir, f"arrays_{rank}.npz"), **arrays)
    return rep


def case_train_cli(rank, world, out_dir, *argv):
    """apps/train_v1.py (or train_v2.py, argv[0] == "v2") under torchrun."""
    from t2v_turbo_tpu_torch.apps import train_v1, train_v2

    if argv and argv[0] == "v2":
        try:
            train_v2.main(list(argv[1:]))
        except SystemExit as e:
            return {"refused": str(e)}
        return {"ran": True}
    try:
        train_v1.main(list(argv))
    except SystemExit as e:
        return {"refused": str(e)}
    return {"ran": True}


CASES = {"ops": case_ops, "sampling": case_sampling, "serve": case_serve, "generate": case_generate,
         "train": case_train, "train4": case_train4, "train_cli": case_train_cli, "v2_capture": case_v2_capture,
         "v2_loss": case_v2_loss}
TRAINING = ("train", "train4", "train_cli", "v2_capture", "v2_loss")  # cases that take gradients


def _wait_for_reports(out_dir, world, timeout: float = TIMEOUT_S):
    import time

    deadline = time.time() + timeout
    while time.time() < deadline and not all(os.path.exists(os.path.join(out_dir, f"report_{r}.json"))
                                             for r in range(1, world)):
        time.sleep(0.05)


def main(argv):
    torch.set_num_threads(1)
    from t2v_turbo_tpu_torch.parallel import multihost

    extra = []
    if "RANK" in os.environ:  # under torchrun
        case, out_dir, *extra = argv
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        case, rank, world, port, out_dir, *extra = argv
        rank, world = int(rank), int(world)
        if case == "serve":  # the CLI joins the world from torchrun's variables
            os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, RANK=str(rank), WORLD_SIZE=str(world),
                              LOCAL_RANK=str(rank))
        else:
            multihost.initialize(f"localhost:{port}", world, rank, device_type="cpu", timeout_s=TIMEOUT_S)
    with torch.set_grad_enabled(case in TRAINING):
        rep = CASES[case](rank, world, out_dir, *extra)
    with open(os.path.join(out_dir, f"report_{rank}.json"), "w") as f:
        json.dump(rep, f)
    import torch.distributed as dist

    if dist.is_initialized():  # rank 0 hosts the store: no rank tears down while another still works
        dist.barrier()
    elif rank == 0:  # serve's ranks have left the world in the case: wait for the others' reports, which they
        _wait_for_reports(out_dir, world)  # write once their shutdown no longer needs rank 0's store
    multihost.shutdown()
    print(f"RANK_{rank}_OK", flush=True)


if __name__ == "__main__":
    sys.path[:0] = [ROOT, HERE]
    main(sys.argv[1:])
