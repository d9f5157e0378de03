"""Rank processes for the port's torch.distributed CPU tests
(tests/test_torch_parallel.py, tests/test_torch_seq_parallel.py).

The tests start every rank as its own process with `subprocess` (never by
forking a process that imported JAX): this module imports torch, numpy and
the port only. Each case runs on the CPU over gloo and writes what it
measured to OUT_DIR (report_<rank>.json: {check: value}; arrays in
<name>_<rank>.npz), for the test to assert on.

    python tests/torch_dist_worker.py CASE RANK WORLD PORT OUT_DIR

Under torchrun (`start_torchrun`) the rank, world and address come from its
environment and CASE and OUT_DIR are the only arguments.
"""

from __future__ import annotations

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


def start_ranks(case: str, world: int, out_dir):
    """Start `case` on `world` rank processes (`finish` waits for them)."""
    port = free_port()
    return [_popen([sys.executable, __file__, case, str(r), str(world), str(port), str(out_dir)])
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

    rep = {}
    # the mesh and its errors (JAX's messages)
    for label, kw, exc in (("not divisible", dict(seq=3), ValueError), ("mismatch", dict(data=1, seq=1), ValueError),
                           ("model", dict(seq=1, model=2), NotImplementedError)):
        try:
            make_mesh(**kw)
            rep[f"mesh error {label}"] = "none"
        except exc as e:
            rep[f"mesh error {label}"] = str(e)
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


def case_sampling(rank, world, out_dir):
    """The tiny UNet and pipeline over every (data, seq) mesh this world
    takes, each rank's UNet output and rank 0's video saved."""
    from t2v_turbo_tpu_torch.parallel.mesh import make_mesh, shard

    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    lat, noise, ctx = (torch.from_numpy(inputs[k]) for k in ("lat", "noise", "ctx"))
    meshes = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}[world]
    rep, arrays = {}, {}
    for data, seq in meshes:
        mesh = make_mesh(data=data, seq=seq)
        pipe = tiny_pipeline(mesh)
        name = f"{data}x{seq}"
        t = torch.full((lat.shape[0],), 500, dtype=torch.long)
        w_emb = torch.from_numpy(inputs["w_emb"])
        with torch.no_grad():
            out = pipe.unet(shard(mesh, lat, ("data", "seq")), shard(mesh, t, ("data",)),
                            shard(mesh, ctx, ("data",)), fps=shard(mesh, torch.full((lat.shape[0],), 16.0), ("data",)),
                            timestep_cond=shard(mesh, w_emb, ("data",)))
        arrays[f"unet_{name}"] = out.numpy()
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


def case_serve(rank, world, out_dir):
    """apps/serve.py on 2 ranks: rank 0 answers one POST (to itself), the
    other rank follows; then the shutdown."""
    import threading
    import urllib.request

    from t2v_turbo_tpu_torch.apps import serve

    serve.HEARTBEAT_S = 0.2  # several heartbeats while rank 0 idles below
    argv = CLI_ARGS[:3] + ["--port", "0", "--output-dir", os.path.join(out_dir, "served"), "--seq-shards", "2"]
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


def case_generate(rank, world, out_dir):
    """apps/generate.py under torchrun at --seq-shards 2."""
    from t2v_turbo_tpu_torch.apps import generate

    generate.main(CLI_ARGS + ["--prompt", "a cat", "--seq-shards", "2", "--output",
                              os.path.join(out_dir, "sharded.npy")], cli_spec())
    return {"rank": rank}


CASES = {"ops": case_ops, "sampling": case_sampling, "serve": case_serve, "generate": case_generate}


def main(argv):
    torch.set_num_threads(1)
    from t2v_turbo_tpu_torch.parallel import multihost

    if "RANK" in os.environ:  # under torchrun
        case, out_dir = argv
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        case, rank, world, port, out_dir = argv
        rank, world = int(rank), int(world)
        if case == "serve":  # the CLI joins the world from torchrun's variables
            os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, RANK=str(rank), WORLD_SIZE=str(world),
                              LOCAL_RANK=str(rank))
        else:
            multihost.initialize(f"localhost:{port}", world, rank, device_type="cpu", timeout_s=TIMEOUT_S)
    with torch.no_grad():
        rep = CASES[case](rank, world, out_dir)
    with open(os.path.join(out_dir, f"report_{rank}.json"), "w") as f:
        json.dump(rep, f)
    multihost.shutdown()
    print(f"RANK_{rank}_OK", flush=True)


if __name__ == "__main__":
    sys.path[:0] = [ROOT, HERE]
    main(sys.argv[1:])
