"""The port's parallel/ package on the CPU: the mesh, multi-process start-up,
the collectives of sequence-parallel sampling, and the sharded CLIs.

Rank processes are spawned with `subprocess` (tests/torch_dist_worker.py,
which never imports JAX) over gloo on the CPU:
- 2 ranks (case "ops"): `make_mesh` and its errors (JAX's messages),
  `host_local_batch_to_global` (tests/test_multihost.py's check: each rank's
  rows stay its own; a mean over the data group sees both), `shard_batch`;
  B4's partials -> gather_partials -> apply chain and the (a, b) fold
  against `group_norm_plain` / `gn_affine_vectors` over the whole clip, with
  chunks of 7 so each rank's short last chunk sits mid-row once gathered;
  `seq_to_space` and its round trip; `halo_exchange`; the halo conv, a
  TemporalConvBlock and a TemporalTransformer on 3 of 6 frames against the
  whole clip's. Tolerance 1e-5 (f32; only the order of the sums differs).
- 2 ranks under torchrun: `generate --seq-shards 2`; rank 0 alone writes,
  its video against the single-process CLI's within one uint8 level.
- 2 ranks: `serve --seq-shards 2`, rank 0 answering a POST while rank 1
  follows; the served video against the single-process pipeline's.
In process: the CLIs' refusals (--model-shards names A12b, shards without
torchrun, a world of another size, artifacts with shards, a missing CUDA
device), the frame split, and the CUDA entries refusing CPU tensors (and
taking gradients through their autograd functions).
"""

import os

import numpy as np
import pytest
import torch

import torch_dist_worker as W
import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu_torch.apps import generate, serve
from t2v_turbo_tpu_torch.ops import fused_conv as FC
from t2v_turbo_tpu_torch.ops import norms as N
from t2v_turbo_tpu_torch.pipelines.vc2 import frame_split, video_to_uint8

TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three multi-process runs, started together; then the
    single-process references of the CLI runs."""
    dirs = {k: tmp_path_factory.mktemp(k) for k in ("ops", "generate", "serve")}
    procs = {"ops": W.start_ranks("ops", 2, dirs["ops"]),
             "generate": W.start_torchrun("generate", 2, dirs["generate"]),
             "serve": W.start_ranks("serve", 2, dirs["serve"])}
    single = os.path.join(dirs["generate"], "single.npy")
    generate.main(W.CLI_ARGS + ["--prompt", "a cat", "--output", single], W.cli_spec())
    args = serve.parse_args(W.CLI_ARGS[:3])
    args.seed = 0
    pipe = generate.build_pipeline(args, W.cli_spec())
    with torch.no_grad():
        served_ref = pipe(prompt="a cat", frames=4, height=16, width=16, num_inference_steps=2,
                          generator=torch.Generator().manual_seed(7))
    out = {"dirs": dirs, "single": np.load(single), "served_ref": video_to_uint8(served_ref)[0]}
    for name, ps in procs.items():
        codes, outs = W.finish(ps)
        assert codes == [0] * len(ps), f"{name} ranks failed:\n" + "\n".join(outs)
        out[name] = outs
    return out


@pytest.fixture(scope="module")
def ops(runs):
    return [W.read_report(runs["dirs"]["ops"], r) for r in range(2)]


@pytest.mark.parametrize("label, text", [("not divisible", "divisible"), ("mismatch", "does not match"),
                                         ("model", "A12b")])
def test_make_mesh_errors(ops, label, text):
    for rep in ops:
        assert text in rep[f"mesh error {label}"]


def test_make_mesh_coordinates(ops):
    for rank, rep in enumerate(ops):
        assert rep["seq mesh"] == [1, 2, 1, [0, rank, 0], [0, 1], rank]
        assert rep["data mesh"] == [2, 1, [rank, 0, 0], [0, 1]]


def test_host_local_batch_to_global(ops):
    for rank, rep in enumerate(ops):
        keys, shape, mean = rep["batch data"]
        assert keys == ["fps", "latents"] and shape == [2, 4, 8, 8, 4]  # "_text" dropped, rows kept local
        assert mean == pytest.approx(0.5)  # the data group sees both ranks' rows
        assert rep["batch seq frames"] == [6.0 * rank, 6.0 * rank + 3.0]  # frames 2r, 2r + 1 of 4


def test_shard_batch(ops):
    for rank, rep in enumerate(ops):
        assert rep["shard_batch"] == [[1, 2, 2, 2, 1], 8.0 * rank, [1], 3.0]


def test_partials_chain_with_uneven_chunks(ops):
    for rep in ops:
        assert rep["partial counts"] == [7] * 10 + [2]
        assert rep["gathered counts"] == ([7] * 10 + [2]) * 2  # rank 0's short chunk mid-row
        assert rep["partials chain max_err"] <= TOL
        assert rep["affine from partials max_err"] <= TOL
        assert rep["affine from partials film max_err"] <= TOL
        assert rep["clip partials rows"] == [64, 2, 2]  # 2 x 32 rows, one chunk a rank, gathered


def test_seq_to_space_round_trip(ops):
    for rep in ops:
        assert rep["seq_to_space max_err"] == 0.0 and rep["round trip max_err"] == 0.0
        assert "do not split over 2 seq ranks" in rep["seq_to_space 15 columns"]


def test_halo_exchange(ops):
    assert ops[0]["halo"] == [0, 1, 0.0] and ops[1]["halo"] == [1, 0, 0.0]  # no frame past the clip's edges


@pytest.mark.parametrize("what", ["halo conv", "TemporalConvBlock", "TemporalTransformer"])
def test_temporal_layers_over_seq(ops, what):
    for rep in ops:
        assert rep[f"{what} max_err"] <= TOL


def test_collective_calls(ops):
    calls = ops[0]["collective calls"]
    # a halo exchange and a partials gather each conv stage (the single stage
    # and the block's four), the halo check's exchange, the partials chain's,
    # the transformer's and clip_partials' gathers; one all-to-all each way
    assert calls["halo_exchange"] == 6 and calls["gather_partials"] == 8
    assert calls["seq_to_space"] == 2 and calls["space_to_seq"] == 2


def test_sharded_generate_under_torchrun(runs):
    sharded = os.path.join(runs["dirs"]["generate"], "sharded.npy")
    assert os.path.exists(sharded), runs["generate"]
    got = np.load(sharded)
    assert got.shape == runs["single"].shape == (4, 16, 16, 3)
    assert np.abs(got.astype(int) - runs["single"].astype(int)).max() <= 1  # f32 sums in another order


def test_sharded_serve(runs):
    rep0, rep1 = (W.read_report(runs["dirs"]["serve"], r) for r in range(2))
    assert rep1 == {"followed": True} and rep0["relay closed"]
    answer = rep0["answer"]
    assert answer["shape"] == [4, 16, 16, 3] and answer["path"].endswith(".npy")
    got = np.load(answer["path"])
    assert np.abs(got.astype(int) - runs["served_ref"].astype(int)).max() <= 1


def test_cli_refusals(monkeypatch, tmp_path):
    with pytest.raises(SystemExit, match="A12b"):
        generate.make_cli_mesh(generate.parse_args(["--prompt", "x", "--model-shards", "2"]))
    with pytest.raises(SystemExit, match="torchrun"):
        generate.make_cli_mesh(generate.parse_args(["--prompt", "x", "--seq-shards", "2", "--device", "cpu"]))
    with pytest.raises(SystemExit, match="one rank"):
        serve.build_server(["--artifacts", str(tmp_path), "--random-weights", "--data-shards", "2"])
    with pytest.raises(SystemExit, match="A12b"):
        serve.build_server(["--random-weights", "--model-shards", "2", "--device", "cpu"])
    assert generate.make_cli_mesh(generate.parse_args(["--prompt", "x"])) is None
    if not torch.cuda.is_available():  # a rank whose card is missing raises
        for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT="1", RANK="0", WORLD_SIZE="2", LOCAL_RANK="0").items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate.make_cli_mesh(generate.parse_args(["--prompt", "x", "--seq-shards", "2"]))


def test_world_of_another_size_is_refused():
    import torch.distributed as dist

    from t2v_turbo_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{W.free_port()}", 1, 0, device_type="cpu", timeout_s=60)
    try:
        with pytest.raises(SystemExit, match="need exactly 2 ranks, the world has 1"):
            generate.make_cli_mesh(generate.parse_args(["--prompt", "x", "--seq-shards", "2", "--device", "cpu"]))
        with pytest.raises(RuntimeError, match="already initialised"):
            multihost.initialize(f"localhost:{W.free_port()}", 1, 0, device_type="cpu")
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()


def test_initialize_refuses_ranks_past_the_cards(monkeypatch):
    from t2v_turbo_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="share_device=True"):
        multihost.initialize("localhost:1", 2, 1, device_type="cuda")
    with pytest.raises(ValueError, match="NCCL refuses"):
        multihost.initialize("localhost:1", 2, 1, device_type="cuda", share_device=True)


def test_frame_split():
    assert frame_split(32, 4) == [8, 8, 8, 8]
    assert frame_split(18, 4) == [5, 5, 4, 4]  # uneven: the first ranks one more
    assert sum(frame_split(49, 8)) == 49


def test_partials_plain_over_halves_equal_the_whole():
    """The plain chain in one process: the partials of the two halves of a
    clip (chunks of 5), concatenated, give the whole clip's norm."""
    g = torch.Generator().manual_seed(0)
    clip = 2.0 * torch.randn(2, 64, 4, 3, 4, generator=g) + 0.5
    w, b = 1.0 + 0.1 * torch.randn(64, generator=g), 0.1 * torch.randn(64, generator=g)
    halves = [N.group_norm_partials_plain(clip[:, :, i:i + 2].contiguous(), 32, chunk=5) for i in (0, 2)]
    parts = torch.cat([p for p, _ in halves], 1)
    counts = torch.cat([c for _, c in halves])
    assert counts.tolist() == [5] * 9 + [3] + [5] * 9 + [3]
    y = N.group_norm_from_partials(clip[:, :, :2].contiguous(), parts, counts, w, b, 32, 1e-6)
    torch.testing.assert_close(y, N.group_norm_plain(clip, w, b, 32, 1e-6)[:, :, :2], atol=TOL, rtol=0)
    a, sh = N.group_norm_affine_from_partials(parts, counts, w, b, 32, 1e-6)
    ra, rb = FC.gn_affine_vectors(clip, w, b, 32, 1e-6)
    torch.testing.assert_close(a, ra, atol=TOL, rtol=0)
    torch.testing.assert_close(sh, rb, atol=TOL, rtol=0)
    # B7 on given (a, b) equals B7 with its own statistics on the whole clip
    conv = (torch.randn(8, 64, 3, 1, generator=g) / 8.0, 0.1 * torch.randn(8, generator=g))
    x4 = clip.reshape(2, 64, 4, 12)
    torch.testing.assert_close(FC.fused_gn_silu_conv_ab(x4, a, sh, *conv),
                               FC.fused_gn_silu_conv_plain(x4, w, b, *conv, 32, 1e-6), atol=TOL, rtol=0)


def test_entries_refuse_cpu_tensors_and_gradients():
    x = torch.randn(1, 32, 2, 8)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        N.group_norm_partials_cuda(x, 32)
    parts, counts = N.group_norm_partials(x, 32)
    w, b = torch.ones(32), torch.zeros(32)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        N.group_norm_from_partials_cuda(x, parts, counts, w, b, 32)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        N.group_norm_affine_from_partials_cuda(parts, counts, w, b, 32)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        FC.fused_gn_silu_conv_ab_cuda(x, torch.ones(1, 32), torch.zeros(1, 32), torch.randn(4, 32, 3, 1))
    # gradients are no longer refused: the entries take them through their autograd functions
    # (tests/test_torch_sharded_training.py holds the backward to the plain twins)
    parts, counts = N.group_norm_partials(x.requires_grad_(), 32)
    assert parts.grad_fn is not None and not counts.requires_grad
    y = FC.fused_gn_silu_conv_ab(x, torch.ones(1, 32), torch.zeros(1, 32), torch.randn(4, 32, 3, 1))
    assert y.grad_fn is not None
