"""apps/warmup.py --export and pipelines/artifact.py of the port, on the CPU.

One tiny export a backbone (VC2 and ModelScope: warmup's --tiny-model
configs, f32, 2 steps, 4 frames at 16x16, decoded 2 frames a program
call), shared by the module:

- the manifest: JAX's operating-point keys (t2v_turbo_tpu/apps/warmup.py's
  build_programs at the same flags), a grid of the live scheduler's scalars,
  each program's artifact, bytes and export_s;
- the kernels are in the graphs: the three programs together call every
  serving operator (`t2v_turbo::flash_attention`, `small_seq_attention`,
  `group_norm`, `layer_norm`, `fused_gn_silu_conv`). On the card the
  same operators launch the hand-written kernels; chip_smoke counts them;
- artifact vs live: `ArtifactPipeline.from_dir`, in a subprocess where
  jax, the JAX package and the port's models/ and diffusion/ cannot be
  imported, turns a prompt into the same video as the live pipeline built
  from the same seeded modules, to the bit, for the same seed;
- off-point requests are refused with the JAX artifact pipeline's message.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu_torch.apps import warmup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--tiny-model", "--f32", "--steps", "2", "--frames", "4", "--height", "16", "--width", "16",
        "--decode-chunk", "2", "--device", "cpu"]
SERVING_OPS = {"flash_attention", "small_seq_attention", "group_norm", "layer_norm", "fused_gn_silu_conv"}
CALL = dict(prompt="a cat", height=16, width=16, frames=4, num_inference_steps=2)


class Tok:
    """A stand-in tokenizer for the tiny text tower (8 ids below 50)."""

    def __call__(self, prompt):
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        return np.array([[(ord(c) % 49) + 1 for c in (p + " " * 8)[:8]] for p in prompts], np.int32)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """{backbone: (export dir, manifest, live pipeline with seeded weights, state-dict file)}."""
    out = {}
    for backbone in ("vc2", "ms"):
        d = tmp_path_factory.mktemp(f"pt2_{backbone}")
        argv = ARGV + ["--backbone", backbone]
        manifest = warmup.main(argv + ["--export", str(d)])
        pipe, _ = warmup.build_pipeline(warmup.parse_args(argv), device="cpu", seed=0)
        pipe.tokenizer = Tok()
        weights = d / "weights.pt"
        torch.save({n: getattr(pipe, m).state_dict() for n, m in (("unet", "unet"), ("vae", "vae"),
                                                                   ("text", "text_model"))}, str(weights))
        out[backbone] = (str(d), manifest, pipe, str(weights))
    return out


@pytest.mark.parametrize("backbone", ["vc2", "ms"])
def test_manifest(exports, backbone):
    from t2v_turbo_tpu.apps import warmup as jwarmup

    d, manifest, pipe, _ = exports[backbone]
    on_disk = json.loads(open(os.path.join(d, "manifest.json")).read())
    assert on_disk == json.loads(json.dumps(manifest))
    _, jop = jwarmup.build_programs(jwarmup.parse_args(
        ["--tiny-model", "--f32", "--steps", "2", "--frames", "4", "--height", "16", "--width", "16",
         "--decode-chunk", "2", "--backbone", backbone]))
    op = manifest["operating_point"]
    assert set(op) == set(jop)
    for k in ("steps", "lcm_origin_steps", "batch", "frames", "height", "width", "decode_chunk", "dtype",
              "backbone", "vae_scale", "z_channels", "in_channels", "w_embedding_dim", "init_noise_sigma"):
        assert op[k] == jop[k], k
    assert [g["t"] for g in manifest["grid"]] == [999, 499]
    for g, (t, pt) in zip(manifest["grid"], ((999, 499), (499, 499))):
        want = pipe.scheduler.step_scalars(t, pt)
        assert [g[k] for k in want._fields] == [float(v) for v in want]
    for name in ("lcm_step", "vae_decode", "text_encode"):
        entry = manifest["programs"][name]
        assert entry["artifact"] == f"{name}.pt2" and entry["bytes"] == os.path.getsize(os.path.join(d, entry["artifact"]))
        assert entry["export_s"] > 0
        assert set(manifest["weights"][name]) == set(getattr(pipe, {"lcm_step": "unet", "vae_decode": "vae",
                                                                    "text_encode": "text_model"}[name]).state_dict())


@pytest.mark.parametrize("backbone", ["vc2", "ms"])
def test_graphs_call_every_serving_operator(exports, backbone):
    d = exports[backbone][0]
    called = set()
    for name in ("lcm_step", "vae_decode", "text_encode"):
        ep = torch.export.load(os.path.join(d, f"{name}.pt2"))
        assert not ep.state_dict and not ep.constants  # the weights are inputs, not in the file
        called |= {str(n.target).split(".")[1] for n in ep.graph.nodes
                   if n.op == "call_function" and str(n.target).startswith("t2v_turbo.")}
    assert called == SERVING_OPS


_CHILD = textwrap.dedent(
    """
    import sys
    for blocked in ("jax", "flax", "t2v_turbo_tpu", "t2v_turbo_tpu_torch.models", "t2v_turbo_tpu_torch.diffusion"):
        sys.modules[blocked] = None
    import numpy as np, torch
    torch.set_num_threads(1)
    from t2v_turbo_tpu_torch.pipelines.artifact import ArtifactPipeline

    class Tok:
        def __call__(self, prompt):
            prompts = [prompt] if isinstance(prompt, str) else list(prompt)
            return np.array([[(ord(c) % 49) + 1 for c in (p + " " * 8)[:8]] for p in prompts], np.int32)

    out = {}
    result, rest = sys.argv[1], sys.argv[2:]
    for d, weights, seed in zip(rest[0::3], rest[1::3], rest[2::3]):
        sd = torch.load(weights)
        art = ArtifactPipeline.from_dir(d, unet_sd=sd["unet"], vae_sd=sd["vae"], text_sd=sd["text"],
                                        tokenizer=Tok(), device="cpu")
        video = art(prompt="a cat", height=16, width=16, frames=4, num_inference_steps=2,
                    generator=torch.Generator().manual_seed(int(seed)))
        errors = []
        for kw in (dict(frames=8), dict(num_inference_steps=4), dict(decode_frame_chunk=4)):
            try:
                art(**{**dict(prompt="a cat", height=16, width=16, frames=4, num_inference_steps=2), **kw})
            except ValueError as e:
                errors.append(str(e))
        out[d] = (video, errors)
    loaded = [m for m in sys.modules if m.startswith(("t2v_turbo_tpu_torch.models", "t2v_turbo_tpu_torch.diffusion"))
              and sys.modules[m] is not None]
    torch.save({"out": out, "loaded": loaded}, result)
    """
)


def test_artifact_equals_live_without_model_code(exports, tmp_path):
    from t2v_turbo_tpu.pipelines.artifact import ArtifactPipeline as JArtifactPipeline

    args = []
    for i, backbone in enumerate(("vc2", "ms")):
        d, _, _, weights = exports[backbone]
        args += [d, weights, str(7 + i)]
    result = tmp_path / "result.pt"
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(result), *args], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    got = torch.load(str(result))
    assert got["loaded"] == []
    for i, backbone in enumerate(("vc2", "ms")):
        d, _, pipe, _ = exports[backbone]
        video, errors = got["out"][d]
        live = pipe(generator=torch.Generator().manual_seed(7 + i), decode_frame_chunk=2, **CALL)
        assert video.shape == (1, 4, 16, 16, 3)
        assert torch.equal(video, live), float((video - live).abs().max())
        assert len(errors) == 3
        for msg, (name, got_v, want_v) in zip(errors, (("frames", 8, 4), ("steps", 4, 2),
                                                       ("decode_frame_chunk", 4, 2))):
            with pytest.raises(ValueError) as jerr:
                JArtifactPipeline._check(None, name, got_v, want_v)
            assert msg.split(". Re-export")[0] == str(jerr.value).split(". Re-export")[0]


def test_warmup_without_export_prints_the_summary(capsys):
    manifest = warmup.main(ARGV)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["cache_dir"] is None and line["programs"] == {} and manifest["device"] == "cpu"
    assert line["torch_version"] == torch.__version__


def test_serve_from_artifacts_with_random_weights(exports, tmp_path):
    """serve --artifacts DIR --random-weights: generate --random-weights
    --seed 0's modules at the artifacts' configs, bound to the programs."""
    from t2v_turbo_tpu_torch.apps import serve

    d, _, pipe, _ = exports["vc2"]
    server, art, _ = serve.build_server(["--artifacts", d, "--random-weights", "--device", "cpu", "--port", "0",
                                         "--output-dir", str(tmp_path)])
    server.server_close()
    for name, module in (("lcm_step", pipe.unet), ("vae_decode", pipe.vae), ("text_encode", pipe.text_model)):
        sd = module.state_dict()
        assert set(art.weights[name]) == set(sd) and all(torch.equal(art.weights[name][k], v) for k, v in sd.items())
    assert art.operating_points == {(4, 16, 16, 2, 50)}
    assert art.tokenizer("a cat").shape == (1, 8)
