"""The port's norm and attention ops (t2v_turbo_tpu_torch/ops) against the JAX
package's, on the CPU.

Here the kernel wrappers run their plain PyTorch versions (the tensors lie
on the CPU); the CUDA kernels themselves are held against those plain
versions on the card by chip_smoke.py. The JAX side runs its XLA reference
math and its Pallas kernels in interpret mode.

Tolerances (f32): 1e-5 absolute for norms and attention, whose only
difference from JAX is the order of f32 sums.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu.ops import attention as jattn
from t2v_turbo_tpu.ops import fused_norms as jfused
from t2v_turbo_tpu.ops import norms as jnorms
from t2v_turbo_tpu_torch.ops import attention as A
from t2v_turbo_tpu_torch.ops import cuda_lib
from t2v_turbo_tpu_torch.ops import fused_conv as FC
from t2v_turbo_tpu_torch.ops import norms as N

ATOL = 1e-5


def _norm_inputs(shape, c, seed):
    rng = np.random.RandomState(seed)
    x = (3.0 * rng.randn(*shape) + 1.0).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    return x, w, b


def _cl(x):
    """channels-first (N, C, *S) -> channels-last (N, *S, C), as JAX lays it out."""
    return np.moveaxis(x, 1, -1)


class TestGroupNorm:
    @pytest.mark.parametrize(
        "shape,eps,act",
        [
            ((2, 64, 5, 7), 1e-5, "silu"),  # per-frame ResBlock GN
            ((2, 32, 4, 6), 1e-6, None),  # transformer GN
            ((1, 64, 4, 3, 5), 1e-5, "silu"),  # whole clip (B, C, T, H, W)
        ],
    )
    def test_matches_jax_group_norm(self, shape, eps, act):
        x, w, b = _norm_inputs(shape, shape[1], 0)
        ref = np.asarray(jnorms.group_norm(jnp.asarray(_cl(x)), w, b, 32, eps, act))
        got = N.group_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 32, eps, act)
        np.testing.assert_allclose(_cl(got.numpy()), ref, atol=ATOL)

    def test_whole_clip_statistics_span_frames(self):
        """(B, C, T, H, W) pools T into the statistics; folding T into N
        (per-frame statistics) gives another answer."""
        x, w, b = _norm_inputs((1, 32, 4, 3, 3), 32, 1)
        x[:, :, 0] += 5.0  # one frame off the others
        xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
        clip = N.group_norm(xt, wt, bt, 32)
        frames = N.group_norm(xt.transpose(1, 2).reshape(4, 32, 3, 3), wt, bt, 32)
        frames = frames.reshape(1, 4, 32, 3, 3).transpose(1, 2)
        ref = np.asarray(jnorms.group_norm(jnp.asarray(_cl(x)), w, b, 32))
        np.testing.assert_allclose(_cl(clip.numpy()), ref, atol=ATOL)
        assert float((clip - frames).abs().max()) > 0.1

    def test_matches_pallas_kernel_interpret(self):
        """Against the Pallas kernel itself, interpret mode, (N, HW, C)."""
        x, w, b = _norm_inputs((2, 64, 4, 8), 64, 2)
        xl = _cl(x).reshape(2, 32, 64)
        ref = np.asarray(jfused.fused_group_norm(jnp.asarray(xl), w, b, 32, 1e-5, "silu", interpret=True))
        got = N.fused_group_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 32, 1e-5, "silu")
        np.testing.assert_allclose(_cl(got.numpy()).reshape(2, 32, 64), ref, atol=ATOL)


class TestLayerNorm:
    @pytest.mark.parametrize("shape,act", [((3, 5, 48), None), ((7, 96), "silu")])
    def test_matches_jax_layer_norm(self, shape, act):
        x, w, b = _norm_inputs(shape, shape[-1], 3)
        ref = np.asarray(jnorms.layer_norm(jnp.asarray(x), w, b, 1e-5, act))
        got = N.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-5, act)
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)

    def test_matches_pallas_kernel_interpret(self):
        x, w, b = _norm_inputs((300, 64), 64, 4)  # ragged against the kernel's 256-row blocks
        ref = np.asarray(jfused.fused_layer_norm(jnp.asarray(x), w, b, interpret=True))
        got = N.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for s in (sq, sk, sk)]


def _bhsd(t):
    return jnp.asarray(np.swapaxes(t, 1, 2))


class TestAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_attention_xla(self, causal):
        q, k, v = _qkv(2, 7, 7, 3, 8, 0)
        bias = np.random.RandomState(1).randn(1, 3, 7, 7).astype(np.float32)
        ref, ref_p = jattn.attention_xla(
            _bhsd(q), _bhsd(k), _bhsd(v), bias=jnp.asarray(bias), causal=causal, return_probs=True
        )
        got, got_p = A.attention(
            *(torch.from_numpy(t) for t in (q, k, v)), bias=torch.from_numpy(bias), causal=causal,
            return_probs=True,
        )
        np.testing.assert_allclose(got.numpy(), np.swapaxes(np.asarray(ref), 1, 2), atol=ATOL)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), atol=ATOL)

    def test_matches_attention_xla_bshd_cross(self):
        q, k, v = _qkv(2, 9, 5, 2, 16, 2)
        ref = jattn.attention_xla_bshd(*(jnp.asarray(t) for t in (q, k, v)), scale=0.3)
        got = A.attention(*(torch.from_numpy(t) for t in (q, k, v)), scale=0.3)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    @pytest.mark.parametrize(
        "b,s,h,d",
        [(1, 200, 2, 64), (1, 150, 1, 512)],  # ragged S (not a multiple of 128), VAE head width
    )
    def test_flash_wrapper_matches_pallas_interpret(self, b, s, h, d):
        q, k, v = _qkv(b, s, s, h, d, 3)
        ref = jattn.flash_attention(_bhsd(q), _bhsd(k), _bhsd(v))  # interpret mode off-TPU
        got = A.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)))
        np.testing.assert_allclose(got.numpy(), np.swapaxes(np.asarray(ref), 1, 2), atol=ATOL)

    @pytest.mark.parametrize("sq,sk,d", [(1024, 1024, 64), (40, 77, 64), (16, 16, 512), (9, 9, 32)])
    def test_sdpa_matches_sdpa_bshd(self, sq, sk, d):
        """Whichever route sdpa takes (flash for head dims 64 and 512, the
        plain math otherwise; both plain on the CPU) it agrees with JAX's
        sdpa_bshd, which takes flash at S >= 1024 in interpret mode."""
        q, k, v = _qkv(1, sq, sk, 2, d, 4)
        qt, kt, vt = (torch.from_numpy(t) for t in (q, k, v))
        ref = jattn.sdpa_bshd(*(jnp.asarray(t) for t in (q, k, v)))
        np.testing.assert_allclose(A.sdpa(qt, kt, vt).numpy(), np.asarray(ref), atol=ATOL)

    @pytest.mark.parametrize("d,route", [(64, "flash"), (512, "flash"), (32, "plain"), (80, "plain")])
    def test_sdpa_routes_by_head_dim(self, monkeypatch, d, route):
        """Above the short-sequence gate (S = 65; tests/test_torch_small_seq.py
        covers the gate) sdpa sends head dims 64 and 512 to flash_attention
        and every other head dim to the plain math."""
        taken = []

        def flash(q, k, v, scale=None):
            taken.append("flash")
            return A.attention(q, k, v, scale=scale)

        monkeypatch.setattr(A, "flash_attention", flash)
        q = torch.randn(1, 65, 1, d)
        A.sdpa(q, q, q)
        assert taken == (["flash"] if route == "flash" else [])


class TestKernelEntryPoints:
    """No silent fallback: the kernel launchers refuse CPU tensors, and the
    dispatchers count no launch when the plain version ran."""

    def test_launchers_raise_on_cpu_tensors(self):
        x = torch.randn(2, 32, 4, 4)
        w, b = torch.ones(32), torch.zeros(32)
        with pytest.raises(RuntimeError, match="no kernel"):
            N.group_norm_cuda(x, w, b)
        with pytest.raises(RuntimeError, match="no kernel"):
            N.layer_norm_cuda(x, w[:4], b[:4])
        q = torch.randn(1, 8, 1, 64)
        with pytest.raises(RuntimeError, match="no kernel"):
            A.flash_attention_cuda(q, q, q)
        with pytest.raises(RuntimeError, match="no kernel"):
            A.small_seq_attention_cuda(q, q, q)
        with pytest.raises(RuntimeError, match="no kernel"):
            FC.fused_gn_silu_conv_cuda(x, w, b, torch.ones(8, 32, 3, 3))

    def test_library_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the build path is exercised by chip_smoke.py")
        with pytest.raises(RuntimeError):
            cuda_lib.lib()

    def test_dispatchers_count_no_launch_on_cpu(self):
        counters = (A.flash_attention, A.small_seq_attention, N.fused_group_norm, N.fused_layer_norm,
                    FC.fused_gn_silu_conv)
        before = [f.launches for f in counters]
        x = torch.randn(1, 32, 4, 4)
        N.group_norm(x, torch.ones(32), torch.zeros(32))
        N.layer_norm(x, torch.ones(4), torch.zeros(4))
        FC.fused_gn_silu_conv(x, torch.ones(32), torch.zeros(32), torch.ones(8, 32, 3, 3))
        for s in (1024, 16):  # flash, then the short-sequence route
            q = torch.randn(1, s, 1, 64)
            A.sdpa(q, q, q)
        assert [f.launches for f in counters] == before


def test_port_imports_no_jax():
    """Every port module, the apps, the training modules and the data layer
    included, imports with jax, flax, the JAX package and PIL blocked (the
    port resizes video without PIL)."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        for blocked in ("jax", "flax", "t2v_turbo_tpu", "PIL"):
            sys.modules[blocked] = None
        import t2v_turbo_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(t2v_turbo_tpu_torch.__path__, "t2v_turbo_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for needed in ("apps.generate", "apps.train_v1", "io.video", "lora", "training.trainer",
                       "rewards.reward_fn", "rewards.vit", "training.reward_adapters", "ops.fused_conv",
                       "data.transforms", "data.videoio", "data.webdata", "data.datasets", "rewards.blip",
                       "rewards.internvideo2", "utils.bert_tokenizer", "training.validation", "apps.soak_v1",
                       "apps.preprocess", "apps.train_v2", "training.motion", "training.preprocess",
                       "training.lcd_v2", "training.ema", "apps.serve", "apps.warmup", "apps.verify_import",
                       "pipelines.artifact"):
            assert "t2v_turbo_tpu_torch." + needed in names, names
        print(len(names))
        """
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=repo
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 24
