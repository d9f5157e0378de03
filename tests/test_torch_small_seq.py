"""The port's short-sequence attention (B8: `small_seq_attention` in
t2v_turbo_tpu_torch/ops/attention.py) against the JAX package's
`small_seq_attention` (tests_tpu/bench_small_seq_attention.py), on the CPU,
and `sdpa`'s routing to it.

The JAX side runs its Pallas "loop" kernel in interpret mode; the port runs
its plain twin `attention` (the tensors lie on the CPU).

Tolerance (f32): 1e-5 absolute, as tests/test_torch_ops.py holds attention:
only the order of f32 sums differs.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu_torch.ops import attention as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_small_seq():
    spec = importlib.util.spec_from_file_location(
        "bench_small_seq_attention", os.path.join(ROOT, "tests_tpu", "bench_small_seq_attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.small_seq_attention


@pytest.mark.parametrize("r,t,h,d", [(12, 16, 2, 64), (5, 13, 2, 64), (6, 16, 5, 64), (4, 48, 2, 64), (3, 64, 1, 64)],
                         ids=["T16", "ragged_T13", "path_heads5", "T48", "T64"])
def test_matches_jax_small_seq_attention_interpret(r, t, h, d):
    rng = np.random.RandomState(r + t)
    q, k, v = (rng.randn(r, t, h, d).astype(np.float32) for _ in range(3))
    scale = d**-0.5
    ref = _jax_small_seq()(*(jnp.asarray(a) for a in (q, k, v)), scale=scale, variant="loop",
                           interpret=True)
    got = A.small_seq_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize(
    "sq,sk,d,grad,route",
    [
        (16, 16, 64, False, "small_seq"),  # the temporal attention over 16 frames
        (13, 13, 64, False, "small_seq"),  # ragged
        (64, 64, 64, False, "small_seq"),  # the gate's edge
        (16, 16, 64, True, "flash"),       # the student's forward: B2/B3 have the backward
        (65, 65, 64, False, "flash"),      # above the gate
        (16, 77, 64, False, "flash"),      # cross-attention
        (16, 16, 512, False, "flash"),     # the head dim B8 lacks
        (16, 16, 32, False, "plain"),
    ],
)
def test_sdpa_routes_short_self_attention_to_small_seq(monkeypatch, sq, sk, d, grad, route):
    """sdpa sends self-shaped calls at S <= 64 and head dim 64 that need no
    gradient to small_seq_attention, the rest as before."""
    taken = []

    def fake(name):
        def run(q, k, v, scale=None):
            taken.append(name)
            return A.attention(q, k, v, scale=scale)
        return run

    monkeypatch.setattr(A, "small_seq_attention", fake("small_seq"))
    monkeypatch.setattr(A, "flash_attention", fake("flash"))
    q = torch.randn(2, sq, 1, d, requires_grad=grad)
    kv = torch.randn(2, sk, 1, d)
    A.sdpa(q, kv, kv)
    assert taken == ([] if route == "plain" else [route])


def test_no_grad_mode_takes_small_seq(monkeypatch):
    """Under torch.no_grad (the LCD teacher and target passes) a tensor that
    requires grad still takes the forward-only kernel."""
    taken = []
    monkeypatch.setattr(A, "small_seq_attention", lambda q, k, v, scale=None: taken.append(1) or q)
    q = torch.randn(1, 16, 1, 64, requires_grad=True)
    with torch.no_grad():
        A.sdpa(q, q, q)
    assert taken == [1]
