"""The port's LoRA (lora.py, io/lora_import.py, io/convert.py) against the JAX
package's and the reference golden, on the CPU.

Weights and factors come from seeded numpy (non-zero `up` factors, so
every factor changes the merged weights). Tolerances: 1e-6 absolute on
merged f32 weights of O(1) (one rank-r product summed in another order),
2e-4 on UNet outputs (PARITY.md's UNet bound).
"""

import goldens
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu.io import lora_import as jlora_import
from t2v_turbo_tpu.io import torch_export as jexport
from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu import lora as jlora
from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
from t2v_turbo_tpu_torch import lora as L
from t2v_turbo_tpu_torch.apps.generate import lora_state_dict
from t2v_turbo_tpu_torch.io import convert
from t2v_turbo_tpu_torch.io import lora_import as plora_import
from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel
from torch_parity import GOLDEN_UNET_KW, TINY_UNET_KW, seeded_numpy_state_dict, to_torch

RANK = 4


def _factors(model, seed, rank=RANK):
    """Seeded factors for every target, up non-zero."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in L.target_shapes(model).items():
        down = rng.randn(rank, *shape[1:]).astype(np.float32) / rank
        up = 0.1 * rng.randn(shape[0], rank, *([1] * (len(shape) - 2))).astype(np.float32)
        out[name] = {"down": torch.from_numpy(down), "up": torch.from_numpy(up)}
    return out


@pytest.fixture(scope="module")
def tiny():
    """(port UNet, its state dict, JAX params, factors)."""
    port = UNetModel(UNetConfig(**TINY_UNET_KW))
    sd = to_torch(seeded_numpy_state_dict(port, 0))
    port.load_state_dict(sd, strict=True)
    params = {"params": ti.import_unet_params({k: v.numpy() for k, v in sd.items()},
                                               JUNetConfig(**TINY_UNET_KW))}
    return port, sd, params, _factors(port, 1)


def _jax_merged_as_torch(params, factors):
    merged = jlora.merge_lora(params, {k: {n: jnp.asarray(a) for n, a in f.items()}
                                       for k, f in convert.lora_to_jax(factors).items()})
    return convert.unet_state_dict_from_jax(merged)


@pytest.mark.parametrize(
    "leaf",
    ["input_blocks.1.0.in_layers.2",  # Conv2d 3x3
     "input_blocks.1.0.temopral_conv.conv2.3",  # Conv3d (3, 1, 1)
     "input_blocks.1.1.transformer_blocks.0.ff.net.0.proj",  # GEGLU (C, 2, F) in JAX
     "input_blocks.1.1.transformer_blocks.0.attn1.to_q",  # Linear
     "all"],
)
def test_merge_matches_jax(tiny, leaf):
    _, sd, params, factors = tiny
    ref = _jax_merged_as_torch(params, factors)
    got = L.merge_lora(sd, factors)
    keys = [k for k in got if k.endswith(".weight")] if leaf == "all" else [f"{leaf}.weight"]
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=1e-6, err_msg=k)
        if leaf != "all":
            assert float((got[k] - sd[k]).abs().max()) > 1e-3  # the factor moved it


@pytest.mark.parametrize("kw", [TINY_UNET_KW, dict(time_cond_proj_dim=256)], ids=["tiny", "vc2"])
def test_targets_equal_reference_set(kw):
    """The port's targets (every Linear/Conv2d/Conv3d) are exactly the JAX
    trainer's `vc2_reference_lora_target` leaves, in the JAX package's
    `unet_lora.pt` order."""
    jcfg = JUNetConfig(**kw)
    with torch.device("meta"):
        port = UNetModel(UNetConfig(**kw))
    targets = L.target_shapes(port)
    order = plora_import.lora_module_order(UNetConfig(**kw))
    assert order == jlora_import.lora_module_order(jcfg)
    assert set(targets) == {n for n, _ in order}
    allow = jexport.vc2_reference_lora_target(jcfg)
    paths = {("params",) + plora_import.flax_path(n) + ("kernel",) for n in targets}
    assert all(allow(p) for p in paths)
    allowed = {("params",) + jlora_import._translate(n, jcfg) + ("kernel",)
               for n, _ in jlora_import.lora_module_order(jcfg)}
    assert paths == allowed
    if kw.get("time_cond_proj_dim") == 256:  # full width, rank 64
        assert len(targets) == 575
        assert sum(64 * (s[0] + int(np.prod(s[1:]))) for s in targets.values()) == 117_336_576


def test_unet_lora_pt_export_collapses_in_jax(tiny):
    """port factors -> unet_lora.pt list -> the JAX package's apply_lora_pt
    gives the port's merged weights."""
    port, sd, params, factors = tiny
    cfg = UNetConfig(**TINY_UNET_KW)
    weights = plora_import.export_lora_pt(factors, cfg, L.target_shapes(port))
    jcfg = JUNetConfig(**TINY_UNET_KW)
    ref = convert.unet_state_dict_from_jax(
        jlora_import.apply_lora_pt(params, [w.numpy() for w in weights], jcfg))
    got = L.merge_lora(sd, factors)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=1e-6, err_msg=k)
    # the port's own fold of its export gives the same weights
    folded = plora_import.apply_lora_pt(sd, weights, cfg)
    for k in got:
        np.testing.assert_allclose(folded[k].numpy(), got[k].numpy(), atol=1e-6, err_msg=k)


def test_export_fills_missing_factors_with_zero_pairs(tiny):
    port, sd, _, factors = tiny
    cfg = UNetConfig(**TINY_UNET_KW)
    some = {k: v for i, (k, v) in enumerate(factors.items()) if i % 2}
    weights = plora_import.export_lora_pt(some, cfg, L.target_shapes(port))
    assert len(weights) == 2 * len(factors)
    folded = plora_import.apply_lora_pt(sd, weights, cfg)
    ref = L.merge_lora(sd, some)
    for k in ref:
        np.testing.assert_allclose(folded[k].numpy(), ref[k].numpy(), atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def gold():
    return goldens.load("vc2_lora_tiny")


def test_golden_module_order(gold):
    expected = [str(s) for s in gold["order"]]
    assert [n for n, _ in plora_import.lora_module_order(UNetConfig(**GOLDEN_UNET_KW))] == expected


def test_golden_collapse(gold):
    """The reference's own collapse_lora output, from its pre-collapse
    weights and saved unet_lora.pt list."""
    pre = to_torch(goldens.subdict(gold, "pre_sd"))
    collapsed = goldens.subdict(gold, "collapsed_sd")
    n = len([k for k in gold if k.startswith("lora.")])
    weights = [torch.from_numpy(gold[f"lora.{i:04d}"]) for i in range(n)]
    got = plora_import.apply_lora_pt(pre, weights, UNetConfig(**GOLDEN_UNET_KW))
    for k, ref in collapsed.items():
        np.testing.assert_allclose(got[k].numpy(), ref, atol=1e-6, err_msg=k)
    port = UNetModel(UNetConfig(**GOLDEN_UNET_KW))
    port.load_state_dict(got, strict=True)


def test_npz_is_the_jax_trainers_layout(tiny, tmp_path):
    port, _, _, factors = tiny
    path = str(tmp_path / "unet_lora.npz")
    L.save_lora_npz(path, factors)
    jax_flat = jlora.load_lora_npz(path)
    ref = convert.lora_to_jax(factors)
    assert set(jax_flat) == set(ref)
    for k in ref:
        for n in ("down", "up"):
            np.testing.assert_array_equal(np.asarray(jax_flat[k][n]), ref[k][n])
    back = L.load_lora_npz(path, port)
    for name, f in factors.items():
        for n in ("down", "up"):
            np.testing.assert_array_equal(back[name][n].numpy(), f[n].numpy())


def test_installed_factors_equal_merged_weights(tiny, tmp_path):
    """apply_lora's parametrised UNet computes what the collapsed weights do,
    leaves the base weights as they were and trains only the factors; the
    CLI's --lora-ckpt gives the same weights from .pt and .npz."""
    port, sd, _, factors = tiny
    cfg = UNetConfig(**TINY_UNET_KW)
    rng = np.random.RandomState(2)
    args = (torch.from_numpy(rng.randn(1, 2, 8, 8, 4).astype(np.float32)), torch.tensor([500]),
            torch.from_numpy(rng.randn(1, 7, 16).astype(np.float32)))
    kw = dict(fps=torch.tensor([16.0]), timestep_cond=torch.from_numpy(rng.randn(1, 8).astype(np.float32)))
    merged = L.merge_lora(sd, factors)
    plain = UNetModel(cfg)
    plain.load_state_dict(merged, strict=True)
    with torch.no_grad():
        ref = plain(*args, **kw)
    lora_model = UNetModel(cfg)
    lora_model.load_state_dict(sd, strict=True)
    L.apply_lora(lora_model, {n: {k: t.clone() for k, t in f.items()} for n, f in factors.items()})
    out = lora_model(*args, **kw)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), atol=2e-4)
    base = L.base_state_dict(lora_model)
    assert set(base) == set(sd) and all(torch.equal(base[k], sd[k]) for k in sd)
    trainable = [n for n, p in lora_model.named_parameters() if p.requires_grad]
    assert trainable and all(n.endswith((".down", ".up")) for n in trainable)
    assert len(trainable) == 2 * len(factors)

    npz, pt = str(tmp_path / "l.npz"), str(tmp_path / "l.pt")
    L.save_lora_npz(npz, factors)
    torch.save(plora_import.export_lora_pt(factors, cfg, L.target_shapes(port)), pt)
    for path in (npz, pt):
        got = lora_state_dict(port, path, cfg)
        for k in merged:
            np.testing.assert_allclose(got[k].numpy(), merged[k].numpy(), atol=1e-6, err_msg=k)
