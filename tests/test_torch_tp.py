"""The port's tensor-parallel plan (t2v_turbo_tpu_torch/parallel/tp.py) against
the JAX package's `tp_param_shardings`, and the consumers that refuse the
model axis, on the CPU.

- The plan on the tiny UNet (tests/torch_parity.py::TINY_UNET_KW: heads of
  16, 2 at level 0, 4 at level 1, init_attn's 8) at model 2 and 4, conv
  channels on and off, against JAX's shardings over `jax.eval_shape`
  params on a mesh of the 8 virtual CPU devices (no compile): for every
  rank, JAX's block of each leaf, carried through the port's layout map
  (io/convert.py::unet_state_dict_from_jax), equals the port's block of the
  same tensor, so the same tensors split on the same dimension into the
  same values; the biases and norm affines the port splits beside them are
  whole leaves to JAX (GSPMD slices them locally).
- The full-width VC2 UNet on the meta device: the weights that split and
  the row layers (the model all-reduces of a UNet pass) at model 2 and 4.
- The GEGLU's value / gate pairing, the scale-shift embedding's, and the
  sum of the row layer's partials against the whole layer (f32, 1e-5);
  the whole tiny UNet split over 2 and 4 ranks run in lockstep threads,
  with the scale-shift ResBlock, the image branch and relative position on,
  against the whole UNet (f32, 1e-5).
- The refusals: the trainer, the preprocess, the MS pipeline and UNet, the
  capture, a sharded UNet's state dict (every export reads it), the model
  all-reduce's gradient, and a sharded UNet made whole again.
The ranks' sampling over model meshes: tests/test_torch_seq_parallel.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_dist_worker as W
from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
from t2v_turbo_tpu.models import UNetModel as JUNet
from t2v_turbo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from t2v_turbo_tpu.parallel.tp import tp_param_shardings
from t2v_turbo_tpu_torch.io.convert import unet_state_dict_from_jax
from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel
from t2v_turbo_tpu_torch.models.layers import FeedForward
from t2v_turbo_tpu_torch.parallel import collectives, tp
from torch_parity import TINY_UNET_KW, seeded_numpy_state_dict

HEAD_DIM = TINY_UNET_KW["num_head_channels"]


@pytest.fixture(scope="module")
def jax_tiny():
    """(JAX's tiny UNet params as numpy, every leaf distinct values; their eval_shape tree)."""
    unet = JUNet(cfg=JUNetConfig(**TINY_UNET_KW))
    shapes = jax.eval_shape(lambda: unet.init(jax.random.PRNGKey(0), jnp.zeros((2, 4, 8, 8, 4)),
                                              jnp.zeros((2,), jnp.int32), jnp.zeros((2, 7, 16)),
                                              timestep_cond=jnp.zeros((2, 8))))
    rng = np.random.RandomState(0)
    return jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes), shapes


def _jax_block(a, spec, index, n):
    for dim, axis in enumerate(spec):
        if axis == "model":
            step = a.shape[dim] // n
            return np.take(a, range(index * step, (index + 1) * step), axis=dim)
    return a


@pytest.mark.parametrize("conv_channels", [True, False], ids=["conv", "attention-ff"])
@pytest.mark.parametrize("n", [2, 4])
def test_plan_matches_jax_shardings(jax_tiny, n, conv_channels):
    params, shapes = jax_tiny
    mesh = jax_make_mesh(data=8 // n, model=n)
    shardings = tp_param_shardings(mesh, shapes, head_dim=HEAD_DIM, conv_channels=conv_channels)
    whole = unet_state_dict_from_jax(params)
    plan = tp.tp_plan({k: tuple(v.shape) for k, v in whole.items()}, n, HEAD_DIM, conv_channels)
    port = UNetModel(UNetConfig(**TINY_UNET_KW))
    assert set(plan) == {k for k, _ in port.named_parameters()}
    kinds = {s.kind for s in plan.values() if s is not None}
    assert kinds == ({"column", "row", "bias", "norm"} if conv_channels else {"column", "row", "bias"})
    for index in range(n):
        jax_blocks = unet_state_dict_from_jax(
            jax.tree.map(lambda a, sh: _jax_block(a, sh.spec, index, n), params, shardings))
        for key, split in plan.items():
            mine = tp.block(whole[key], split, index, n)
            if split is None or split.kind in ("column", "row"):
                assert torch.equal(jax_blocks[key], mine), (key, split)
            else:  # a column layer's bias or a row conv's norm: a whole leaf to JAX, which GSPMD slices locally
                assert torch.equal(jax_blocks[key], whole[key]), key
                assert mine.shape[0] == whole[key].shape[0] // n
    # the head guard counts heads of the projection's own width: init_attn (8 heads) splits at 2 and 4,
    # the level-0 transformers (2 heads) at 2 only
    assert plan["init_attn.0.transformer_blocks.0.attn1.to_q.weight"] is not None
    level0 = plan["input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight"]
    assert (level0 is not None) == (n == 2)


def test_full_width_split_counts():
    """VC2's UNet (no w-embedding projection, 1,413,284,420 parameters) on
    the meta device: the weights that split, and the row layers (66 row
    convs, 33 GEGLU outs and the to_outs that split)."""
    with torch.device("meta"):
        unet = UNetModel(UNetConfig())
    shapes = {k: tuple(p.shape) for k, p in unet.named_parameters()}
    assert sum(math.prod(s) for s in shapes.values()) == 1_413_284_420
    for n, split, rows, to_outs in ((2, 1_272_094_720, 145, 46), (4, 1_236_869_120, 125, 26)):
        plan = tp.tp_plan(shapes, n, 64)
        assert sum(math.prod(shapes[k]) for k, s in plan.items() if s is not None and s.kind in ("column", "row")) \
            == split
        assert tp.row_layers(plan) == rows
        assert sum(1 for k, s in plan.items() if s is not None and ".to_out." in k) == to_outs


def test_geglu_block_pairs_value_and_gate():
    """Rank r's rows of the (2F, C) projection are value rows r*F/n ... and
    gate rows F + r*F/n ...; the ranks' partial outputs of net.2 add up to
    the whole layer. A contiguous slice of the 2F rows would not."""
    g = torch.Generator().manual_seed(0)
    ff = FeedForward(8).requires_grad_(False)  # F = 32
    for p in ff.parameters():  # N(0, 1) / sqrt(fan_in) matrices, 0.1 N(0, 1) biases
        p.data = torch.randn(p.shape, generator=g) / (p.shape[-1] ** 0.5 if p.dim() == 2 else 10.0)
    x = torch.randn(3, 5, 8, generator=g)
    shapes = {"b.ff.net.0.proj.weight": (64, 8), "b.ff.net.0.proj.bias": (64,), "b.ff.net.2.weight": (8, 32),
              "b.ff.net.2.bias": (8,)}
    plan = tp.tp_plan(shapes, 2)
    assert plan["b.ff.net.0.proj.weight"] == tp.Split(0, "column", 2)
    assert plan["b.ff.net.0.proj.bias"] == tp.Split(0, "bias", 2)
    assert plan["b.ff.net.2.weight"] == tp.Split(1, "row") and plan["b.ff.net.2.bias"] is None
    w1, b1, w2 = ff.net[0].proj.weight, ff.net[0].proj.bias, ff.net[2].weight
    blocks = [tp.block(w1, plan["b.ff.net.0.proj.weight"], r, 2) for r in range(2)]
    assert torch.equal(blocks[1], torch.cat([w1[16:32], w1[48:64]]))

    def partial(r, w1_r, b1_r):
        value, gate = F.linear(x, w1_r, b1_r).chunk(2, dim=-1)
        return F.linear(value * F.gelu(gate), tp.block(w2, plan["b.ff.net.2.weight"], r, 2))

    with torch.no_grad():
        whole = ff(x)
        paired = sum(partial(r, blocks[r], tp.block(b1, plan["b.ff.net.0.proj.bias"], r, 2)) for r in range(2))
        contiguous = sum(partial(r, w1[32 * r:32 * (r + 1)], b1[32 * r:32 * (r + 1)]) for r in range(2))
    torch.testing.assert_close(paired + ff.net[2].bias, whole, atol=1e-5, rtol=0)
    assert float((contiguous + ff.net[2].bias - whole).abs().max()) > 0.1


def test_scale_shift_embedding_splits_scale_and_shift():
    """With use_scale_shift_norm, emb_layers.1 is (2 * out, E) = (scale,
    shift): rank r takes the scale rows and the shift rows of its channel
    block."""
    cfg = UNetConfig(**dict(TINY_UNET_KW, use_scale_shift_norm=True))
    with torch.device("meta"):
        shapes = {k: tuple(p.shape) for k, p in UNetModel(cfg).named_parameters()}
    plan = tp.tp_plan(shapes, 2, HEAD_DIM)
    key = "input_blocks.1.0.emb_layers.1.weight"
    assert shapes[key] == (64, 128) and plan[key] == tp.Split(0, "column", 2)
    w = torch.arange(64.0)[:, None]
    assert tp.block(w, plan[key], 1, 2)[:, 0].tolist() == list(range(16, 32)) + list(range(48, 64))


def _sharded_tiny(n=2, index=0):
    unet = UNetModel(UNetConfig(**dict(TINY_UNET_KW, time_cond_proj_dim=256)))
    unet.set_model_group(W.stand_in_mesh(model=n, rank=index).axis("model"))
    return unet


def test_shard_in_place_sets_heads_groups_and_blocks():
    whole = UNetModel(UNetConfig(**dict(TINY_UNET_KW, time_cond_proj_dim=256)))
    sd = {k: v.clone() for k, v in whole.state_dict().items()}
    group = W.stand_in_mesh(model=2, rank=1).axis("model")
    plan = tp.shard_unet_tp_(whole, group)
    assert whole.tp_plan is plan
    for key, p in whole.named_parameters():
        assert torch.equal(p, tp.block(sd[key], plan[key], 1, 2)), key
    blk = whole.input_blocks[1]
    assert blk[1].transformer_blocks[0].attn1.heads == 1 and whole.init_attn[0].transformer_blocks[0].attn1.heads == 4
    assert blk[0].out_layers[0].num_groups == 16 and blk[0].in_layers[0].num_groups == 32
    assert blk[0].temopral_conv.conv2[0].num_groups == 16 and blk[0].temopral_conv.conv3[0].num_groups == 32
    assert blk[0].model_group is group and blk[1].transformer_blocks[0].ff.model_group is group
    assert blk[1].proj_in.weight.shape == sd["input_blocks.1.1.proj_in.weight"].shape  # whole between the splits
    # a split UNet is not made whole, nor split again
    for other in (None, W.stand_in_mesh(model=2, rank=1).axis("model")):
        with pytest.raises(ValueError, match="cannot be whole again or split again"):
            whole.set_model_group(other)
    # a group of one rank changes nothing
    one = UNetModel(UNetConfig(**dict(TINY_UNET_KW, time_cond_proj_dim=256)))
    assert tp.shard_unet_tp_(one, W.stand_in_mesh(model=1).axis("model")) is None
    assert not tp.is_sharded(one) and one.state_dict().keys() == sd.keys()


def _lockstep_all_reduce(n):
    """A stand-in for `collectives.model_all_reduce` over n threads, one a
    rank (each thread's UNet split over its own stand-in group): each call
    waits for every rank's partial and returns their sum in rank order."""
    import threading

    barrier, slots = threading.Barrier(n, timeout=60), [None] * n

    def reduce(x, group):
        slots[group.index] = x
        barrier.wait()
        total = sum(slots[1:], slots[0])
        barrier.wait()  # every rank has read the slots before the next call refills them
        return total

    return reduce


@pytest.mark.parametrize("n", [2, 4])
def test_split_unet_with_the_switches_equals_the_whole(monkeypatch, n):
    """The UNet split over n ranks, run in n threads whose row layers sum
    in lockstep, equals the whole UNet (f32, 1e-5), with the switches the
    rank cases do not take: the scale-shift ResBlock (emb_layers.1 split as
    scale and shift), the image branch (to_k_ip / to_v_ip column) and the
    relative-position temporal attention."""
    import threading

    cfg = UNetConfig(**dict(TINY_UNET_KW, time_cond_proj_dim=256, use_scale_shift_norm=True,
                            use_image_attention=True, use_relative_position=True, temporal_length=4))
    whole = UNetModel(cfg)
    sd = {k: torch.from_numpy(v) for k, v in seeded_numpy_state_dict(whole, 7).items()}
    whole.load_state_dict(sd)
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(1, 4, 8, 8, 4).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(1, 204, 16).astype(np.float32))  # 200 text rows, 4 image tokens
    args = (x, torch.tensor([500]), ctx)
    kw = dict(fps=torch.tensor([16.0]), timestep_cond=torch.from_numpy(rng.randn(1, 256).astype(np.float32)))
    with torch.no_grad():
        ref = whole(*args, **kw)
    monkeypatch.setattr(collectives, "model_all_reduce", _lockstep_all_reduce(n))
    outs, errors = [None] * n, []

    def rank(i):
        try:
            unet = UNetModel(cfg)
            unet.load_state_dict(sd)
            unet.set_model_group(W.stand_in_mesh(model=n, rank=i).axis("model"))
            with torch.no_grad():
                outs[i] = unet(*args, **kw)
        except Exception as e:  # noqa: BLE001  (reported below; a rank that fails breaks the others' barrier)
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    for out in outs:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_consumers_refuse_the_model_axis(tmp_path):
    from t2v_turbo_tpu_torch.apps import warmup
    from t2v_turbo_tpu_torch.models.unet_ms import MSUNet3DConditionModel, MSUNetConfig
    from t2v_turbo_tpu_torch.pipelines.ms import T2VTurboMSPipeline
    from t2v_turbo_tpu_torch.training.preprocess import preprocess_sample
    from t2v_turbo_tpu_torch.training.trainer import LCDTrainer

    mesh = W.stand_in_mesh(model=2)
    with pytest.raises(NotImplementedError, match="A12b.2b"):
        preprocess_sample(None, torch.zeros(1, 4, 8, 8, 4), None, None, None, sched=None, solver=None, cfg=None,
                          mesh=mesh)
    with pytest.raises(NotImplementedError, match="A12b.2b"):
        LCDTrainer(student=None, sched=None, solver=None, optimizer=None, cfg=None, mesh=mesh)
    with pytest.raises(NotImplementedError, match="A12b.2b"):
        T2VTurboMSPipeline(unet=None, vae=None, text_model=None, tokenizer=None, schedule=None, device="cpu",
                           mesh=mesh)
    ms = MSUNet3DConditionModel(MSUNetConfig(block_out_channels=(32, 64), layers_per_block=1, attention_head_dim=16,
                                             cross_attention_dim=16))
    with pytest.raises(NotImplementedError, match="A12b.2b"):
        ms.set_model_group(mesh.axis("model"))
    unet = _sharded_tiny()
    with pytest.raises(NotImplementedError, match="A12b.2b"):  # a sharded UNet handed to the trainer
        LCDTrainer(student=unet, sched=None, solver=None, optimizer=None, cfg=None)
    with pytest.raises(RuntimeError, match="no checkpoint"):  # every export reads the state dict
        unet.state_dict()
    with pytest.raises(RuntimeError, match="no checkpoint"):  # warmup --export's weight inputs
        warmup._weight_inputs(unet, "cpu")
    with pytest.raises(NotImplementedError, match="A12b.2b"), torch.no_grad():  # the capture, before any sum
        unet.output_blocks[3][2](torch.zeros(1, 32, 2, 4, 4), record_probs=True)


def test_model_all_reduce_refuses_a_gradient():
    group = W.stand_in_mesh(model=2).axis("model")
    with pytest.raises(NotImplementedError, match="training half of A12b.2"):
        collectives.model_all_reduce(torch.ones(3, requires_grad=True), group)
    x = torch.ones(3)
    assert collectives.model_all_reduce(x, W.stand_in_mesh(model=1).axis("model")) is x
