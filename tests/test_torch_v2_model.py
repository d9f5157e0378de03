"""T2V-Turbo-v2's model surface in the port against the JAX package, on the
CPU, in f32: the UNet's motion conditioning (`motion_cond_proj`,
`combine_proj`) and attn1's probability capture in the output blocks'
temporal transformers, the weights' carry-over both ways (io/convert.py,
the exported unet.pt read by the JAX importer), and the pipeline's
motion-guidance threshold.

Weights: a seeded numpy state dict with no zeros (torch_parity), imported
into JAX params by the JAX importer. Tolerances: the UNet's output 2e-4
(PARITY.md); the captured probabilities 1e-5 (f32 softmax of the same
logits, summed in another order); the pipeline's video 3e-4 (the VAE's
bound, as tests/test_torch_pipeline.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu.diffusion import DiffusionSchedule as JSchedule
from t2v_turbo_tpu.io import torch_import as ti
from t2v_turbo_tpu.models import UNetConfig as JUNetConfig
from t2v_turbo_tpu.models import UNetModel as JUNet
from t2v_turbo_tpu.models.clip_text import CLIPTextConfig as JTextConfig
from t2v_turbo_tpu.models.clip_text import CLIPTextModel as JText
from t2v_turbo_tpu.models.vae import AutoencoderKL as JVAE
from t2v_turbo_tpu.models.vae import VAEConfig as JVAEConfig
from t2v_turbo_tpu.pipelines.vc2 import T2VTurboVC2Pipeline as JPipeline
from t2v_turbo_tpu_torch.diffusion import DiffusionSchedule
from t2v_turbo_tpu_torch.io import convert
from t2v_turbo_tpu_torch.models import (
    AutoencoderKL, CLIPTextConfig, CLIPTextModel, UNetConfig, UNetModel, VAEConfig,
)
from t2v_turbo_tpu_torch.pipelines.vc2 import T2VTurboVC2Pipeline, motion_guidance_scale
from torch_parity import (
    TINY_TEXT_KW, TINY_UNET_KW, TINY_VAE_KW, assert_no_zeros, seeded_numpy_state_dict, to_torch,
)

V2_KW = dict(TINY_UNET_KW, motion_cond_proj_dim=8)


@pytest.fixture(scope="module")
def v2_pair():
    """(port v2 UNet, JAX v2 UNet, JAX params, the numpy state dict)."""
    port = UNetModel(UNetConfig(**V2_KW))
    sd = seeded_numpy_state_dict(port, 40)
    assert_no_zeros(sd)
    assert {"motion_cond_proj.weight", "combine_proj.weight"} <= set(sd)
    assert sd["combine_proj.weight"].shape == (32, 64)
    jcfg = JUNetConfig(**V2_KW)
    params = {"params": ti.import_unet_params(sd, jcfg)}
    port.load_state_dict(convert.unet_state_dict_from_jax(params), strict=True)
    return port.eval(), JUNet(cfg=jcfg), params, sd


def _inputs(seed=41):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(2, 4, 8, 8, 4).astype(np.float32), ts=np.array([999, 279]),
                ctx=rng.randn(2, 7, 16).astype(np.float32), w=rng.randn(2, 8).astype(np.float32),
                m=rng.randn(2, 8).astype(np.float32))


def _jax_apply(junet, params, d, record_probs=False):
    fn = jax.jit(lambda p, x, ts, c, w, m: junet.apply(
        p, x, ts, c, timestep_cond=w, motion_cond=m, record_probs=record_probs,
        mutable=["intermediates"] if record_probs else False))
    return fn(params, *(jnp.asarray(d[k]) for k in ("x", "ts", "ctx", "w", "m")))


def _port_apply(port, d, **kw):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    with torch.no_grad():
        return port(t["x"], t["ts"], t["ctx"], timestep_cond=t["w"], motion_cond=t["m"], **kw)


def test_motion_conditioned_unet_matches_jax(v2_pair):
    port, junet, params, _ = v2_pair
    d = _inputs()
    ref = _jax_apply(junet, params, d)
    got = _port_apply(port, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    # the motion embedding reaches the output
    other = _port_apply(port, dict(d, m=d["m"] + 1.0))
    assert float((other - got).abs().max()) > 1e-3


def test_probability_capture_matches_jax_pairing(v2_pair):
    """record_probs returns attn1's probabilities of every output block's
    temporal transformer, ascending; JAX sows the same tensors and its
    motion code lists them by sorted key string. Each port layer equals the
    JAX layer of the same output block."""
    port, junet, params, _ = v2_pair
    d = _inputs(42)
    ref_out, inter = _jax_apply(junet, params, d, record_probs=True)
    leaves = jax.tree_util.tree_flatten_with_path(inter)[0]
    by_block = {}
    for path, v in leaves:
        key = jax.tree_util.keystr(path)
        block = [int(s.split("_")[2]) for s in key.replace("'", "").replace("[", " ").replace("]", " ").split()
                 if s.startswith("output_blocks_")]
        assert len(block) == 1 and "attn1" in key, key
        by_block[block[0]] = np.asarray(v)
    out, probs = _port_apply(port, d, record_probs=True)
    # tiny UNet: 2 levels x 2 output blocks, all with attention
    assert sorted(by_block) == [0, 1, 2, 3] and len(probs) == 4
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-4)
    for i, p in enumerate(probs):
        assert p.dtype == torch.float32 and p.shape == by_block[i].shape  # (B*H*W*heads, T, T)
        np.testing.assert_allclose(p.numpy(), by_block[i], atol=1e-5, err_msg=f"output block {i}")
    # the capture changes nothing else: the same output as without it
    torch.testing.assert_close(out, _port_apply(port, d), rtol=0, atol=0)


def test_capture_under_remat_keeps_the_graph(v2_pair):
    """With use_remat the captured probabilities still carry the gradient
    with respect to the input (the motion score's path)."""
    port, _, _, sd = v2_pair
    remat = UNetModel(UNetConfig(**V2_KW), use_remat=True)
    remat.load_state_dict(to_torch(sd), strict=True)
    d = _inputs(43)
    grads = []
    for model in (port, remat):
        x = torch.from_numpy(d["x"]).requires_grad_()
        _, probs = model(x, torch.from_numpy(d["ts"]), torch.from_numpy(d["ctx"]),
                         timestep_cond=torch.from_numpy(d["w"]), record_probs=True)
        (g,) = torch.autograd.grad(sum((p**2).sum() for p in probs), x)
        grads.append(g)
    assert float(grads[0].abs().max()) > 0
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-6 * float(grads[0].abs().max()))


def test_weights_carry_both_ways(v2_pair, tmp_path):
    """JAX params -> the port's state dict carries the motion projections;
    save_unet's unet.pt loads strictly into the port and the JAX importer
    reads it back to the same params."""
    port, _, params, sd = v2_pair
    back = convert.unet_state_dict_from_jax(params)
    for k in ("motion_cond_proj.weight", "combine_proj.weight"):
        np.testing.assert_array_equal(back[k].numpy(), sd[k])
    path = convert.save_unet(port.state_dict(), str(tmp_path / "unet.pt"))
    fresh = UNetModel(UNetConfig(**V2_KW))
    fresh.load_state_dict(convert.load_checkpoint(path), strict=True)
    reread = ti.import_unet_params(ti.load_torch_state_dict(path), JUNetConfig(**V2_KW))
    for a, b in zip(jax.tree_util.tree_leaves(reread), jax.tree_util.tree_leaves(params["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_student_state_dict_fills_the_w_projection_and_refuses_missing_motion():
    teacher = UNetModel(UNetConfig(**dict(TINY_UNET_KW, time_cond_proj_dim=None)))
    sd = teacher.state_dict()
    student_cfg = UNetConfig(**TINY_UNET_KW)
    filled = convert.student_unet_state_dict(sd, student_cfg)
    assert torch.equal(filled["time_cond_proj.weight"], torch.zeros(32, 8))
    UNetModel(student_cfg).load_state_dict(filled, strict=True)
    with pytest.raises(KeyError, match="motion_cond_proj.weight.*combine_proj.weight"):
        convert.student_unet_state_dict(sd, UNetConfig(**V2_KW))


def test_motion_guidance_threshold():
    """motion_gs at t >= T * (1 - percentage), else 0 (JAX pipelines/vc2.py:108-117)."""
    assert [motion_guidance_scale(t, 0.05, 0.3) for t in (999, 759, 700, 699, 519, 279)] == \
        [0.05, 0.05, 0.05, 0.0, 0.0, 0.0]
    assert motion_guidance_scale(999, 0.05, 0.0) == 0.0


class FakeTokenizer:
    def __call__(self, prompts):
        prompts = [prompts] if isinstance(prompts, str) else prompts
        rng = np.random.RandomState(sum(len(p) for p in prompts))
        return rng.randint(0, 50, (len(prompts), 8)).astype(np.int32)


def test_motion_conditioned_pipeline_matches_jax():
    """One step (t = 999, inside the top 30%, so the UNet gets the embedding
    of motion_gs) against the JAX pipeline at two scales: one step draws no
    renoise, so nothing random is shared. At percentage 0 the step is below
    the threshold and both scales give the same video."""
    kw_unet = dict(V2_KW, time_cond_proj_dim=256, motion_cond_proj_dim=256)
    text_kw = dict(TINY_TEXT_KW, layers=2)
    unet, vae, text = (UNetModel(UNetConfig(**kw_unet)), AutoencoderKL(VAEConfig(**TINY_VAE_KW)),
                       CLIPTextModel(CLIPTextConfig(**text_kw)))
    sds = [seeded_numpy_state_dict(m, 50 + i) for i, m in enumerate((unet, vae, text))]
    for m, sd in zip((unet, vae, text), sds):
        m.load_state_dict(to_torch(sd), strict=True)
    port = T2VTurboVC2Pipeline(unet=unet.eval(), vae=vae.eval(), text_model=text.eval(), tokenizer=FakeTokenizer(),
                               schedule=DiffusionSchedule.create(), device="cpu", vae_scale=2, dtype=torch.float32)
    jcfg = JUNetConfig(**kw_unet)
    ref = JPipeline(
        unet=JUNet(cfg=jcfg), unet_params={"params": ti.import_unet_params(sds[0], jcfg)},
        vae=JVAE(cfg=JVAEConfig(**TINY_VAE_KW)), vae_params={"params": ti.import_vae_params(sds[1], n_levels=2, n_res=1)},
        text_model=JText(cfg=JTextConfig(**text_kw)), text_params={"params": ti.import_clip_text_params(sds[2], layers=2)},
        tokenizer=FakeTokenizer(), schedule=JSchedule.create(), vae_scale=2, dtype=jnp.float32)
    lat = np.random.RandomState(12).randn(1, 4, 4, 4, 4).astype(np.float32)
    kw = dict(prompt="a cat", height=8, width=8, frames=4, num_inference_steps=1, use_motion_cond=True,
              percentage=0.3)
    for gs in (0.05, 0.5):
        want = np.asarray(ref(key=jax.random.PRNGKey(0), latents=jnp.asarray(lat), motion_gs=gs, **kw))
        got = port(latents=torch.from_numpy(lat), motion_gs=gs, **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=3e-4)
    # below the threshold the scale is 0 whatever motion_gs is: 1 step from t = 999 with
    # percentage 0 gives the same video for both scales
    a, b = (port(latents=torch.from_numpy(lat), motion_gs=gs, **dict(kw, percentage=0.0)) for gs in (0.05, 0.5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="motion_cond_proj"):
        T2VTurboVC2Pipeline(unet=UNetModel(UNetConfig(**dict(TINY_UNET_KW, time_cond_proj_dim=256))), vae=vae,
                            text_model=text, tokenizer=FakeTokenizer(), schedule=DiffusionSchedule.create(),
                            device="cpu", vae_scale=2, dtype=torch.float32)(latents=torch.from_numpy(lat), **kw)
