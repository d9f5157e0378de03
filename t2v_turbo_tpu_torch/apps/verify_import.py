"""One-command real-checkpoint verification: import parity and renders (port
of t2v_turbo_tpu/apps/verify_import.py).

  python -m t2v_turbo_tpu_torch.apps.verify_import \\
      --checkpoint /path/model.ckpt [--lora-ckpt unet_lora.pt | --unet-ckpt unet.pt] \\
      [--render 10 --render-steps 4,8,16] --output-dir runs/verify
  python -m t2v_turbo_tpu_torch.apps.verify_import --backbone ms --ms-dir /path/dir

Three layers land in one JSON report (report.json, also summarised on
stdout), under the JAX tool's keys:

1. key coverage: each family's state dict goes through the port's key maps
   (io/convert.py, io/ms.py) and a strict `load_state_dict(assign=True)`
   onto modules built on the meta device (no weights are made twice).
   Every tensor of the checkpoint must land in a module; the unconsumed
   ones outside JAX's ignorable set (EMA shadows, schedule buffers, the
   penultimate CLIP block) are mapping gaps and fail the run.
2. roundtrip: the loaded modules' `state_dict()` must equal the source
   tensors to the bit, each through its key map (reshapes included: the
   ModelScope UNet's 1x1-conv projections made Linear and the diffusers
   VAE's renames, where the JAX tool has no exporter to compare with).
3. forward smoke on --device, then with --render the fixed validation
   prompts (training/validation.py) at each --render-steps count through
   generate's pipeline, written under <output-dir>/validation/ (.mp4 with
   an ffmpeg binary, else .npy).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


class TrackingSD(dict):
    """State-dict wrapper recording which keys a loader consumed."""

    def __init__(self, sd):
        super().__init__(sd)
        self.consumed = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)

    def coverage(self, ignorable: Tuple[str, ...] = ()) -> Dict[str, Any]:
        pats = [re.compile(p) for p in ignorable]
        unconsumed = sorted(set(self) - self.consumed)
        expected = [k for k in unconsumed if any(p.search(k) for p in pats)]
        gaps = [k for k in unconsumed if not any(p.search(k) for p in pats)]
        return {
            "keys_total": len(self),
            "keys_consumed": len(self.consumed),
            "unconsumed_expected": len(expected),
            "unconsumed_gaps": gaps[:50],
            "ok": not gaps,
        }


# keys a VC2 LatentDiffusion checkpoint holds that no loader should touch (JAX's patterns)
VC2_TOP_LEVEL_SKIPPED = (
    r"^model_ema\.",          # LitEma shadow params
    r"^(log|sqrt_|alphas|betas|posterior|lvlb|scale_arr)",  # schedule buffers
    r"^logvar$",
)
CLIP_IGNORABLE = (
    r"(^|\.)attn_mask$",      # causal-mask buffer, rebuilt analytically
    r"^text_projection$",     # pooled-CLIP head; the penultimate embedder
    r"^logit_scale$",         # never runs it
    r"^transformer\.resblocks\.(\d+)\.",  # filtered per depth below
)
VAE_IGNORABLE = (
    r"^loss\.",               # LPIPS / discriminator of the training VAE
)
MS_TEXT_IGNORABLE = (
    r"position_ids$",         # HF buffer
    r"text_projection",
    r"logit_scale",
    r"final_layer_norm",
)


def _clip_ignorable(layers: int) -> Tuple[str, ...]:
    """The penultimate embedder never runs the last block, so its keys are
    expected-unconsumed."""
    return CLIP_IGNORABLE[:-1] + (rf"^transformer\.resblocks\.{layers - 1}\.",)


def _load(module, source: TrackingSD, mapped: Mapping[str, torch.Tensor], consume=True):
    """Strictly load `mapped` (the source through a key map that keeps the
    source's key order, one key for one, possibly adding keys after them)
    into the meta-device `module`, assigning its tensors, and mark the source
    keys that landed as consumed. Raises on a key the module holds that the
    map does not give, as the JAX importers do."""
    want = module.state_dict().keys()
    missing = [k for k in want if k not in mapped]
    if missing:
        raise KeyError(f"{type(module).__name__}: the checkpoint lacks {len(missing)} keys, first {missing[:5]}")
    module.load_state_dict({k: mapped[k] for k in want}, strict=True, assign=True)
    if consume:
        origin = dict(zip(mapped, source))
        for k in want:
            if k in origin:
                source[origin[k]]  # noqa: B018  (records the key as consumed)
    return module


def _roundtrip(source: Mapping, mapped: Mapping, module) -> Dict[str, Any]:
    """The loaded module's state dict back through the key map against the
    source tensors, to the bit."""
    back = module.state_dict()
    deltas, missing = {}, []
    for (sk, sv), mk in zip(source.items(), mapped):
        b = back.get(mk)
        if b is None or b.numel() != sv.numel():
            missing.append(sk)
            continue
        deltas[sk] = float((b.detach().float().reshape(sv.shape) - sv.float()).abs().max()) if sv.numel() else 0.0
    from_source = set(list(mapped)[:len(source)])
    worst = sorted(deltas.items(), key=lambda kv: -kv[1])[:5]
    mx = max(deltas.values()) if deltas else float("nan")
    return {
        "keys_compared": len(deltas),
        "max_abs_delta": mx,
        "worst": [{"key": k, "delta": d} for k, d in worst],
        "missing_from_export": missing[:20],
        "extra_in_export": sorted(k for k in back if k not in from_source)[:20],
        "ok": bool(deltas) and mx == 0.0 and not missing,
    }


def _stats(x) -> Dict[str, Any]:
    a = x.detach().float().cpu().numpy()
    return {"shape": list(a.shape), "finite": bool(np.isfinite(a).all()), "mean": float(a.mean()),
            "std": float(a.std())}


@torch.no_grad()
def _forward_smoke(unet, vae, text, device, frames=8, height=64, width=64, unet_kw=None):
    """One forward of each family with the loaded weights, in f32 on `device`."""
    from ..utils.tokenizer import CLIPTokenizer

    unet, vae, text = (m.to(device).float().eval() for m in (unet, vae, text))
    toks = torch.from_numpy(CLIPTokenizer()(["a cat"])).to(device)
    if toks.shape[1] != text.cfg.context_length or int(toks.max()) >= text.cfg.vocab_size:
        toks = torch.zeros((1, text.cfg.context_length), dtype=torch.int32, device=device)
    ctx = text(toks)
    out = {"text": _stats(ctx)}
    ctx_dim = getattr(unet.cfg, "context_dim", None) or unet.cfg.cross_attention_dim
    if ctx.shape[-1] != ctx_dim:  # tiny synthetic configs may differ
        ctx = torch.randn((1, 77, ctx_dim), generator=torch.Generator().manual_seed(0)).to(device)
    z = torch.zeros((1, frames, height // 8, width // 8, unet.cfg.in_channels), device=device)
    eps = unet(z, torch.zeros(1, dtype=torch.long, device=device), ctx, **(unet_kw or {}))
    out["unet"] = _stats(eps)
    img = torch.linspace(-1, 1, height * width * 3, device=device).reshape(1, height, width, 3)
    mean, _ = vae.encode(img)
    out["vae"] = _stats(vae.decode(mean))
    out["ok"] = all(v["finite"] for v in out.values() if isinstance(v, dict))
    return out


def verify_vc2(checkpoint: str, spec, unet_ckpt: Optional[str] = None, lora_ckpt: Optional[str] = None,
               clip_layers: int = 24, text_cfg=None, smoke_shape=(8, 64, 64), device="cpu") -> Dict[str, Any]:
    """Coverage, roundtrip and forward smoke of a VC2-family checkpoint; the
    loaded modules are in report['_modules']."""
    from ..io.convert import load_checkpoint, split_vc2_checkpoint, student_unet_state_dict
    from ..models import AutoencoderKL, CLIPTextConfig, CLIPTextModel, UNetModel

    sd = load_checkpoint(checkpoint)
    unet_sd, vae_sd, clip_sd = split_vc2_checkpoint(sd)
    matched = len(unet_sd) + len(vae_sd) + len(clip_sd)
    top_pats = [re.compile(p) for p in VC2_TOP_LEVEL_SKIPPED]
    top_gaps = [k for k in sd
                if not (k.startswith("model.diffusion_model.") or k.startswith("first_stage_model.")
                        or k.startswith("cond_stage_model.model."))
                and not any(p.search(k) for p in top_pats)]
    unet_sd, vae_sd, clip_sd = TrackingSD(unet_sd), TrackingSD(vae_sd), TrackingSD(clip_sd)
    text_cfg = text_cfg or CLIPTextConfig(layers=clip_layers)
    with torch.device("meta"):
        unet, vae, text = UNetModel(spec.unet), AutoencoderKL(spec.vae), CLIPTextModel(text_cfg)

    report: Dict[str, Any] = {"backbone": "vc2", "checkpoint": checkpoint}
    mapped = student_unet_state_dict(unet_sd, spec.unet)
    _load(unet, unet_sd, mapped)
    report["unet"] = unet_sd.coverage()
    report["unet"]["roundtrip"] = _roundtrip(unet_sd, mapped, unet)
    if unet_ckpt:
        student_sd = TrackingSD(load_checkpoint(unet_ckpt))
        with torch.device("meta"):
            unet = UNetModel(spec.unet)
        mapped = student_unet_state_dict(student_sd, spec.unet)
        _load(unet, student_sd, mapped)
        report["unet_ckpt"] = student_sd.coverage()
        report["unet_ckpt"]["roundtrip"] = _roundtrip(student_sd, mapped, unet)
    if lora_ckpt:
        from .generate import lora_state_dict

        folded = lora_state_dict(unet, lora_ckpt, spec.unet)
        unet.load_state_dict(folded, strict=True, assign=True)
        report["lora"] = {"format": "npz", "ok": True} if lora_ckpt.endswith(".npz") else {
            "format": "pt", "ok": True}
    _load(vae, vae_sd, vae_sd)
    report["vae"] = vae_sd.coverage(VAE_IGNORABLE)
    _load(text, clip_sd, clip_sd)
    report["text"] = clip_sd.coverage(_clip_ignorable(clip_layers))
    report["top_level_gaps"] = top_gaps[:50]

    f, h, w = smoke_shape
    kw = {"fps": torch.full((1,), 16.0, device=device)}
    if spec.unet.time_cond_proj_dim:
        kw["timestep_cond"] = torch.zeros((1, spec.unet.time_cond_proj_dim), device=device)
    report["forward"] = _forward_smoke(unet, vae, text, device, f, h, w, kw)
    report["ok"] = (
        report["unet"]["ok"] and report["unet"]["roundtrip"]["ok"] and report["vae"]["ok"] and report["text"]["ok"]
        and not top_gaps and report["forward"]["ok"] and matched > 0
        and ("unet_ckpt" not in report or (report["unet_ckpt"]["ok"] and report["unet_ckpt"]["roundtrip"]["ok"]))
    )
    report["_modules"] = (unet, vae, text)
    return report


def verify_ms(ms_dir: str, unet_cfg=None, vae_cfg=None, lora_ckpt: Optional[str] = None, smoke_shape=(8, 64, 64),
              device="cpu") -> Dict[str, Any]:
    """Coverage, roundtrip (UNet and VAE) and forward smoke of a ModelScope
    diffusers folder (unet/, vae/, text_encoder/)."""
    from ..io.ms import (
        diffusers_vae_to_orig, find_weight_file, hf_clip_text_config, load_state_dict_any, ms_unet_state_dict,
    )
    from ..models import AutoencoderKL, CLIPTextModel, VAEConfig
    from ..models.unet_ms import MSUNet3DConditionModel, MSUNetConfig
    from ..rewards.reward_fn import hf_clip_text_to_open_clip

    report: Dict[str, Any] = {"backbone": "ms", "ms_dir": ms_dir}
    unet_sd, vae_sd, text_sd = (TrackingSD(load_state_dict_any(find_weight_file(os.path.join(ms_dir, sub))))
                                for sub in ("unet", "vae", "text_encoder"))
    ucfg = unet_cfg or MSUNetConfig(time_cond_proj_dim=256)
    cfg_path = os.path.join(ms_dir, "text_encoder", "config.json")
    hf_config = json.load(open(cfg_path)) if os.path.exists(cfg_path) else None
    with torch.device("meta"):
        unet, vae = MSUNet3DConditionModel(ucfg), AutoencoderKL(vae_cfg or VAEConfig())
        text = CLIPTextModel(hf_clip_text_config(dict(text_sd), hf_config))

    mapped = ms_unet_state_dict(unet_sd, ucfg)
    _load(unet, unet_sd, mapped)
    report["unet"] = unet_sd.coverage()
    report["unet"]["roundtrip"] = _roundtrip(unet_sd, mapped, unet)
    if lora_ckpt:
        from ..io.lora_import import apply_lora_pt_ms, load_lora_pt

        pairs = load_lora_pt(lora_ckpt)
        unet.load_state_dict(apply_lora_pt_ms(unet.state_dict(), pairs, ucfg), strict=True, assign=True)
        report["lora"] = {"format": "pt", "pairs_folded": len(pairs), "ok": True}
    mapped = diffusers_vae_to_orig(vae_sd)
    _load(vae, vae_sd, mapped)
    report["vae"] = vae_sd.coverage(VAE_IGNORABLE)
    report["vae"]["roundtrip"] = _roundtrip(vae_sd, mapped, vae)
    # the HF tower's map packs q, k, v into one tensor and raises on any
    # key it leaves but position_ids: a strict load consumes the rest
    _load(text, text_sd, hf_clip_text_to_open_clip(dict(text_sd)), consume=False)
    for k in text_sd:
        if not k.endswith("position_ids"):
            text_sd[k]  # noqa: B018
    report["text"] = text_sd.coverage(MS_TEXT_IGNORABLE)
    f, h, w = smoke_shape
    kw = {"timestep_cond": torch.zeros((1, ucfg.time_cond_proj_dim), device=device)} if ucfg.time_cond_proj_dim else {}
    report["forward"] = _forward_smoke(unet, vae, text, device, f, h, w, kw)
    report["ok"] = (report["unet"]["ok"] and report["unet"]["roundtrip"]["ok"] and report["vae"]["ok"]
                    and report["vae"]["roundtrip"]["ok"] and report["text"]["ok"] and report["forward"]["ok"])
    report["_modules"] = (unet, vae, text)
    return report


def render_validation(args) -> List[Dict[str, Any]]:
    """The validation prompts at each step count through generate's pipeline
    built from the verified checkpoint (bf16 on a card)."""
    from ..io.video import save_video
    from ..pipelines.vc2 import video_to_uint8
    from ..training.validation import DEFAULT_VALIDATION_PROMPTS
    from .generate import build_pipeline

    pipe = build_pipeline(args)
    prompts = list(DEFAULT_VALIDATION_PROMPTS)[: args.render]
    steps = [int(s) for s in args.render_steps.split(",")]
    vdir = os.path.join(args.output_dir, "validation")
    os.makedirs(vdir, exist_ok=True)
    ext = ".mp4" if shutil.which("ffmpeg") else ".npy"
    rows = []
    for n_steps in steps:
        for i, prompt in enumerate(prompts):
            t0 = time.time()
            video = pipe(prompt=prompt, height=args.height, width=args.width, frames=args.frames,
                         num_inference_steps=n_steps, generator=torch.Generator(device=pipe.device).manual_seed(i))
            path = save_video(video_to_uint8(video)[0], os.path.join(vdir, f"s{n_steps}_p{i}{ext}"),
                              fps=args.save_fps)
            rows.append({"prompt": prompt, "steps": n_steps, "path": path,
                         "finite": bool(torch.isfinite(video).all()), "seconds": round(time.time() - t0, 1)})
            print(f"# rendered s{n_steps} p{i} {path}", file=sys.stderr)
    return rows


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Verify a reference checkpoint imports correctly")
    p.add_argument("--backbone", default="vc2", choices=["vc2", "ms"])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--unet-ckpt", default=None)
    p.add_argument("--lora-ckpt", default=None)
    p.add_argument("--ms-dir", default=None)
    p.add_argument("--clip-layers", type=int, default=24)
    p.add_argument("--output-dir", default="runs/verify")
    p.add_argument("--render", type=int, default=0, help="render the first N validation prompts (0 = skip)")
    p.add_argument("--render-steps", default="4,8,16")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--save-fps", type=int, default=8)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", default="cuda:0")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.backbone == "ms":
        if not args.ms_dir:
            print("error: --backbone ms requires --ms-dir", file=sys.stderr)
            raise SystemExit(2)
        report = verify_ms(args.ms_dir, lora_ckpt=args.lora_ckpt, device=args.device)
    else:
        if not args.checkpoint:
            print("error: provide --checkpoint", file=sys.stderr)
            raise SystemExit(2)
        from ..config import vc2_spec

        report = verify_vc2(args.checkpoint, vc2_spec(), unet_ckpt=args.unet_ckpt, lora_ckpt=args.lora_ckpt,
                            clip_layers=args.clip_layers, device=args.device)
    report.pop("_modules", None)
    if args.render > 0:
        # renders go through generate's loader (bf16 on a card); the
        # verified import above is the f32 parity pass
        args.random_weights = False
        report["renders"] = render_validation(args)
        report["ok"] = report["ok"] and all(r["finite"] for r in report["renders"])
    path = os.path.join(args.output_dir, "report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k in ("backbone", "ok")} | {"report": path}))
    if not report["ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
