"""The LCD trainer on one device (port of t2v_turbo_tpu/training/trainer.py
without the mesh, FSDP, tensor parallelism, the split step and multi-host),
in two modes that share the step's clip and accumulation, `run`, the
prefetcher, the checkpoints, the watchdog and the metrics:

- LoRA (v1, `lora_rank` set). State: the student's LoRA factors (f32,
  installed on the frozen student by `lora.apply_lora`), the optimizer's
  moments and the step count. The factors live in one flat buffer
  (`optim.flat_buffer`), so the gradient norm, the clip and the optimizer
  run on it in a few launches.
- Full model (v2, `lora_rank=None`). An f32 master of every student
  parameter in one flat buffer, ordered (non-norm, norm) x the optimizer
  groups of `param_label` (the v2 temporal group); the student's non-norm
  weights are views of one buffer in its compute dtype (bf16 on the card),
  refreshed from the master in one launch after each update, and its
  norms' affines (f32, `cast_compute_dtype_` keeps them so) are views of
  the master itself, trained in place. This is what the JAX trainer
  computes: f32 parameters cast to bf16 inside `apply`. The gradients land
  in a flat f32 buffer (bf16 with `grads_bf16`; the norm is f32 either
  way), laid out as the master. With `ema_decay`, an f32 EMA flat buffer
  (decay * ema + (1 - decay) * master, once per optimizer update, not per
  micro-step, as JAX's) feeds a second UNet (`target`: its weights are
  views of the EMA's compute-dtype copy and of the EMA itself), the v2
  target network. One optimizer per group over the master's segments.
  The loss is the `loss_fn` hook (lcd_v2.py's, through apps/train_v2.py).
  With a `text_encoder` (v2's --train-text-encoder), its parameters that
  `param_label` does not call "frozen" (named "text.<key>") join the
  master after the UNet's, non-norm then norm, with their own working
  copy; the frozen ones keep no slot and no gradient. The EMA and the
  target cover the UNet alone (JAX's ema_path="unet").
- A step: the LCD loss and its gradients with respect to the factors; the
  global gradient norm in f32; with one micro-step per update, the
  gradients scaled by min(1, max_grad_norm / (norm + 1e-6)) and applied;
  with K > 1 micro-steps, their mean is clipped to max_grad_norm and
  applied every K-th micro-step (optax.MultiSteps over
  clip_by_global_norm, as the JAX trainer). `max_steps` counts micro-steps.
- Checkpoints: `torch.save` of the state into output_dir/checkpoints,
  the newest `keep_checkpoints` kept, resumed from the newest on `run`.
  The resume step is folded into the draws' generator seed, so a resumed
  run does not replay the first steps' draws.
- Input: `run` pulls batches through `data.datasets.DevicePrefetcher`, so
  the data iterator's work (decode, encode) and the copy to the device
  overlap the step, as the JAX trainer's `run` does.
- Metrics: one JSON row per logged step in output_dir/metrics.jsonl with
  time_per_step_s, the losses (with reward feedback, reward_loss and
  video_rm_loss too), grad_norm and data_wait_frac (the share of
  the window the host waited for the next batch); a heartbeat file and
  SIGTERM/SIGINT handling (training/watchdog.py) as in the JAX trainer;
  periodic validation videos through `run`'s validation_fn.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch.nn.utils import parametrize

from ..data.datasets import DevicePrefetcher
from ..lora import LoRAConfig, apply_lora, base_state_dict, init_lora, lora_factors, merge_lora
from ..models.layers import GroupNorm, LayerNorm
from .ema import update_ema
from .lcd import LCDConfig, lcd_loss, sample_draws
from .optim import STEP_CHUNK, TEXT_PREFIX, flat_buffer
from .watchdog import GracefulShutdown, Heartbeat


@dataclasses.dataclass
class TrainerConfig:
    output_dir: str = "runs/lcd"
    max_steps: int = 10_000
    checkpoint_every: int = 2000
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0
    max_grad_norm: float = 10.0
    lora_rank: Optional[int] = 64  # None: full-model training (v2)
    grad_accum_steps: int = 1
    ema_decay: Optional[float] = None  # full model: the EMA target network's decay
    grads_bf16: bool = False  # the gradient buffer in bf16 (the norm stays f32)


def draws_seed(seed: int, step: int) -> int:
    """The draws' generator seed for a run (re)starting at `step`."""
    return ((seed + 1) * 1_000_003 + step) % (2**63 - 1)


def v1_loss(trainer: "LCDTrainer", batch, draws):
    """The v1 LCD loss of the trainer's student and teacher."""
    return lcd_loss(trainer.student, trainer.teacher, batch, draws, sched=trainer.sched, solver=trainer.solver,
                    cfg=trainer.lcd_cfg, reward_fn=trainer.reward_fn, video_reward_fn=trainer.video_reward_fn)


def v1_draws(trainer: "LCDTrainer", batch):
    """The v1 step's draws from the trainer's generator."""
    return sample_draws(trainer.lcd_cfg, batch["latents"].shape, trainer.generator)


def _norm_f32(g: torch.Tensor) -> torch.Tensor:
    """The 2-norm of a flat gradient, in f32 (a bf16 buffer chunk by chunk,
    so no f32 copy of it is made)."""
    if g.dtype == torch.float32:
        return torch.linalg.vector_norm(g)
    return torch.sqrt(sum(torch.sum(torch.square(c.float())) for c in g.split(STEP_CHUNK)))


def _is_norm_param(module: torch.nn.Module) -> Callable[[str], bool]:
    names = {f"{n}.{k}" if n else k for n, m in module.named_modules() if isinstance(m, (GroupNorm, LayerNorm))
             for k, _ in m.named_parameters(recurse=False)}
    return names.__contains__


def _set_parameter(module: torch.nn.Module, name: str, value: torch.Tensor, requires_grad: bool) -> None:
    owner, _, leaf = name.rpartition(".")
    (module.get_submodule(owner) if owner else module)._parameters[leaf] = torch.nn.Parameter(
        value, requires_grad=requires_grad)


class LCDTrainer:
    def __init__(self, *, student, teacher=None, sched, solver, lcd_cfg=None,
                 optimizer: Callable, cfg: TrainerConfig,
                 reward_fn: Optional[Callable] = None, video_reward_fn: Optional[Callable] = None,
                 loss_fn: Callable = v1_loss, draws_fn: Callable = v1_draws,
                 param_label: Optional[Callable[[str], str]] = None,
                 text_encoder: Optional[torch.nn.Module] = None):
        """student: the UNet to train; teacher: the frozen UNet (v1);
        reward_fn / video_reward_fn: the reward feedback terms
        (training/reward_adapters.py), whose models must be frozen.
        LoRA mode: the student's weights are frozen and get LoRA factors;
        optimizer: params -> optimizer (e.g. functools.partial(
        optim.make_optimizer, name=...)). Full-model mode (cfg.lora_rank
        None): the student (f32) is trained whole, its non-norm weights run
        in bf16 on a CUDA device (f32 on the CPU); param_label(name) puts
        each parameter in an optimizer group (default "base"); optimizer:
        (params, label) -> that group's optimizer (optim.make_v2_optimizer);
        text_encoder: a text tower trained beside the student (full model
        only), its parameters labelled as "text." + key, the "frozen" ones
        left out. loss_fn(trainer, batch, draws) -> (loss, terms) and
        draws_fn(trainer, batch) -> draws give the step's loss (default: v1's
        LCD loss and draws)."""
        self.cfg, self.lcd_cfg = cfg, lcd_cfg
        self.reward_fn, self.video_reward_fn = reward_fn, video_reward_fn
        self.loss_fn, self.draws_fn = loss_fn, draws_fn
        self.device = next(student.parameters()).device
        self.sched, self.solver = sched.to(self.device), solver.to(self.device)
        self.student = student
        self.teacher = teacher.requires_grad_(False) if teacher is not None else None
        self.target = None
        self.text_encoder = text_encoder
        if text_encoder is not None and cfg.lora_rank is not None:
            raise ValueError("a trained text encoder needs the full-model mode (lora_rank=None)")
        if cfg.grads_bf16 and cfg.grad_accum_steps > 1:
            raise ValueError("grads_bf16 would accumulate micro-step gradients in bf16: use f32 gradients")
        if cfg.lora_rank is None:
            self._init_full(optimizer, param_label or (lambda name: "base"))
        else:
            self._init_lora(optimizer)
        self.step = 0
        self._acc: Optional[torch.Tensor] = None  # mean of the micro-step grads
        self._micro = 0
        self.generator = torch.Generator().manual_seed(draws_seed(cfg.seed, 0))
        self.ckpt_dir = os.path.join(cfg.output_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._metrics_path = os.path.join(cfg.output_dir, "metrics.jsonl")

    def _init_lora(self, optimizer):
        cfg, student = self.cfg, self.student
        factors = init_lora(student, LoRAConfig(rank=cfg.lora_rank),
                            torch.Generator().manual_seed(cfg.seed))
        keys = [(n, k) for n in sorted(factors) for k in ("down", "up")]
        self.flat, views = flat_buffer([factors[n][k] for n, k in keys])
        for (n, k), view in zip(keys, views):
            factors[n][k] = view
        apply_lora(student, factors)  # parameters sharing the flat buffer
        self.factors = lora_factors(student)
        self._lora_modules = [student.get_submodule(n) for n in sorted(self.factors)]
        self.params = [self.factors[n][k] for n, k in keys]
        gdtype = torch.bfloat16 if cfg.grads_bf16 else torch.float32
        self._grad_flat = torch.zeros_like(self.flat, dtype=gdtype)
        self._grad_views = [self._grad_flat[v.storage_offset():v.storage_offset() + v.numel()].view(v.shape)
                            for v in views]
        self.optimizer = optimizer([self.flat])
        self._groups = [(self.optimizer, [slice(0, self.flat.numel())])]

    def _init_full(self, optimizer, param_label):
        """The master, the working copy, the gradient buffer, the groups'
        optimizers and, with ema_decay, the EMA and its target UNet."""
        cfg, student = self.cfg, self.student
        dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        modules = {"": student} if self.text_encoder is None else {"": student, TEXT_PREFIX: self.text_encoder}
        norm_tests = {prefix: _is_norm_param(m) for prefix, m in modules.items()}
        named = [(n, p) for n, p in student.named_parameters()]
        if self.text_encoder is not None:
            for n, p in self.text_encoder.named_parameters():
                if param_label(TEXT_PREFIX + n) != "frozen":
                    named.append((TEXT_PREFIX + n, p))
                    continue
                p.requires_grad_(False)
                if not norm_tests[TEXT_PREFIX](n):  # in the compute dtype, as the trained weights' working copy
                    p.data = p.data.to(dtype)

        def is_text(name):
            return name.startswith(TEXT_PREFIX)

        def owner(name):  # (module, its own key)
            prefix = TEXT_PREFIX if is_text(name) else ""
            return modules[prefix], name[len(prefix):]

        def is_norm(name):
            return norm_tests[TEXT_PREFIX if is_text(name) else ""](owner(name)[1])

        labels = sorted({param_label(n) for n, _ in named}, key=lambda lb: (lb != "base", lb))
        rank = {lb: i for i, lb in enumerate(labels)}
        order = sorted(named, key=lambda np_: (is_text(np_[0]), is_norm(np_[0]), rank[param_label(np_[0])]))
        self.param_names = [n for n, _ in order]
        with torch.no_grad():
            self.master, master_views = flat_buffer([p.detach() for _, p in order])
        # each tensor's [start, end of its padded span) in the master
        offsets = [v.storage_offset() for v in master_views] + [self.master.numel()]
        last_work = max(i for i, n in enumerate(self.param_names) if not is_norm(n))
        n_work = offsets[last_work + 1]  # the working copy covers every non-norm weight
        self._n_unet = offsets[sum(not is_text(n) for n in self.param_names)]
        self.working = self.master[:n_work].to(dtype)
        self._n_work = n_work
        # the groups' segments of the master: (label, non-norm or norm) runs
        segments = {}
        for i, (name, _) in enumerate(order):
            key = (param_label(name), is_norm(name))
            lo, hi = segments.get(key, (offsets[i], offsets[i]))
            segments[key] = (lo, offsets[i + 1])
        self._groups = []
        for lb in labels:
            slices = [slice(*segments[(lb, norm)]) for norm in (False, True) if (lb, norm) in segments]
            self._groups.append((optimizer([self.master[s] for s in slices], lb), slices))
        self.optimizers = {lb: opt for (opt, _), lb in zip(self._groups, labels)}

        def install(target, work, full, requires_grad):
            """Parameters as views of `work` / `full` (norms): every trained
            one, or with a `target` UNet the UNet's into it."""
            for i, name in enumerate(self.param_names):
                module, key = owner(name)
                if target is not None:
                    if is_text(name):
                        continue
                    module = target
                lo, n = offsets[i], order[i][1].numel()
                src = full if is_norm(name) else work
                _set_parameter(module, key, src[lo:lo + n].view(order[i][1].shape), requires_grad)

        install(None, self.working, self.master, True)
        self.params = [owner(n)[0].get_parameter(owner(n)[1]) for n in self.param_names]
        self._offsets = offsets[:-1]
        gdtype = torch.bfloat16 if cfg.grads_bf16 else torch.float32
        self._grad_flat = torch.zeros(self.master.numel(), dtype=gdtype, device=self.device)
        self._grad_views = [self._grad_flat[o:o + p.numel()].view(p.shape) for o, p in zip(offsets, self.params)]
        self.ema = None
        if cfg.ema_decay is not None:
            self.ema = self.master[:self._n_unet].clone()
            self.target_working = self.ema[:min(n_work, self._n_unet)].to(dtype)
            with torch.device("meta"):
                self.target = type(student)(student.cfg)
            install(self.target, self.target_working, self.ema, False)
            self.target.eval()

    @property
    def full_model(self) -> bool:
        return self.cfg.lora_rank is None

    @torch.no_grad()
    def _after_update(self) -> None:
        """Full model, after an optimizer update: the working copy from the
        master, then the EMA and the target's working copy from it."""
        if not self.full_model:
            return
        self.working.copy_(self.master[:self._n_work])
        if self.ema is not None:
            update_ema(self.ema, self.master[:self._n_unet], self.cfg.ema_decay)
            self.target_working.copy_(self.ema[:self.target_working.numel()])

    def state_dict_of(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Full model: the student's parameters as they lie in `flat` (the
        master or the EMA), f32, under the UNet's state-dict keys."""
        return {n: flat[o:o + p.numel()].view(p.shape)
                for n, o, p in zip(self.param_names, self._offsets, self.params) if not n.startswith(TEXT_PREFIX)}

    def text_state_dict(self) -> Dict[str, torch.Tensor]:
        """The trained text encoder's state dict in f32: its trained
        parameters from the master, the frozen ones as they are."""
        trained = {n[len(TEXT_PREFIX):]: self.master[o:o + p.numel()].view(p.shape)
                   for n, o, p in zip(self.param_names, self._offsets, self.params) if n.startswith(TEXT_PREFIX)}
        return {k: trained.get(k, v).detach().float() for k, v in self.text_encoder.state_dict().items()}

    # ------------------------------------------------------------------
    def loss_and_grads(self, batch: Dict[str, torch.Tensor], draws):
        """(loss, metrics, the gradients in the flat buffer, laid out as
        `self.params`) for a device batch with explicit draws."""
        if self.full_model:
            loss, terms = self.loss_fn(self, batch, draws)
            # a parameter the step does not reach (motion_cond_proj without the
            # motion embedding) gets a zero gradient
            grads = torch.autograd.grad(loss, self.params, allow_unused=True, materialize_grads=True)
        else:
            # merge each factor pair into its weight once for the whole step, before
            # any remat region: the student's two forwards and every recomputation
            # read the same merged weights
            with parametrize.cached():
                for m in self._lora_modules:
                    m.weight  # fills the cache
                loss, terms = self.loss_fn(self, batch, draws)
                grads = torch.autograd.grad(loss, self.params)
        torch._foreach_copy_(self._grad_views, grads)
        del grads
        return loss, {k: v.detach() for k, v in terms.items()}, self._grad_flat

    def train_step(self, batch: Dict[str, torch.Tensor], draws) -> Dict[str, torch.Tensor]:
        """One micro-step on a device batch with explicit draws; returns the
        metrics (device scalars)."""
        _, metrics, g = self.loss_and_grads(batch, draws)
        gnorm = _norm_f32(g)  # the padding is zero
        k = max(1, self.cfg.grad_accum_steps)
        if k == 1:
            scale = torch.clamp(self.cfg.max_grad_norm / (gnorm + 1e-6), max=1.0)
            self._apply(g, scale)
        else:
            self._acc = g / k if self._acc is None else self._acc.add_(g, alpha=1.0 / k)
            self._micro += 1
            if self._micro == k:
                norm = torch.linalg.vector_norm(self._acc)
                scale = torch.where(norm < self.cfg.max_grad_norm, torch.ones_like(norm),
                                    self.cfg.max_grad_norm / norm)
                self._apply(self._acc, scale)
                self._acc, self._micro = None, 0
        self.step += 1
        metrics["grad_norm"] = gnorm
        return metrics

    def _apply(self, g: torch.Tensor, scale: torch.Tensor) -> None:
        """Each group's optimizer step on its segments of g * scale, then
        (full model) the working copy, the EMA and the target."""
        for opt, slices in self._groups:
            opt.step([g[s] for s in slices], scale)
        self._after_update()

    def to_device(self, host_batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's tensors on the trainer's device (keys starting with
        "_", such as the captions, are host-only and left out)."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in host_batch.items() if not k.startswith("_")}

    def step_device(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Draw from the trainer's generator and take one micro-step on a
        device batch."""
        return self.train_step(batch, self.draws_fn(self, batch))

    def step_once(self, host_batch: Dict) -> Dict[str, torch.Tensor]:
        """Move a host batch to the device and take one micro-step."""
        return self.step_device(self.to_device(host_batch))

    # ------------------------------------------------------------------
    def _checkpoints(self):
        found = []
        for path in glob.glob(os.path.join(self.ckpt_dir, "step_*.pt")):
            m = re.fullmatch(r"step_(\d+)\.pt", os.path.basename(path))
            if m:
                found.append((int(m.group(1)), path))
        return sorted(found)

    def save(self, step: int) -> None:
        state = {"step": step, "optimizers": [opt.state_dict() for opt, _ in self._groups],
                 "accum": (self._acc, self._micro)}
        if self.full_model:
            state["master"] = self.master
            if self.ema is not None:
                state["ema"] = self.ema
        else:
            state["factors"] = {n: {k: t.detach() for k, t in f.items()} for n, f in self.factors.items()}
        path = os.path.join(self.ckpt_dir, f"step_{step:08d}.pt")
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        for _, old in self._checkpoints()[: -self.cfg.keep_checkpoints]:
            os.remove(old)

    def resume_if_available(self) -> int:
        found = self._checkpoints()
        if not found:
            return 0
        state = torch.load(found[-1][1], map_location=self.device, weights_only=False)
        with torch.no_grad():
            if self.full_model:
                self.master.copy_(state["master"])
                if self.ema is not None:
                    self.ema.copy_(state["ema"])
                    self.target_working.copy_(self.ema[:self.target_working.numel()])
                self.working.copy_(self.master[:self._n_work])
            else:
                for n, f in self.factors.items():
                    for k, t in f.items():
                        t.copy_(state["factors"][n][k])
        for (opt, _), opt_state in zip(self._groups, state["optimizers"]):
            opt.load_state_dict(opt_state)
        self._acc, self._micro = state["accum"]
        self.step = int(state["step"])
        return self.step

    def _log(self, step: int, metrics: dict, dt: float) -> dict:
        row = {"step": step, "time_per_step_s": round(dt, 4), **metrics}
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        return row

    # ------------------------------------------------------------------
    def run(self, data_iter: Iterator[dict], max_steps: Optional[int] = None,
            validation_fn: Optional[Callable] = None, validation_every: int = 500) -> dict:
        """Resume, then take micro-steps to `max_steps`, logging and
        checkpointing; a final checkpoint is written on the way out. The
        batches come through a `DevicePrefetcher` (as the JAX trainer's):
        a worker thread pulls the next two from `data_iter` and moves them
        to the device while the step runs; an exception there is raised
        here. validation_fn(step, student) runs every `validation_every`
        steps, after the step's checkpoint (training/validation.py: the
        reference's periodic validation videos); it must leave the
        trainer's generator alone, so the draws do not depend on it."""
        cfg = self.cfg
        start = self.resume_if_available()
        max_steps = max_steps or cfg.max_steps
        self.generator.manual_seed(draws_seed(cfg.seed, start))
        last_metrics, last_step = {}, start
        t_window, steps_in_window, wait_in_window = time.perf_counter(), 0, 0.0
        hb_path = os.path.join(cfg.output_dir, "heartbeat.json")
        with DevicePrefetcher(data_iter, put=self.to_device, depth=2) as prefetch, \
                Heartbeat(hb_path) as hb, GracefulShutdown() as stop:
            for step in range(start, max_steps):
                if stop.requested:
                    break
                t_wait = time.perf_counter()
                try:
                    batch = next(prefetch)
                except StopIteration:
                    break
                wait_in_window += time.perf_counter() - t_wait
                metrics = self.step_device(batch)
                last_step = step + 1
                steps_in_window += 1
                hb.update(last_step)
                if last_step % cfg.log_every == 0 or step == start:
                    metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
                    now = time.perf_counter()
                    window = now - t_window
                    metrics["data_wait_frac"] = wait_in_window / max(window, 1e-9)
                    last_metrics = self._log(last_step, metrics, window / steps_in_window)
                    t_window, steps_in_window, wait_in_window = now, 0, 0.0
                if last_step % cfg.checkpoint_every == 0:
                    self.save(last_step)
                if validation_fn is not None and last_step % validation_every == 0:
                    validation_fn(last_step, self.student)
        if last_step % cfg.checkpoint_every != 0:
            self.save(last_step)
        return last_metrics

    def export_student_params(self) -> Dict[str, torch.Tensor]:
        """Inference-ready UNet state dict: base + collapsed LoRA, or (full
        model) the f32 master."""
        if self.full_model:
            return self.state_dict_of(self.master)
        return merge_lora(base_state_dict(self.student), self.factors)
