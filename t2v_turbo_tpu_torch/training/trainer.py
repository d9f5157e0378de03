"""The v1 LoRA LCD trainer on one device (port of
t2v_turbo_tpu/training/trainer.py without the mesh, FSDP, tensor
parallelism, the split step, EMA and multi-host).

- State: the student's LoRA factors (f32, installed on the frozen student
  by `lora.apply_lora`), the optimizer's moments and the step count. The
  factors live in one flat buffer (`optim.flat_buffer`), so the gradient
  norm, the clip and the optimizer run on it in a few launches.
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
- Metrics: one JSON row per logged step in output_dir/metrics.jsonl with
  time_per_step_s, the losses (with reward feedback, reward_loss and
  video_rm_loss too), grad_norm and data_wait_frac (the share of
  the window the host waited for the next batch); a heartbeat file and
  SIGTERM/SIGINT handling (training/watchdog.py) as in the JAX trainer.
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

from ..lora import LoRAConfig, apply_lora, base_state_dict, init_lora, lora_factors, merge_lora
from .lcd import LCDConfig, lcd_loss, sample_draws
from .optim import flat_buffer
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
    lora_rank: int = 64
    grad_accum_steps: int = 1


def draws_seed(seed: int, step: int) -> int:
    """The draws' generator seed for a run (re)starting at `step`."""
    return ((seed + 1) * 1_000_003 + step) % (2**63 - 1)


class LCDTrainer:
    def __init__(self, *, student, teacher, sched, solver, lcd_cfg: LCDConfig,
                 optimizer: Callable[[List[torch.Tensor]], object], cfg: TrainerConfig,
                 reward_fn: Optional[Callable] = None, video_reward_fn: Optional[Callable] = None):
        """student: the UNet to distil into (its weights are frozen and get
        LoRA factors); teacher: the frozen UNet; optimizer: params ->
        optimizer (e.g. functools.partial(optim.make_optimizer, name=...));
        reward_fn / video_reward_fn: the reward feedback terms
        (training/reward_adapters.py), whose models must be frozen: only the
        LoRA factors get gradients."""
        self.cfg, self.lcd_cfg = cfg, lcd_cfg
        self.reward_fn, self.video_reward_fn = reward_fn, video_reward_fn
        self.device = next(student.parameters()).device
        self.sched, self.solver = sched.to(self.device), solver.to(self.device)
        self.student, self.teacher = student, teacher.requires_grad_(False)
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
        self._grad_flat, self._grad_views = flat_buffer([torch.zeros_like(p) for p in self.params])
        self.optimizer = optimizer([self.flat])
        self.step = 0
        self._acc: Optional[torch.Tensor] = None  # mean of the micro-step grads
        self._micro = 0
        self.generator = torch.Generator().manual_seed(draws_seed(cfg.seed, 0))
        self.ckpt_dir = os.path.join(cfg.output_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._metrics_path = os.path.join(cfg.output_dir, "metrics.jsonl")

    # ------------------------------------------------------------------
    def loss_and_grads(self, batch: Dict[str, torch.Tensor], draws):
        """(loss, metrics, the factors' gradients in the flat f32 buffer,
        laid out as `self.params`) for a device batch with explicit draws."""
        # merge each factor pair into its weight once for the whole step, before
        # any remat region: the student's two forwards and every recomputation
        # read the same merged weights
        with parametrize.cached():
            for m in self._lora_modules:
                m.weight  # fills the cache
            loss, terms = lcd_loss(self.student, self.teacher, batch, draws, sched=self.sched,
                                   solver=self.solver, cfg=self.lcd_cfg, reward_fn=self.reward_fn,
                                   video_reward_fn=self.video_reward_fn)
            grads = torch.autograd.grad(loss, self.params)
        torch._foreach_copy_(self._grad_views, grads)
        return loss, {k: v.detach() for k, v in terms.items()}, self._grad_flat

    def train_step(self, batch: Dict[str, torch.Tensor], draws) -> Dict[str, torch.Tensor]:
        """One micro-step on a device batch with explicit draws; returns the
        metrics (device scalars)."""
        _, metrics, g = self.loss_and_grads(batch, draws)
        gnorm = torch.linalg.vector_norm(g)  # f32; the padding is zero
        k = max(1, self.cfg.grad_accum_steps)
        if k == 1:
            scale = torch.clamp(self.cfg.max_grad_norm / (gnorm + 1e-6), max=1.0)
            self.optimizer.step([g * scale])
        else:
            self._acc = g / k if self._acc is None else self._acc.add_(g, alpha=1.0 / k)
            self._micro += 1
            if self._micro == k:
                norm = torch.linalg.vector_norm(self._acc)
                scale = torch.where(norm < self.cfg.max_grad_norm, torch.ones_like(norm),
                                    self.cfg.max_grad_norm / norm)
                self.optimizer.step([self._acc * scale])
                self._acc, self._micro = None, 0
        self.step += 1
        metrics["grad_norm"] = gnorm
        return metrics

    def step_once(self, host_batch: Dict) -> Dict[str, torch.Tensor]:
        """Move a host batch to the device, draw from the trainer's
        generator and take one micro-step."""
        batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                 for k, v in host_batch.items() if not k.startswith("_")}
        draws = sample_draws(self.lcd_cfg, batch["latents"].shape, self.generator)
        return self.train_step(batch, draws)

    # ------------------------------------------------------------------
    def _checkpoints(self):
        found = []
        for path in glob.glob(os.path.join(self.ckpt_dir, "step_*.pt")):
            m = re.fullmatch(r"step_(\d+)\.pt", os.path.basename(path))
            if m:
                found.append((int(m.group(1)), path))
        return sorted(found)

    def save(self, step: int) -> None:
        state = {
            "step": step,
            "factors": {n: {k: t.detach() for k, t in f.items()} for n, f in self.factors.items()},
            "optimizer": self.optimizer.state_dict(),
            "accum": (self._acc, self._micro),
        }
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
            for n, f in self.factors.items():
                for k, t in f.items():
                    t.copy_(state["factors"][n][k])
        self.optimizer.load_state_dict(state["optimizer"])
        self._acc, self._micro = state["accum"]
        self.step = int(state["step"])
        return self.step

    def _log(self, step: int, metrics: dict, dt: float) -> dict:
        row = {"step": step, "time_per_step_s": round(dt, 4), **metrics}
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        return row

    # ------------------------------------------------------------------
    def run(self, data_iter: Iterator[dict], max_steps: Optional[int] = None) -> dict:
        """Resume, then take micro-steps to `max_steps`, logging and
        checkpointing; a final checkpoint is written on the way out."""
        cfg = self.cfg
        start = self.resume_if_available()
        max_steps = max_steps or cfg.max_steps
        self.generator.manual_seed(draws_seed(cfg.seed, start))
        last_metrics, last_step = {}, start
        t_window, steps_in_window, wait_in_window = time.perf_counter(), 0, 0.0
        hb_path = os.path.join(cfg.output_dir, "heartbeat.json")
        with Heartbeat(hb_path) as hb, GracefulShutdown() as stop:
            for step in range(start, max_steps):
                if stop.requested:
                    break
                t_wait = time.perf_counter()
                try:
                    host_batch = next(data_iter)
                except StopIteration:
                    break
                wait_in_window += time.perf_counter() - t_wait
                metrics = self.step_once(host_batch)
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
        if last_step % cfg.checkpoint_every != 0:
            self.save(last_step)
        return last_metrics

    def export_student_params(self) -> Dict[str, torch.Tensor]:
        """Inference-ready UNet state dict: base + collapsed LoRA."""
        return merge_lora(base_state_dict(self.student), self.factors)
