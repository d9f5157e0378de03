"""The LCD trainer (port of t2v_turbo_tpu/training/trainer.py without tensor
parallelism and the split step), on one device or on one rank of a (data,
seq) mesh, in two modes that share the step's clip and accumulation, `run`,
the prefetcher, the checkpoints, the watchdog and the metrics:

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
- The mesh (`mesh=`, parallel/mesh.py; JAX shards the batch B -> data and
  T -> seq, trainer.py:9-10): each rank holds its (B / data, T / seq)
  block (`to_device` keeps its seq frames, parallel/multihost.py), and the
  student, teacher and target run their temporal layers over the seq
  group. Every rank draws the global draws from the generator and keeps
  its block, so a sharded step draws the single-process numbers. The loss
  hooks scale each rank's loss so that the world's sum of the gradients is
  the global batch's (training/lcd.py), and the flat gradient is summed
  over every rank (`collectives.all_reduce_`) before the norm and the
  clip; the metrics are the world's sums. With `TrainerConfig.fsdp`
  (parallel/fsdp.py, JAX trainer.py:243-300) each data rank keeps only its
  slices of the f32 master (LoRA: of the factors), the moments, the EMA
  and the reduced gradient (a reduce-scatter over the data ranks, after a
  sum over the seq ranks); the working copy, the live norm affines and
  the target's copy are all-gathered after each update. Rank 0 writes the
  checkpoints, in the one-process format (the sharded state gathered
  first), the metrics and the heartbeat; every rank resumes by reading the
  file and keeping its slice, so a checkpoint crosses world sizes. The
  ranks agree on a stop (SIGTERM to any of them) with one all-reduce a
  step, so they stop at the same step.
- Metrics: one JSON row per logged step in output_dir/metrics.jsonl with
  time_per_step_s, the losses (with reward feedback, reward_loss and
  video_rm_loss too), grad_norm and data_wait_frac (the share of
  the window the host waited for the next batch); a heartbeat file and
  SIGTERM/SIGINT handling (training/watchdog.py) as in the JAX trainer;
  periodic validation videos through `run`'s validation_fn.
"""

from __future__ import annotations

import contextlib
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
from ..parallel.tp import TRAINING_HALF, is_sharded, refuse_model_axis
from .ema import update_ema
from .lcd import LCDConfig, lcd_loss, sample_draws
from .optim import TEXT_PREFIX, flat_buffer, square_sum_f32
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
    fsdp: bool = False  # shard the optimizer state over the mesh's data axis (parallel/fsdp.py)


def draws_seed(seed: int, step: int) -> int:
    """The draws' generator seed for a run (re)starting at `step`."""
    return ((seed + 1) * 1_000_003 + step) % (2**63 - 1)


def v1_loss(trainer: "LCDTrainer", batch, draws):
    """The v1 LCD loss of the trainer's student and teacher (this rank's
    share of it under a mesh)."""
    return lcd_loss(trainer.student, trainer.teacher, batch, draws, sched=trainer.sched, solver=trainer.solver,
                    cfg=trainer.lcd_cfg, reward_fn=trainer.reward_fn, video_reward_fn=trainer.video_reward_fn,
                    mesh=trainer.mesh)


def v1_draws(trainer: "LCDTrainer", batch):
    """The v1 step's draws from the trainer's generator: the global batch's,
    this rank's block kept."""
    draws = sample_draws(trainer.lcd_cfg, trainer.global_shape(batch["latents"].shape), trainer.generator)
    return draws if trainer.mesh is None else draws.shard(trainer.mesh)


def _norm_f32(g: torch.Tensor) -> torch.Tensor:
    """The 2-norm of a flat gradient, in f32 (on the card one `vector_norm`)."""
    if g.is_cuda:
        return torch.linalg.vector_norm(g, dtype=torch.float32)
    return torch.sqrt(square_sum_f32(g))


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
                 text_encoder: Optional[torch.nn.Module] = None, mesh=None):
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
        LCD loss and draws). mesh: this rank's (data, seq) mesh
        (parallel/mesh.py); a mesh of one rank is the single-device path."""
        refuse_model_axis(mesh, "LCDTrainer")
        if any(m is not None and is_sharded(m) for m in (student, teacher)):
            raise NotImplementedError(f"LCDTrainer: a UNet split over the model axis (parallel/tp.py) is not "
                                      f"trained yet: that is {TRAINING_HALF}")
        self.cfg, self.lcd_cfg = cfg, lcd_cfg
        self.reward_fn, self.video_reward_fn = reward_fn, video_reward_fn
        self.loss_fn, self.draws_fn = loss_fn, draws_fn
        self.device = next(student.parameters()).device
        self.sched, self.solver = sched.to(self.device), solver.to(self.device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.is_main = mesh is None or mesh.rank == 0
        self._shards = None  # parallel.fsdp.FlatShards with cfg.fsdp over more than one data rank
        self._fsdp = cfg.fsdp and self.mesh is not None and self.mesh.data > 1
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
        # with fsdp: this rank's slices of the reduced gradient
        self._grad_shard = None if self._shards is None else torch.empty(
            self._shards.size, dtype=self._grad_flat.dtype, device=self.device)
        if self.mesh is not None:
            for m in (self.student, self.teacher, self.target):
                if m is not None and hasattr(m, "set_seq_group"):
                    m.set_seq_group(self.mesh.axis("seq"))
        self.step = 0
        self._acc: Optional[torch.Tensor] = None  # mean of the micro-step grads (this rank's slices with fsdp)
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
        segments = [(0, self.flat.numel())]
        self._state = self._shard(self.flat, segments)  # the f32 buffer the optimizer steps on
        self.optimizer = optimizer([self._state[self._slice(0)]])
        self._groups = [(self.optimizer, [self._slice(0)])]
        self._group_segs = [[0]]
        # where each segment's values live between updates (gathered after each with fsdp)
        self._live = [self.flat[lo:hi] for lo, hi in segments]

    def _shard(self, full: torch.Tensor, segments) -> torch.Tensor:
        """The optimizer-state buffer over `segments` of the f32 `full`: full
        itself, or with fsdp this rank's slices of it (`parallel.fsdp`)."""
        self._segments = list(segments)
        if not self._fsdp:
            return full
        from ..parallel.fsdp import FlatShards

        self._shards = FlatShards(self._segments, self.mesh.axis("data"))
        return self._shards.take(full)

    def _slice(self, k: int) -> slice:
        """Segment k in the optimizer-state buffer's coordinates."""
        if self._shards is not None:
            return self._shards.local[k]
        return slice(*self._segments[k])

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
            master, master_views = flat_buffer([p.detach() for _, p in order])
        # each tensor's [start, end of its padded span) in the master
        offsets = [v.storage_offset() for v in master_views] + [master.numel()]
        last_work = max(i for i, n in enumerate(self.param_names) if not is_norm(n))
        n_work = offsets[last_work + 1]  # the working copy covers every non-norm weight
        self._n_unet = offsets[sum(not is_text(n) for n in self.param_names)]
        self.working = master[:n_work].to(dtype)
        self._n_work = n_work
        # the segments of the master: (text or UNet, label, non-norm or norm) runs, in order
        spans = {}
        for i, (name, _) in enumerate(order):
            key = (is_text(name), param_label(name), is_norm(name))
            lo, hi = spans.get(key, (offsets[i], offsets[i]))
            spans[key] = (lo, offsets[i + 1])
        keys = sorted(spans, key=lambda k: spans[k])
        seg_norm = [key[2] for key in keys]
        self.master = self._state = self._shard(master, [spans[key] for key in keys])
        self._groups, self._group_segs = [], []
        for lb in labels:
            ks = [k for k, key in enumerate(keys) if key[1] == lb]
            self._groups.append((optimizer([self.master[self._slice(k)] for k in ks], lb), [self._slice(k) for k in ks]))
            self._group_segs.append(ks)
        self.optimizers = {lb: opt for (opt, _), lb in zip(self._groups, labels)}
        # each segment's live values: the working copy's span, or (norms) the
        # master's own (with fsdp a whole copy of it, gathered after each update)
        self._live = [master[lo:hi] if norm and not self._fsdp else master[lo:hi].clone() if norm else
                      self.working[lo:hi] for (lo, hi), norm in zip(self._segments, seg_norm)]

        def live_view(lo, n, live):
            k = next(k for k, (a, b) in enumerate(self._segments) if a <= lo < b)
            a = self._segments[k][0]
            return live[k][lo - a:lo - a + n]

        def install(target, live, requires_grad):
            """Parameters as views of the segments' `live` values: every
            trained one, or with a `target` UNet the UNet's into it."""
            for i, name in enumerate(self.param_names):
                module, key = owner(name)
                if target is not None:
                    if is_text(name):
                        continue
                    module = target
                view = live_view(offsets[i], order[i][1].numel(), live).view(order[i][1].shape)
                _set_parameter(module, key, view, requires_grad)

        install(None, self._live, True)
        self.params = [owner(n)[0].get_parameter(owner(n)[1]) for n in self.param_names]
        self._offsets = offsets[:-1]
        gdtype = torch.bfloat16 if cfg.grads_bf16 else torch.float32
        self._grad_flat = torch.zeros(master.numel(), dtype=gdtype, device=self.device)
        self._grad_views = [self._grad_flat[o:o + p.numel()].view(p.shape) for o, p in zip(offsets, self.params)]
        self.ema = None
        if cfg.ema_decay is not None:
            self._n_unet_segs = sum(hi <= self._n_unet for _, hi in self._segments)
            self.ema = self.master[:self._state_end(self._n_unet_segs)].clone()
            # (on the CPU `to` returns the f32 EMA itself: the target's weights are its views)
            self.target_working = (master[:min(n_work, self._n_unet)].to(dtype, copy=True) if self._fsdp else
                                   self.ema[:min(n_work, self._n_unet)].to(dtype))
            # the target's live values: the EMA's own span for a norm (with fsdp a
            # whole copy, gathered after each update), else the target's working copy
            self._target_live = [(master[lo:hi].clone() if self._fsdp else self.ema[lo:hi]) if norm else
                                 self.target_working[lo:hi]
                                 for (lo, hi), norm in zip(self._segments[:self._n_unet_segs], seg_norm)]
            with torch.device("meta"):
                self.target = type(student)(student.cfg)
            install(self.target, self._target_live, False)
            self.target.eval()
        del master

    def _state_end(self, n_segments: int) -> int:
        """The end of the first `n_segments` segments in the state buffer."""
        return self._slice(n_segments - 1).stop if n_segments else 0

    @property
    def full_model(self) -> bool:
        return self.cfg.lora_rank is None

    def global_shape(self, shape) -> tuple:
        """The global batch's shape of this rank's (B, T, ...) block."""
        shape = tuple(shape)
        if self.mesh is None:
            return shape
        return (shape[0] * self.mesh.data, shape[1] * self.mesh.seq) + shape[2:]

    @torch.no_grad()
    def _after_update(self) -> None:
        """After an optimizer update: the live values from the state (the
        working copy from the master; with fsdp every rank's slices
        gathered), then the EMA and the target's copy from it."""
        if self._shards is not None:
            self._gather_live(self._state, self._live)
        elif self.full_model:
            self.working.copy_(self.master[:self._n_work])
        if self.full_model and self.ema is not None:
            update_ema(self.ema, self.master[:self.ema.numel()], self.cfg.ema_decay)
            self._refresh_target()

    def _gather_live(self, state: torch.Tensor, live: List[torch.Tensor]) -> None:
        for k, dst in enumerate(live):
            dst.copy_(self._shards.gather(state, k, dst.dtype))

    def _refresh_target(self) -> None:
        if self._shards is not None:
            self._gather_live(self.ema, self._target_live)
        else:
            self.target_working.copy_(self.ema[:self.target_working.numel()])

    def _whole(self, state: torch.Tensor, n_segments: Optional[int] = None) -> torch.Tensor:
        """A state buffer (the master, the EMA, the accumulated gradient)
        whole, over its first `n_segments` segments: itself, or with fsdp
        every rank's slices gathered onto the host (a collective: every rank
        calls it)."""
        if self._shards is None:
            return state
        n_segments = len(self._segments) if n_segments is None else n_segments
        out = torch.zeros(self._segments[n_segments - 1][1], dtype=state.dtype)
        for k in range(n_segments):
            lo, hi = self._segments[k]
            out[lo:hi] = self._shards.gather(state, k, to_host=True)
        return out

    def _mine(self, whole: torch.Tensor, n_segments: Optional[int] = None) -> torch.Tensor:
        """This rank's part of a whole state buffer (the inverse of `_whole`)."""
        if self._shards is None:
            return whole
        n_segments = len(self._segments) if n_segments is None else n_segments
        return torch.cat([whole[slice(*self._shards.mine[k])] for k in range(n_segments)])

    def state_dict_of(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Full model: the student's parameters as they lie in `flat` (the
        whole master or EMA, `whole_master()` / `whole_ema()` with fsdp),
        f32, under the UNet's state-dict keys."""
        return {n: flat[o:o + p.numel()].view(p.shape)
                for n, o, p in zip(self.param_names, self._offsets, self.params) if not n.startswith(TEXT_PREFIX)}

    def whole_master(self) -> torch.Tensor:
        """The f32 master, whole (gathered with fsdp: a collective)."""
        return self._whole(self.master)

    def whole_ema(self) -> torch.Tensor:
        """The f32 EMA, whole (gathered with fsdp: a collective)."""
        return self._whole(self.ema, self._n_unet_segs)

    def text_state_dict(self) -> Dict[str, torch.Tensor]:
        """The trained text encoder's state dict in f32: its trained
        parameters from the master, the frozen ones as they are (with fsdp
        a collective)."""
        master = self.whole_master()
        trained = {n[len(TEXT_PREFIX):]: master[o:o + p.numel()].view(p.shape)
                   for n, o, p in zip(self.param_names, self._offsets, self.params) if n.startswith(TEXT_PREFIX)}
        return {k: trained.get(k, v).detach().float() for k, v in self.text_encoder.state_dict().items()}

    # ------------------------------------------------------------------
    def loss_and_grads(self, batch: Dict[str, torch.Tensor], draws):
        """(loss, metrics, the gradient) for a device batch with explicit
        draws. The gradient is the flat buffer laid out as `self.params`,
        summed over the mesh's ranks (with fsdp: this rank's slices of the
        sum); the loss and the metrics are the world's sums."""
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
        metrics = {k: v.detach() for k, v in terms.items()}
        if self.mesh is None:
            return loss, metrics, self._grad_flat
        from ..parallel import collectives

        names = sorted(metrics)
        sums = collectives.all_reduce_(torch.stack([metrics[k].float() for k in names]), self.mesh.axis("world"))
        metrics = dict(zip(names, sums.unbind()))
        if self._shards is None:
            return metrics["loss"], metrics, collectives.all_reduce_(self._grad_flat, self.mesh.axis("world"))
        collectives.all_reduce_(self._grad_flat, self.mesh.axis("seq"))
        return metrics["loss"], metrics, self._shards.reduce_scatter(self._grad_flat, self._grad_shard)

    def _grad_norm(self, g: torch.Tensor) -> torch.Tensor:
        """The global gradient's 2-norm in f32 (with fsdp: from this rank's
        slices, the squared norms summed over the data ranks)."""
        if self._shards is None:
            return _norm_f32(g)
        return torch.sqrt(self._shards.square_norm(g))

    def train_step(self, batch: Dict[str, torch.Tensor], draws) -> Dict[str, torch.Tensor]:
        """One micro-step on a device batch with explicit draws (this rank's
        block of them under a mesh); returns the metrics (device scalars)."""
        _, metrics, g = self.loss_and_grads(batch, draws)
        gnorm = self._grad_norm(g)  # the padding is zero
        k = max(1, self.cfg.grad_accum_steps)
        if k == 1:
            scale = torch.clamp(self.cfg.max_grad_norm / (gnorm + 1e-6), max=1.0)
            self._apply(g, scale)
        else:
            self._acc = g / k if self._acc is None else self._acc.add_(g, alpha=1.0 / k)
            self._micro += 1
            if self._micro == k:
                norm = self._grad_norm(self._acc)
                scale = torch.where(norm < self.cfg.max_grad_norm, torch.ones_like(norm),
                                    self.cfg.max_grad_norm / norm)
                self._apply(self._acc, scale)
                self._acc, self._micro = None, 0
        self.step += 1
        metrics["grad_norm"] = gnorm
        return metrics

    def _apply(self, g: torch.Tensor, scale: torch.Tensor) -> None:
        """Each group's optimizer step on its segments of g * scale, then the
        live values, the EMA and the target."""
        for opt, slices in self._groups:
            opt.step([g[s] for s in slices], scale)
        self._after_update()

    def to_device(self, host_batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's tensors on the trainer's device (keys starting with
        "_", such as the captions, are host-only and left out); under a mesh
        `host_batch` holds this rank's data rows, of which (B, T, ...)
        tensors keep the frames of its seq index."""
        if self.mesh is not None:
            from ..parallel.multihost import host_local_batch_to_global

            return host_local_batch_to_global(self.mesh, host_batch)
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

    def _optimizer_states(self) -> List[dict]:
        """Each group's optimizer state in the one-process layout (with fsdp
        every rank's slices of the moments gathered: a collective)."""
        states = []
        for (opt, _), segs in zip(self._groups, self._group_segs):
            state = opt.state_dict()
            if self._shards is not None:
                unit = opt.row_elements
                for key in ("mu", "nu"):
                    state[key] = [tuple(self._shards.gather_rows(t, k, unit).cpu() for t in m)
                                  if isinstance(m, tuple) else self._shards.gather_rows(m, k, unit).cpu()
                                  for m, k in zip(state[key], segs)]
            states.append(state)
        return states

    def save(self, step: int) -> None:
        """Rank 0 writes output_dir/checkpoints/step_<step>.pt in the
        one-process format; with fsdp every rank must call it (the sharded
        state is gathered first)."""
        if self._shards is None and not self.is_main:
            return
        state = {"step": step, "optimizers": self._optimizer_states(),
                 "accum": (None if self._acc is None else self._whole(self._acc), self._micro)}
        if self.full_model:
            state["master"] = self.whole_master()
            if self.ema is not None:
                state["ema"] = self.whole_ema()
        else:
            state["factors"] = {n: {k: t.detach() for k, t in f.items()} for n, f in self.factors.items()}
        if not self.is_main:
            return
        path = os.path.join(self.ckpt_dir, f"step_{step:08d}.pt")
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        for _, old in self._checkpoints()[: -self.cfg.keep_checkpoints]:
            os.remove(old)

    def resume_if_available(self) -> int:
        """Load the newest checkpoint (every rank reads the one file and keeps
        its slices); the step it was saved at, or 0."""
        found = self._checkpoints()
        if not found:
            return 0
        state = torch.load(found[-1][1], map_location="cpu" if self._shards is not None else self.device,
                           weights_only=False)
        with torch.no_grad():
            if self.full_model:
                self.master.copy_(self._mine(state["master"]))
                if self.ema is not None:
                    self.ema.copy_(self._mine(state["ema"], self._n_unet_segs))
            else:
                for n, f in self.factors.items():
                    for k, t in f.items():
                        t.copy_(state["factors"][n][k])
                if self._shards is not None:
                    self._state.copy_(self._shards.take(self.flat))
            if self._shards is not None and self.full_model:
                self._gather_live(self.master, self._live)
                if self.ema is not None:
                    self._refresh_target()
            elif self.full_model:
                self.working.copy_(self.master[:self._n_work])
                if self.ema is not None:
                    self._refresh_target()
        for (opt, _), segs, opt_state in zip(self._groups, self._group_segs, state["optimizers"]):
            if self._shards is not None:
                unit = opt.row_elements
                opt_state = dict(opt_state)
                for key in ("mu", "nu"):
                    opt_state[key] = [tuple(self._shards.take_rows(t, k, unit) for t in m) if isinstance(m, tuple)
                                      else self._shards.take_rows(m, k, unit) for m, k in zip(opt_state[key], segs)]
            opt.load_state_dict(opt_state)
        acc, self._micro = state["accum"]
        self._acc = None if acc is None else self._mine(acc).to(self.device)
        self.step = int(state["step"])
        return self.step

    def _log(self, step: int, metrics: dict, dt: float) -> dict:
        row = {"step": step, "time_per_step_s": round(dt, 4), **metrics}
        if self.is_main:
            with open(self._metrics_path, "a") as f:
                f.write(json.dumps(row) + "\n")
        return row

    def _stop_agreed(self, requested: bool) -> bool:
        """Whether any rank was asked to stop (one all-reduce of the flag over
        the world, every step), so every rank stops at the same step."""
        if self.mesh is None:
            return requested
        from ..parallel import collectives

        flag = torch.tensor([float(requested)], device=self.device)
        return bool(collectives.all_reduce_(flag, self.mesh.axis("world"))[0] > 0)

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
        trainer's generator alone, so the draws do not depend on it. Under
        a mesh every rank runs this loop (the validation render too: the
        UNet's seq layers are collective); rank 0 writes."""
        cfg = self.cfg
        start = self.resume_if_available()
        max_steps = max_steps or cfg.max_steps
        self.generator.manual_seed(draws_seed(cfg.seed, start))
        last_metrics, last_step = {}, start
        t_window, steps_in_window, wait_in_window = time.perf_counter(), 0, 0.0
        hb_path = os.path.join(cfg.output_dir, "heartbeat.json")
        beat = Heartbeat(hb_path) if self.is_main else contextlib.nullcontext()
        with DevicePrefetcher(data_iter, put=self.to_device, depth=2) as prefetch, \
                beat as hb, GracefulShutdown() as stop:
            for step in range(start, max_steps):
                if self._stop_agreed(stop.requested):
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
                if hb is not None:
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
        model) the f32 master (with fsdp a collective)."""
        if self.full_model:
            return self.state_dict_of(self.whole_master())
        return merge_lora(base_state_dict(self.student), self.factors)

    def export_target_params(self) -> Dict[str, torch.Tensor]:
        """Full model with an EMA: the target network's f32 state dict (with
        fsdp a collective)."""
        return self.state_dict_of(self.whole_ema())
