"""LoRA on the port's UNet (port of t2v_turbo_tpu/lora.py).

The factors of a target layer with weight W (O, I, *k) are kept in the
reference's `LoraInjected*` layout (utils/lora.py:19-214), the layout of its
`unet_lora.pt`:

  down (r, I, *k)   the `lora_down` Linear / Conv2d / Conv3d weight
  up   (O, r, 1..)  the `lora_up` 1x1 weight

and the merged weight is W + scale * (up @ down) reshaped to W's shape and
cast to W's dtype: the JAX package's `merge_lora` term for term (its
factors are the same matrices transposed). Training differentiates through
the merge with respect to the factors only; the base weights are frozen.

`apply_lora` installs the merge as a parametrisation of each target's
`weight` (torch.nn.utils.parametrize), so every read of `module.weight`
(including a remat recomputation in the backward) sees the merged weight
of the current factors. `merge_lora` returns merged state-dict entries for
inference (the collapse).

Targets: every Linear, Conv2d and Conv3d of the UNet, the classes the
reference's `inject_trainable_lora_extended` searches; the Conv1d
projections of `init_attn` are not among them. `io/lora_import.py` orders
them as the reference's `unet_lora.pt` does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

Factors = Dict[str, Dict[str, torch.Tensor]]
TARGET_CLASSES = (nn.Linear, nn.Conv2d, nn.Conv3d)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 64


def lora_targets(model: nn.Module) -> Dict[str, nn.Module]:
    """Every Linear, Conv2d and Conv3d of `model`, by module name."""
    return {name: m for name, m in model.named_modules() if isinstance(m, TARGET_CLASSES)}


def target_shapes(model: nn.Module) -> Dict[str, torch.Size]:
    """Each target's (base) weight shape."""
    return {name: _base_weight(m).shape for name, m in lora_targets(model).items()}


def init_lora(model: nn.Module, cfg: LoRAConfig, generator: torch.Generator) -> Factors:
    """Fresh factors for every target: down ~ N(0, 1) / r, up = 0, f32
    (reference utils/lora.py:42-49). Drawn on the CPU from `generator`, then
    moved to each weight's device, so any device gets the same values."""
    factors: Factors = {}
    for name, m in lora_targets(model).items():
        shape = tuple(_base_weight(m).shape)
        down = torch.randn((cfg.rank,) + shape[1:], generator=generator) / cfg.rank
        up = torch.zeros((shape[0], cfg.rank) + (1,) * (len(shape) - 2))
        device = _base_weight(m).device
        factors[name] = {"down": down.to(device), "up": up.to(device)}
    return factors


def lora_delta(down: torch.Tensor, up: torch.Tensor, scale: float, like: torch.Tensor):
    """scale * (up @ down) in f32, reshaped to `like`'s shape and cast to its dtype."""
    return (torch.mm(up.flatten(1), down.flatten(1)) * scale).reshape(like.shape).to(like.dtype)


class LoRAWeight(nn.Module):
    """Parametrisation W -> W + scale * (up @ down) holding the factors."""

    def __init__(self, down: torch.Tensor, up: torch.Tensor, scale: float):
        super().__init__()
        self.down = nn.Parameter(down)
        self.up = nn.Parameter(up)
        self.scale = scale

    def forward(self, w):
        return w + lora_delta(self.down, self.up, self.scale, w)


def _base_weight(m: nn.Module) -> torch.Tensor:
    if parametrize.is_parametrized(m, "weight"):
        return m.parametrizations.weight.original
    return m.weight


def apply_lora(model: nn.Module, factors: Factors, scale: float = 1.0) -> nn.Module:
    """Freeze `model` and install `factors` (trainable, f32) as weight
    parametrisations. Cast the model's dtype before this, never after."""
    model.requires_grad_(False)
    modules = dict(model.named_modules())
    for name, fac in factors.items():
        parametrize.register_parametrization(
            modules[name], "weight", LoRAWeight(fac["down"], fac["up"], scale), unsafe=True
        )
    return model


def lora_factors(model: nn.Module) -> Factors:
    """The installed factors (live parameters), by module name."""
    out: Factors = {}
    for name, m in model.named_modules():
        if parametrize.is_parametrized(m, "weight"):
            p = m.parametrizations.weight[0]
            out[name] = {"down": p.down, "up": p.up}
    return out


def base_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with each parametrised weight's base under its
    own key (the frozen weights, as if no LoRA were installed)."""
    out = {}
    for k, v in model.state_dict().items():
        if ".parametrizations.weight." in k:
            if not k.endswith(".parametrizations.weight.original"):
                continue
            k = k.replace(".parametrizations.weight.original", ".weight")
        out[k] = v
    return out


@torch.no_grad()
def merge_lora(state_dict: Dict[str, torch.Tensor], factors: Factors, scale: float = 1.0):
    """W + scale * (up @ down) for every factored weight of a (base) state
    dict; the other entries are returned as they are."""
    out = dict(state_dict)
    for name, fac in factors.items():
        w = state_dict[f"{name}.weight"]
        out[f"{name}.weight"] = w + lora_delta(fac["down"].to(w.device), fac["up"].to(w.device),
                                               scale, w)
    return out


def count_lora_params(factors: Factors) -> int:
    return sum(t.numel() for fac in factors.values() for t in fac.values())


def save_lora_npz(path: str, factors: Factors) -> None:
    """Write factors in the JAX trainer's `unet_lora.npz` layout
    ("params/<flax path>/kernel::down" / "::up", JAX factor shapes), which
    the JAX package's `load_lora_npz` reads too."""
    import numpy as np

    from .io.convert import lora_to_jax

    arrs = {}
    for key, fac in lora_to_jax(factors).items():
        joined = "/".join(key)
        arrs[f"{joined}::down"] = fac["down"]
        arrs[f"{joined}::up"] = fac["up"]
    np.savez(path, **arrs)


def load_lora_npz(path: str, model: nn.Module) -> Factors:
    """Read a `unet_lora.npz` (either package's) into factors for `model`'s
    targets (used for their weight shapes)."""
    import numpy as np

    from .io.convert import lora_from_jax

    data = np.load(path)
    flat: Dict[tuple, Dict[str, np.ndarray]] = {}
    for key in data.files:
        joined, kind = key.rsplit("::", 1)
        flat.setdefault(tuple(joined.split("/")), {})[kind] = data[key]
    return lora_from_jax(flat, target_shapes(model))
