"""GroupNorm and LayerNorm (optionally + SiLU): plain PyTorch and the CUDA kernels.

Semantics are the JAX package's (`t2v_turbo_tpu/ops/norms.py`, the reference
GroupNorm32): f32 statistics, the mean first and then the centred variance,
the affine in f32, the optional activation, and the result cast back to the
input dtype.

Layout: `group_norm` takes channels-first tensors (N, C, *spatial), the
layout the port's models run in; statistics are per (sample, group) over
(C/G, *spatial). The TemporalTransformer and TemporalConvBlock pass the whole
clip (B, C, T, H, W), so their statistics span all frames; the per-frame
call sites pass (B*T, C, H, W). `layer_norm` normalises the last axis.

Dispatch: `group_norm` / `layer_norm` call the hand-written kernels
(`csrc/norms.cu`) through `fused_group_norm` / `fused_layer_norm`. Those
wrappers run the plain version only for a tensor on the CPU; a CUDA tensor
goes to the kernel, or the wrapper raises. Each wrapper counts its kernel
launches in its `launches` attribute.

Gradients: when an input needs one, a CUDA call goes through an
`autograd.Function` whose forward is the kernel and whose backward
differentiates the plain version on the saved (x, weight, bias), as the JAX
package's `_gn_bwd` / `_ln_bwd` do (t2v_turbo_tpu/ops/fused_norms.py); the
TPU has no backward kernel for the norms either.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_lib


def apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return y
    if act == "silu":
        return F.silu(y)
    raise ValueError(f"unsupported fused activation: {act}")


def _act_code(act: Optional[str]) -> int:
    if act not in (None, "silu"):
        raise ValueError(f"unsupported fused activation: {act}")
    return 1 if act == "silu" else 0


def group_stats(x, num_groups, eps):
    """Per-(sample, group) f32 mean and rstd of (N, C, *spatial), each (N, G, 1)."""
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    xf = x.float().reshape(n, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return mean, torch.rsqrt(var + eps)


def group_norm_f32(x, weight, bias, num_groups=32, eps=1e-5):
    """GroupNorm with its affine on (N, C, *spatial), left in f32."""
    n, c = x.shape[:2]
    mean, rstd = group_stats(x, num_groups, eps)
    xf = ((x.float().reshape(n, num_groups, -1) - mean) * rstd).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return xf * weight.float().reshape(shape) + bias.float().reshape(shape)


def group_norm_plain(x, weight, bias, num_groups=32, eps=1e-5, act=None):
    """Plain GroupNorm(+act) on (N, C, *spatial); the kernel's oracle."""
    return apply_act(group_norm_f32(x, weight, bias, num_groups, eps), act).to(x.dtype)


def layer_norm_plain(x, weight, bias, eps=1e-5, act=None):
    """Plain LayerNorm(+act) over the last axis; the kernel's oracle."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return apply_act(y, act).to(x.dtype)


def _affine(t: torch.Tensor, c: int, device) -> torch.Tensor:
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if t.shape != (c,):
        raise ValueError(f"affine parameter of shape {tuple(t.shape)}, expected ({c},)")
    return t


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.dtype not in cuda_lib.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} is not supported by the kernel")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel needs a contiguous tensor")


def _plain_vjp(plain, ctx, dy):
    """Gradients of `plain(x, weight, bias, *ctx.cfg)` at the saved inputs."""
    needs = ctx.needs_input_grad[:3]
    inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
    with torch.enable_grad():
        y = plain(*inputs, *ctx.cfg)
    grads = iter(torch.autograd.grad(y, [t for t, n in zip(inputs, needs) if n], dy))
    return tuple(next(grads) if n else None for n in needs)


class _GroupNormFn(torch.autograd.Function):
    """Kernel forward, plain-math backward (JAX `_gn_fwd` / `_gn_bwd`)."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, act):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (num_groups, eps, act)
        return group_norm_cuda(x, weight, bias, num_groups, eps, act)

    @staticmethod
    def backward(ctx, dy):
        return _plain_vjp(group_norm_plain, ctx, dy) + (None, None, None)


class _LayerNormFn(torch.autograd.Function):
    """Kernel forward, plain-math backward (JAX `_ln_fwd` / `_ln_bwd`)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, act):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (eps, act)
        return layer_norm_cuda(x, weight, bias, eps, act)

    @staticmethod
    def backward(ctx, dy):
        return _plain_vjp(layer_norm_plain, ctx, dy) + (None, None)


def fused_group_norm(x, weight, bias, num_groups=32, eps=1e-5, act=None):
    """GroupNorm(+act) on a contiguous (N, C, *spatial) tensor.

    CUDA: the three-launch split-reduction kernel of csrc/norms.cu (any
    group size; no shape gate), through `_GroupNormFn` (no graph is kept
    when nothing needs a gradient). CPU: `group_norm_plain`.
    Replaces t2v_turbo_tpu/ops/fused_norms.py::fused_group_norm.
    """
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, num_groups, eps, act)
    return _GroupNormFn.apply(x, weight, bias, num_groups, eps, act)


fused_group_norm.launches = 0


def group_norm_cuda(x, weight, bias, num_groups=32, eps=1e-5, act=None):
    """Launch the GroupNorm kernels of csrc/norms.cu; raises on what they do not take."""
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_cuda: no kernel for device {x.device}")
    _check_cuda_input(x, "group_norm_cuda")
    n, c = x.shape[:2]
    if x.dim() < 3 or c % num_groups:
        raise ValueError(f"group_norm_cuda: bad shape {tuple(x.shape)} for {num_groups} groups")
    s = x[0, 0].numel()
    if (c // num_groups) * s >= 2**31:
        raise ValueError("group_norm_cuda: a group of 2^31 elements or more")
    w, b = _affine(weight, c, x.device), _affine(bias, c, x.device)
    lib = cuda_lib.lib()
    scratch = torch.empty(
        lib.t2v_group_norm_scratch(n, c, num_groups, s), dtype=torch.float32, device=x.device
    )
    y = torch.empty_like(x)
    err = lib.t2v_group_norm_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), scratch.data_ptr(),
        cuda_lib.DTYPE_CODES[x.dtype], n, c, num_groups, s, eps, _act_code(act),
        cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(err, "group_norm_cuda")
    fused_group_norm.launches += 1
    return y


def fused_layer_norm(x, weight, bias, eps=1e-5, act=None):
    """LayerNorm(+act) over the last axis of a contiguous tensor.

    CUDA: the warp-per-row kernel of csrc/norms.cu, through `_LayerNormFn`
    (no graph is kept when nothing needs a gradient). CPU: `layer_norm_plain`.
    Replaces t2v_turbo_tpu/ops/fused_norms.py::fused_layer_norm.
    """
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, act)
    return _LayerNormFn.apply(x, weight, bias, eps, act)


fused_layer_norm.launches = 0


def layer_norm_cuda(x, weight, bias, eps=1e-5, act=None):
    """Launch the LayerNorm kernel of csrc/norms.cu; raises on what it does not take."""
    if x.device.type != "cuda":
        raise RuntimeError(f"layer_norm_cuda: no kernel for device {x.device}")
    _check_cuda_input(x, "layer_norm_cuda")
    c = x.shape[-1]
    w, b = _affine(weight, c, x.device), _affine(bias, c, x.device)
    y = torch.empty_like(x)
    err = cuda_lib.lib().t2v_layer_norm_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        cuda_lib.DTYPE_CODES[x.dtype], x.numel() // c, c, eps, _act_code(act),
        cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(err, "layer_norm_cuda")
    fused_layer_norm.launches += 1
    return y


def group_norm(x, weight, bias, num_groups=32, eps=1e-5, act=None):
    """GroupNorm(+act) on (N, C, *spatial): the models' entry point."""
    return fused_group_norm(x.contiguous(), weight, bias, num_groups, eps, act)


def layer_norm(x, weight, bias, eps=1e-5, act=None):
    """LayerNorm(+act) over the last axis: the models' entry point."""
    return fused_layer_norm(x.contiguous(), weight, bias, eps, act)
