"""Fused LayerNorm + adaLN modulate + int8 quant producers
(counterpart of wanq_tpu/ops/fused.py).

:func:`ln_modulate_quant` is kernel K1 (``csrc/ln_modulate_quant.cu``): on a
CUDA tensor it launches the kernel, on a CPU tensor it runs
:func:`ln_modulate_quant_plain`, the plain PyTorch version of the same
function (also the kernel's oracle in the tests and in ``chip_smoke.py``).
``ln_modulate_quant_static`` and ``quant_sum`` are plain PyTorch only: the
W8A8 speed config does not reach them (ROADMAP lists their kernels).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from wanq_tpu_torch.ops import _lib

_EPS = 1e-6

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _quant_rows(y: torch.Tensor) -> Triple:
    """Per-row symmetric int8 quant + scaled int sum (scale = absmax/127,
    sum = scale * sum(q)); round half to even like jnp.round."""
    absmax = y.abs().amax(dim=-1)
    scale = torch.clamp_min(absmax / 127.0, _EPS)
    q = torch.clamp(torch.round(y / scale[..., None]), -128, 127).to(torch.int8)
    ssum = scale * q.float().sum(dim=-1)
    return q, scale, ssum


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def quant_sum(x: torch.Tensor, gelu: bool = False,
              channel_scale: Optional[torch.Tensor] = None) -> Triple:
    """Per-token int8 quant (+ optional tanh-GELU first). Plain PyTorch;
    its kernel (TPU quant_sum_pallas) is still to be ported."""
    y = x.float()
    if gelu:
        y = F.gelu(y, approximate="tanh")
    if channel_scale is not None:
        y = y * channel_scale[None, :]
    return _quant_rows(y)


def ln_modulate_quant_plain(x, shift, scale_mod, eps: float = 1e-6,
                            channel_scale=None) -> Triple:
    """x [B, N, C]; shift/scale_mod [B, C] -> (q int8 [B,N,C], scale [B,N],
    sum [B,N]). Same math as wanq_tpu's ln_modulate_quant_xla."""
    y = _ln(x, eps) * (1.0 + scale_mod[:, None, :]) + shift[:, None, :]
    if channel_scale is not None:
        y = y * channel_scale[None, None, :]
    return _quant_rows(y)


def ln_modulate_quant_static(x, shift, scale_mod, delta_a, eps: float = 1e-6) -> Triple:
    """LN + modulate + static per-tensor quant. Plain PyTorch only (off the
    W8A8 speed config's path)."""
    y = _ln(x, eps) * (1.0 + scale_mod[:, None, :]) + shift[:, None, :]
    s = delta_a.float().reshape(())
    q = torch.clamp(torch.round(y / s), -128, 127).to(torch.int8)
    b, n = q.shape[:2]
    scale = s.expand(b, n).contiguous()
    ssum = scale * q.float().sum(dim=-1)
    return q, scale, ssum


def ln_modulate_quant_cuda(x, shift, scale_mod, eps: float = 1e-6,
                           channel_scale=None) -> Triple:
    """Kernel K1 on CUDA tensors."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: bf16 or f32 expected, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError("x must be a CUDA tensor")
    b, n, c = x.shape
    if c % (8 if x.dtype == torch.bfloat16 else 4):
        raise ValueError(f"C={c} must be a multiple of 8 (bf16) / 4 (f32)")
    x = x.contiguous()
    shift = shift.float().contiguous()
    scale_mod = scale_mod.float().contiguous()
    for t, name in ((shift, "shift"), (scale_mod, "scale_mod")):
        if t.shape != (b, c) or not t.is_cuda:
            raise ValueError(f"{name}: CUDA [B, C] = {(b, c)} expected, got {tuple(t.shape)}")
    if channel_scale is not None:
        channel_scale = channel_scale.float().contiguous()
        _lib.require_cuda(channel_scale, torch.float32, "channel_scale")
    q = torch.empty((b, n, c), dtype=torch.int8, device=x.device)
    s = torch.empty((b, n), dtype=torch.float32, device=x.device)
    ssum = torch.empty((b, n), dtype=torch.float32, device=x.device)
    _lib.launch(
        "ln_modulate_quant", "wanq_ln_modulate_quant",
        x.data_ptr(), int(x.dtype == torch.bfloat16), shift.data_ptr(),
        scale_mod.data_ptr(), _lib.ptr(channel_scale), q.data_ptr(),
        s.data_ptr(), ssum.data_ptr(), b, n, c, float(eps),
    )
    return q, s, ssum


def ln_modulate_quant(x, shift, scale_mod, eps: float = 1e-6,
                      channel_scale=None) -> Triple:
    """K1 dispatch: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.is_cuda:
        return ln_modulate_quant_cuda(x, shift, scale_mod, eps, channel_scale)
    return ln_modulate_quant_plain(x, shift, scale_mod, eps, channel_scale)
