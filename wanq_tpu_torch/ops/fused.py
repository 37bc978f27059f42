"""Fused int8 quant producers (counterpart of wanq_tpu/ops/fused.py).

Each kernel wrapper launches its kernel on a CUDA tensor and runs its
``*_plain`` version, the plain PyTorch form of the same function (also the
kernel's oracle in the tests and in ``chip_smoke.py``), on a CPU tensor:

* :func:`ln_modulate_quant` -- kernel K1 (``csrc/ln_modulate_quant.cu``),
  LayerNorm + adaLN modulate + per-token int8 quant + scaled row sum;
* :func:`quant_sum` -- kernel K7 (``csrc/quant_sum.cu``), optional tanh-GELU
  then per-token int8 quant + scaled row sum (the dynamic ffn.2 input and
  every dynamic int8 activation that ``qlinear`` quantizes).

``ln_modulate_quant_static`` is plain PyTorch only: no shipped config with
a static q/k/v scale runs on the card yet (ROADMAP lists its kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from wanq_tpu_torch.ops import _lib

_EPS = 1e-6
K1_MAX_C = 6144  # the widest row the K1 kernel takes (four warps x 1536 channels)
# the widest row the K7 kernel takes: twelve warps x 1536 channels for bf16;
# for f32 its ring of rows fills shared memory at 13824
K7_MAX_C = {torch.bfloat16: 18432, torch.float32: 13824}

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def true_div(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d as an IEEE division on every device. PyTorch's CUDA kernels
    multiply by the reciprocal when the divisor is a Python scalar, which
    is one ulp off for some t; a quant scale one ulp off flips the code of
    an exact .5 tie, which bf16 inputs hit often."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


def _quant_rows(y: torch.Tensor) -> Triple:
    """Per-row symmetric int8 quant + scaled int sum (scale = absmax/127,
    sum = scale * sum(q)); round half to even like jnp.round."""
    absmax = y.abs().amax(dim=-1)
    scale = torch.clamp_min(true_div(absmax, 127.0), _EPS)
    q = torch.clamp(torch.round(y / scale[..., None]), -128, 127).to(torch.int8)
    ssum = scale * q.float().sum(dim=-1)
    return q, scale, ssum


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def quant_sum_plain(x: torch.Tensor, gelu: bool = False,
                    channel_scale: Optional[torch.Tensor] = None) -> Triple:
    """x [..., C] -> (q int8 [..., C], scale f32 [...], sum f32 [...]):
    optional tanh-GELU in f32, optional SmoothQuant channel_scale, then
    per-token int8 quant. Same math as wanq_tpu's quant_sum_xla /
    gelu_quant_sum_xla."""
    y = x.float()
    if gelu:
        y = F.gelu(y, approximate="tanh")
    if channel_scale is not None:
        y = y * channel_scale.float()
    return _quant_rows(y)


def quant_sum_cuda(x: torch.Tensor, gelu: bool = False,
                   channel_scale: Optional[torch.Tensor] = None) -> Triple:
    """Kernel K7 on CUDA tensors. x [..., C] bf16 or f32, C a multiple of
    8 (bf16) / 4 (f32) and at most 18432 (bf16) / 13824 (f32); Wan's widths
    run to the 14B ffn's 13824. A bf16 x takes its GELU through K7's table, an
    f32 x through tanhf: both are ``gelu_tanh`` bit for bit."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: bf16 or f32 expected, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError("x must be a CUDA tensor")
    c = x.shape[-1]
    if c == 0 or c > K7_MAX_C[x.dtype] or c % (8 if x.dtype == torch.bfloat16 else 4):
        raise ValueError(f"C={c} must be a positive multiple of 8 (bf16) / 4 (f32), at most "
                         f"{K7_MAX_C[x.dtype]} for {x.dtype}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, c).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel loads 16 bytes a thread)")
    if channel_scale is not None:
        channel_scale = channel_scale.float().contiguous()
        _lib.require_cuda(channel_scale, torch.float32, "channel_scale")
        if channel_scale.shape != (c,):
            raise ValueError(f"channel_scale: [C] = ({c},) expected, got "
                             f"{tuple(channel_scale.shape)}")
    rows = x2.shape[0]
    q = torch.empty((rows, c), dtype=torch.int8, device=x.device)
    s = torch.empty((rows,), dtype=torch.float32, device=x.device)
    ssum = torch.empty((rows,), dtype=torch.float32, device=x.device)
    _lib.launch(
        "quant_sum", "wanq_quant_sum",
        x2.data_ptr(), int(x.dtype == torch.bfloat16), int(bool(gelu)),
        _lib.ptr(channel_scale), q.data_ptr(), s.data_ptr(), ssum.data_ptr(), rows, c,
    )
    return q.reshape(*lead, c), s.reshape(lead), ssum.reshape(lead)


def gelu_bf16_table_check(device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """The tanh-GELU of every bf16 value (index i = its 16 bits) on the card,
    f32 [65536] each: through K7's factor table, and through the kernels'
    direct ``gelu_tanh`` (csrc/common.cuh). A check of K7's table, made by
    chip_smoke.py and the card tests; no path calls it."""
    table = torch.empty((65536,), dtype=torch.float32, device=device)
    direct = torch.empty_like(table)
    _lib.launch("gelu_bf16_check", "wanq_gelu_bf16_check", table.data_ptr(), direct.data_ptr())
    return table, direct


def quant_sum(x: torch.Tensor, gelu: bool = False,
              channel_scale: Optional[torch.Tensor] = None) -> Triple:
    """K7 dispatch: the kernel for CUDA tensors, the plain version for CPU
    tensors. x [..., C] -> (q [..., C], scale [...], sum [...])."""
    if x.is_cuda:
        return quant_sum_cuda(x, gelu, channel_scale)
    return quant_sum_plain(x, gelu, channel_scale)


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
    """Kernel K1 on CUDA tensors. x [B, N, C] bf16 or f32; C a multiple of 8
    (bf16) / 4 (f32) and at most 6144, the widest row its four-warp form holds
    in registers (Wan's widths are 1536 and 5120)."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: bf16 or f32 expected, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError("x must be a CUDA tensor")
    b, n, c = x.shape
    if c == 0 or c > K1_MAX_C or c % (8 if x.dtype == torch.bfloat16 else 4):
        raise ValueError(f"C={c} must be a positive multiple of 8 (bf16) / 4 (f32), at most "
                         f"{K1_MAX_C}")
    x = x.contiguous()
    shift = shift.float().contiguous()
    scale_mod = scale_mod.float().contiguous()
    for t, name in ((shift, "shift"), (scale_mod, "scale_mod")):
        if t.shape != (b, c) or not t.is_cuda:
            raise ValueError(f"{name}: CUDA [B, C] = {(b, c)} expected, got {tuple(t.shape)}")
    if channel_scale is not None:
        channel_scale = channel_scale.float().contiguous()
        _lib.require_cuda(channel_scale, torch.float32, "channel_scale")
        if channel_scale.shape != (c,):
            raise ValueError(f"channel_scale: [C] = ({c},) expected, got "
                             f"{tuple(channel_scale.shape)}")
    for t, name in ((x, "x"), (shift, "shift"), (scale_mod, "scale_mod"),
                    (channel_scale, "channel_scale")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel loads 16 bytes a thread)")
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
