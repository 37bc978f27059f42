"""Fused int8 quant producers and the gated residual update (counterpart
of wanq_tpu/ops/fused.py).

Each kernel wrapper launches its kernel on a CUDA tensor and runs its
``*_plain`` version, the plain PyTorch form of the same function (also the
kernel's oracle in the tests and in ``chip_smoke.py``), on a CPU tensor:

* :func:`ln_modulate_quant` -- kernel K1 (``csrc/ln_modulate_quant.cu``),
  LayerNorm + adaLN modulate + per-token int8 quant + scaled row sum;
* :func:`quant_sum` -- kernel K7 (``csrc/quant_sum.cu``), optional tanh-GELU
  then per-token int8 quant + scaled row sum (the dynamic ffn.2 input and
  every dynamic int8 activation that ``qlinear`` quantizes);
* :func:`gate_residual` -- kernel K13 (``csrc/gate_residual.cu``), the DiT
  block's residual update ``x + (y + bias) * gate`` in one pass; under
  autograd its backward is the plain chain's gradients.

``ln_modulate_quant_static`` is plain PyTorch only: no shipped config with
a static q/k/v scale runs on the card yet (ROADMAP lists its kernel).

A modulation operand (K1's shift and scale, K13's gate) is one row of C a
sample, [B, C] (Wan2.1: one timestep a sample), or a table [B, R, C] whose
row r serves ``tokens_per_row`` consecutive tokens from token r *
``tokens_per_row``, the last row every token past it (Wan2.2's per-frame
timesteps: a row a latent frame, the pad tokens on the last row).
:func:`by_rows` is the plain form of that broadcast; a table of one row is
the per-sample form.
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


def by_rows(fn, y: torch.Tensor, *tabs: torch.Tensor,
            tokens_per_row: Optional[int] = None) -> torch.Tensor:
    """``fn(y, *tabs)`` with each modulation operand broadcast over y's tokens
    (y [B, S, ...C]): a [B, C] operand as [B, 1, C] (the block's former
    ``t[:, None, :]``, the same bits); the rows of [B, R, C] tables over
    views of their tokens, the last row over the rest, and the two parts
    joined: elementwise, so each token's bits are those of its row's
    per-sample form, and no per-token copy of a table is made."""
    if tabs[0].dim() == 2:
        return fn(y, *(t[:, None, :] for t in tabs))
    r = tabs[0].shape[1]
    if r == 1:
        return fn(y, *tabs)
    k = (r - 1) * tokens_per_row
    head = fn(y[:, :k].unflatten(1, (r - 1, tokens_per_row)), *(t[:, :-1, None] for t in tabs))
    return torch.cat([head.flatten(1, 2), fn(y[:, k:], *(t[:, -1:] for t in tabs))], dim=1)


def _modulate(y: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return y * (1.0 + scale) + shift


def modulate(y: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
             tokens_per_row: Optional[int] = None) -> torch.Tensor:
    """adaLN's ``y * (1 + scale) + shift`` over y [B, S, C] (f32), shift and
    scale [B, C] or tables [B, R, C] (:func:`by_rows`)."""
    return by_rows(_modulate, y, shift, scale, tokens_per_row=tokens_per_row)


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
                            channel_scale=None, tokens_per_row: Optional[int] = None) -> Triple:
    """x [B, N, C]; shift/scale_mod [B, C] or tables [B, R, C] (rows of
    ``tokens_per_row`` tokens) -> (q int8 [B,N,C], scale [B,N], sum [B,N]).
    Same math as wanq_tpu's ln_modulate_quant_xla."""
    y = modulate(_ln(x, eps), shift, scale_mod, tokens_per_row)
    if channel_scale is not None:
        y = y * channel_scale[None, None, :]
    return _quant_rows(y)


def ln_modulate_quant_static(x, shift, scale_mod, delta_a, eps: float = 1e-6,
                             tokens_per_row: Optional[int] = None) -> Triple:
    """LN + modulate + static per-tensor quant. Plain PyTorch only (off the
    W8A8 speed config's path)."""
    y = modulate(_ln(x, eps), shift, scale_mod, tokens_per_row)
    s = delta_a.float().reshape(())
    q = torch.clamp(torch.round(y / s), -128, 127).to(torch.int8)
    b, n = q.shape[:2]
    scale = s.expand(b, n).contiguous()
    ssum = scale * q.float().sum(dim=-1)
    return q, scale, ssum


def _rows_operand(t: torch.Tensor, b: int, c: int, n: int, tokens_per_row: Optional[int],
                  name: str):
    """A modulation operand for a kernel: (f32 rows with unit channel stride,
    16-byte aligned, strides multiples of 4 floats (copied where not), batch
    stride, row stride, rows a sample). [B, C] is one row a sample (a stride-0
    batch, norm3's vectors broadcast, passes as it lies)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    t = t.float()
    if t.dim() == 2:
        t = t[:, None]
    if t.dim() != 3 or t.shape[0] != b or t.shape[2] != c:
        raise ValueError(f"{name}: [B, C] or [B, R, C] with B, C = {(b, c)} expected, got "
                         f"{tuple(t.shape)}")
    rows = t.shape[1]
    if rows > 1 and (tokens_per_row is None or tokens_per_row < 1
                     or (rows - 1) * tokens_per_row >= n):
        raise ValueError(f"{name}: a table of {rows} rows needs tokens_per_row >= 1 with "
                         f"(rows - 1) * tokens_per_row < {n} tokens, got {tokens_per_row}")
    bs, rs = (t.stride(0) if b > 1 else 0), (t.stride(1) if rows > 1 else 0)
    if t.stride(2) != 1 or bs % 4 or rs % 4 or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)  # a new, aligned allocation
        bs, rs = (t.stride(0) if b > 1 else 0), (t.stride(1) if rows > 1 else 0)
    return t, bs, rs, rows


def ln_modulate_quant_cuda(x, shift, scale_mod, eps: float = 1e-6,
                           channel_scale=None, tokens_per_row: Optional[int] = None) -> Triple:
    """Kernel K1 on CUDA tensors. x [B, N, C] bf16 or f32; C a multiple of 8
    (bf16) / 4 (f32) and at most 6144, the widest row its four-warp form holds
    in registers (Wan's widths are 1536, 3072 and 5120); shift and scale_mod
    [B, C] or tables [B, R, C] of the same R (rows of ``tokens_per_row``
    tokens), read as they lie where their strides allow. A launch that reads
    a table of more than one row a sample also counts
    ``ln_modulate_quant_rows``."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: bf16 or f32 expected, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError("x must be a CUDA tensor")
    b, n, c = x.shape
    if c == 0 or c > K1_MAX_C or c % (8 if x.dtype == torch.bfloat16 else 4):
        raise ValueError(f"C={c} must be a positive multiple of 8 (bf16) / 4 (f32), at most "
                         f"{K1_MAX_C}")
    x = x.contiguous()
    shift, sh_bs, sh_rs, rows = _rows_operand(shift, b, c, n, tokens_per_row, "shift")
    scale_mod, sc_bs, sc_rs, sc_rows = _rows_operand(scale_mod, b, c, n, tokens_per_row,
                                                     "scale_mod")
    if sc_rows != rows:
        raise ValueError(f"shift has {rows} rows a sample, scale_mod {sc_rows}")
    if channel_scale is not None:
        channel_scale = channel_scale.float().contiguous()
        _lib.require_cuda(channel_scale, torch.float32, "channel_scale")
        if channel_scale.shape != (c,):
            raise ValueError(f"channel_scale: [C] = ({c},) expected, got "
                             f"{tuple(channel_scale.shape)}")
    for t, name in ((x, "x"), (channel_scale, "channel_scale")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel loads 16 bytes a thread)")
    q = torch.empty((b, n, c), dtype=torch.int8, device=x.device)
    s = torch.empty((b, n), dtype=torch.float32, device=x.device)
    ssum = torch.empty((b, n), dtype=torch.float32, device=x.device)
    _lib.launch(
        "ln_modulate_quant", "wanq_ln_modulate_quant",
        x.data_ptr(), int(x.dtype == torch.bfloat16), shift.data_ptr(), sh_bs, sh_rs,
        scale_mod.data_ptr(), sc_bs, sc_rs, rows, tokens_per_row or n,
        _lib.ptr(channel_scale), q.data_ptr(), s.data_ptr(), ssum.data_ptr(), b, n, c,
        float(eps),
    )
    if rows > 1:
        _lib.count("ln_modulate_quant_rows")
    return q, s, ssum


def ln_modulate_quant(x, shift, scale_mod, eps: float = 1e-6,
                      channel_scale=None, tokens_per_row: Optional[int] = None) -> Triple:
    """K1 dispatch: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.is_cuda:
        return ln_modulate_quant_cuda(x, shift, scale_mod, eps, channel_scale, tokens_per_row)
    return ln_modulate_quant_plain(x, shift, scale_mod, eps, channel_scale, tokens_per_row)


def _gate(t: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return t * gate


def gate_residual_plain(x: torch.Tensor, y: torch.Tensor, gate: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        tokens_per_row: Optional[int] = None) -> torch.Tensor:
    """x [B, S, C] + (y [B, S, C] + bias [C]) * gate [B, C] (or a table [B, R,
    C] of rows of ``tokens_per_row`` tokens), summed in f32 and returned in
    x's dtype; bias and gate each optional (a missing one is no step, not an
    add of 0 or a product by 1). The DiT block's residual update as it writes
    it, ``(x.float() + y.float() * gate[:, None, :]).to(x.dtype)``, with an FP
    o projection's bias added to y first, as ``fp_linear`` adds it (wanq_tpu's
    gate_residual, an XLA fusion)."""
    t = y.float()
    if bias is not None:
        t = t + bias.float()
    if gate is not None:
        t = by_rows(_gate, t, gate.float(), tokens_per_row=tokens_per_row)
    return (x.float() + t).to(x.dtype)


def gate_residual_cuda(x: torch.Tensor, y: torch.Tensor, gate: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None,
                       tokens_per_row: Optional[int] = None) -> torch.Tensor:
    """Kernel K13 on CUDA tensors: the bits of :func:`gate_residual_plain`.
    x [B, S, C] bf16 or f32, y f32 [B, S, C] contiguous, C a multiple of 8;
    gate f32 [B, C] or a table [B, R, C] (rows of ``tokens_per_row`` tokens),
    read as it lies where its strides keep 16-byte rows (the block passes a
    column of its [B, (R,) 6, C] modulation), else copied; bias [C]. Returns a new tensor of x's dtype; x is not written. A
    launch whose gate has more than one row a sample also counts
    ``gate_residual_rows``."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x: bf16 or f32 expected, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError("x must be a CUDA tensor")
    if x.dim() != 3:
        raise ValueError(f"x: [B, S, C] expected, got {tuple(x.shape)}")
    b, s, c = x.shape
    _lib.require_cuda(y, torch.float32, "y")
    if y.shape != x.shape or not y.is_contiguous():
        raise ValueError(f"y: a contiguous f32 {tuple(x.shape)} expected, got "
                         f"{tuple(y.shape)} with strides {y.stride()}")
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8 (the kernel takes 8 channels a thread)")
    x = x.contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
        _lib.require_cuda(bias, torch.float32, "bias")
        if bias.shape != (c,):
            raise ValueError(f"bias: [C] = ({c},) expected, got {tuple(bias.shape)}")
    gate_stride, row_stride, rows = 0, 0, 1
    if gate is not None:
        _lib.require_cuda(gate, torch.float32, "gate")
        gate, gate_stride, row_stride, rows = _rows_operand(gate, b, c, s, tokens_per_row, "gate")
    for t, name in ((x, "x"), (y, "y"), (bias, "bias")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel loads 16 bytes a thread)")
    out = torch.empty_like(x)
    _lib.launch("gate_residual", "wanq_gate_residual", x.data_ptr(),
                int(x.dtype == torch.bfloat16), y.data_ptr(), _lib.ptr(bias), _lib.ptr(gate),
                gate_stride, row_stride, rows, tokens_per_row or 1, out.data_ptr(), b, s, c)
    if rows > 1:
        _lib.count("gate_residual_rows")
    return out


def _row_sums(a: torch.Tensor, b: torch.Tensor, rows: int,
              tokens_per_row: Optional[int]) -> torch.Tensor:
    """a * b [B, S, C] summed over each modulation row's tokens (:func:`by_rows`'s
    rows) -> [B, rows, C]: the products over the same views, and the sums over
    the same dims, as autograd reduces a broadcast row's gradient."""
    if rows == 1:
        return (a * b).sum(1, keepdim=True)
    k = (rows - 1) * tokens_per_row
    head = (a[:, :k].unflatten(1, (rows - 1, tokens_per_row))
            * b[:, :k].unflatten(1, (rows - 1, tokens_per_row))).sum(2)
    return _joined(torch.cat([head, (a[:, k:] * b[:, k:]).sum(1, keepdim=True)], dim=1))


def _joined(t: torch.Tensor) -> torch.Tensor:
    """t + 0, in place: autograd adds the gradients of a table's two views
    (:func:`by_rows`' head and last row), each zero where the other is not,
    so a -0 reads +0; the add gives the plain chain's bits."""
    return t.add_(0.0)


class _GateResidual(torch.autograd.Function):
    """K13 under autograd: the kernel's forward; the backward forms the plain
    chain's gradients with autograd's own products and reductions, so a
    training step keeps its bits, in fewer passes (a bf16 upstream gradient
    is widened inside the product, not by a pass of its own). A gate table's
    gradient sums each row's tokens."""

    @staticmethod
    def forward(ctx, x, y, gate, bias, tokens_per_row=None):
        # y only for the gate's gradient, as autograd's product keeps it
        ctx.save_for_backward(y if ctx.needs_input_grad[2] else None, gate, bias)
        ctx.tokens_per_row = tokens_per_row
        return gate_residual_cuda(x, y, gate, bias, tokens_per_row)

    @staticmethod
    def backward(ctx, grad):
        y, gate, bias = ctx.saved_tensors
        need_y, need_gate, need_bias = ctx.needs_input_grad[1:4]
        tpr = ctx.tokens_per_row
        # the casts on either side of the f32 sum pass x's gradient through
        grad_t = grad_gate = None
        if gate is None:
            grad_t = grad.float() if need_y or need_bias else None
        else:
            rows = gate.shape[1] if gate.dim() == 3 else 1
            if need_y or need_bias:
                grad_t = by_rows(_gate, grad, gate.float(), tokens_per_row=tpr)
                if rows > 1:
                    grad_t = _joined(grad_t)
            if need_gate:
                t = y if bias is None else y + bias.float()
                grad_gate = _row_sums(grad, t, rows, tpr).view(gate.shape).to(gate.dtype)
        grad_bias = (grad_t.sum((0, 1), keepdim=True).view(-1).to(bias.dtype)
                     if need_bias else None)
        return grad, grad_t if need_y else None, grad_gate, grad_bias, None


def gate_residual(x: torch.Tensor, y: torch.Tensor, gate: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  tokens_per_row: Optional[int] = None) -> torch.Tensor:
    """K13 dispatch: the kernel for CUDA tensors (under autograd too, with the
    plain chain's backward), the plain version for CPU tensors."""
    if x.is_cuda:
        return _GateResidual.apply(x, y, gate, bias, tokens_per_row)
    return gate_residual_plain(x, y, gate, bias, tokens_per_row)
