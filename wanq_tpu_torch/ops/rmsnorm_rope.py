"""RMSNorm -> RoPE -> heads-major layout for the q/k path (counterpart of
wanq_tpu/ops/rmsnorm_rope.py).

:func:`rms_rope_heads` and :func:`rms_split_heads` are kernel K3
(``csrc/rms_rope_heads.cu``; the rope is off in the second) on CUDA
tensors, and their ``*_plain`` versions on CPU tensors.

``split_heads`` and ``merge_heads`` are plain PyTorch views: the attention
kernel K4 reads v [B, S, N*D] through strides and writes its output
seq-major, so on the main path neither is a pass over memory.

Tables (ca, sb) [S, D] follow wanq_tpu's caller contract: pre-padded to S
with the identity (ca=1, sb=0) beyond the valid tokens, and pre-scaled on
the q side by the softmax scale where the attention that follows does not
apply it (K4); the int8 attention applies its own, so its q tables are
unscaled. The kernel takes head dim 128 and up to 6144 channels (the 1.3B
and 14B widths, 1536 and 5120); the plain versions take any.
"""

from __future__ import annotations

import torch

from wanq_tpu_torch.models.rope import _pairswap
from wanq_tpu_torch.ops import _lib


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def rms_rope_heads_plain(x, w, ca, sb, num_heads: int, eps: float = 1e-6,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """x [B, S, N*D], w [N*D], ca/sb [S, D] -> [B, N, S, D] (out_dtype).
    The norm rounds to x.dtype before the rope, like the unfused chain."""
    b, s, nd = x.shape
    d = nd // num_heads
    xn = _rms(x, w, eps).to(x.dtype).float().reshape(b, s, num_heads, d)
    y = xn * ca.float()[None, :, None, :] + _pairswap(xn) * sb.float()[None, :, None, :]
    return y.transpose(1, 2).to(out_dtype)


def rms_split_heads_plain(x, w, num_heads: int, eps: float = 1e-6,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """x [B, S, N*D] -> rms_norm over the model dim -> [B, N, S, D]."""
    b, s, nd = x.shape
    y = _rms(x, w, eps).reshape(b, s, num_heads, nd // num_heads)
    return y.transpose(1, 2).to(out_dtype)


K3_HEAD_DIM = 128  # the head dim the K3 kernel is built for
K3_MAX_C = 6144    # the widest row it holds in registers (four warps x 1536 channels)


def _k3_cuda(x, w, ca, sb, num_heads, eps, out_dtype):
    _lib.require_cuda(x, torch.bfloat16, "x")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the K3 kernel writes bf16, not {out_dtype}")
    b, s, nd = x.shape
    d = nd // num_heads
    if d * num_heads != nd or d != K3_HEAD_DIM or nd > K3_MAX_C:
        raise ValueError(f"K3 takes head dim {K3_HEAD_DIM} and at most {K3_MAX_C} channels, "
                         f"got {num_heads} heads over {nd}")
    x = x.contiguous()
    w = w.float().contiguous()
    _lib.require_cuda(w, torch.float32, "w")
    if w.shape != (nd,):
        raise ValueError(f"w: [N*D] = ({nd},) expected, got {tuple(w.shape)}")
    if ca is not None:
        ca = ca.float().contiguous()
        sb = sb.float().contiguous()
        if ca.shape != (s, d) or sb.shape != (s, d):
            raise ValueError(f"rope tables must be [S, D] = {(s, d)}")
        _lib.require_cuda(ca, torch.float32, "ca")
        _lib.require_cuda(sb, torch.float32, "sb")
    for t, name in ((x, "x"), (w, "w"), (ca, "ca"), (sb, "sb")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel loads 16 bytes a lane)")
    out = torch.empty((b, num_heads, s, d), dtype=torch.bfloat16, device=x.device)
    _lib.launch(
        "rms_rope_heads", "wanq_rms_rope_heads",
        x.data_ptr(), w.data_ptr(), _lib.ptr(ca), _lib.ptr(sb), out.data_ptr(),
        b, s, num_heads, d, float(eps),
    )
    return out


def rms_rope_heads(x, w, ca, sb, num_heads: int, eps: float = 1e-6,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """K3 dispatch (rope on): kernel for CUDA tensors, plain for CPU."""
    if x.is_cuda:
        return _k3_cuda(x, w, ca, sb, num_heads, eps, out_dtype)
    return rms_rope_heads_plain(x, w, ca, sb, num_heads, eps, out_dtype)


def rms_split_heads(x, w, num_heads: int, eps: float = 1e-6,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """K3 dispatch (rope off): kernel for CUDA tensors, plain for CPU."""
    if x.is_cuda:
        return _k3_cuda(x, w, None, None, num_heads, eps, out_dtype)
    return rms_split_heads_plain(x, w, num_heads, eps, out_dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """x [B, S, N*D] -> [B, N, S, D] as a strided view (no copy)."""
    b, s, nd = x.shape
    return x.view(b, s, num_heads, nd // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """x [B, N, S, D] -> [B, S, N*D]; a view when x's memory is seq-major
    (as K4 writes it), a copy otherwise."""
    b, n, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, n * d)
