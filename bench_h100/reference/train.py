"""Plain reference of QLoRA distillation on the Wan2.1 DiT: a frozen base
under the scheme's quantizers, rank-r adapters on the raw input of the
adapted linears, the student trained to match the teacher's CFG velocity in
one forward, then the optimizer (clip by global norm, AdamW). Written from
the method's equations (QLoRA, Dettmers et al. 2023, on the PTQ base of
``scheme.py``); it imports nothing of the program.

The trainable linear: the activation fake-quantized (symmetric, per token,
the round passed straight through and the gradient flowing through the
absmax, the clamp as max-then-min), its values rounded to a bf16 operand; the
weight dequantized from its own codes, ``(codes + zp) * delta``, rounded to
bf16; one product with f32 sums; the bias; then ``(x @ a) @ (b * alpha / r)``
in f32 on the layer's raw input. Each block is recomputed in the backward
(``torch.utils.checkpoint``). The control ``"bf16_adapters"`` computes the
adapters' products in bf16 and takes attention's operands through float8
e4m3."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.utils.checkpoint

from .wan import BF16, WanReference, quantize_weight


class _MmF32(torch.autograd.Function):
    """a [M, K] @ w [K, N] of bf16 operands into f32 sums, differentiable in a:
    its gradient is the cotangent rounded to bf16 times w^T, summed in f32."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(w)
        if a.is_cuda:
            return torch.mm(a, w, out_dtype=torch.float32)
        return a.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        g16 = g.to(BF16)
        if g.is_cuda:
            return torch.mm(g16, w.t(), out_dtype=torch.float32).to(BF16), None
        return (g16.float() @ w.float().t()).to(BF16), None


def _round_ste(u: torch.Tensor) -> torch.Tensor:
    return u + (torch.round(u) - u).detach()


def fake_quant_rows(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-row fake-quant of x [M, K] in f32, differentiable."""
    nl = 2 ** (bits - 1) - 1
    xf = x.float()
    delta = xf.abs().amax(1, keepdim=True) / nl
    delta = torch.where(delta < 1e-6, torch.full_like(delta, 1e-6), delta)
    q = _round_ste(xf / delta)
    lo = torch.full((), -nl - 1.0, device=x.device)
    q = torch.minimum(torch.maximum(q, lo), lo.new_full((), float(nl)))
    return q * delta


class QLoRAReference(WanReference):
    """The reference DiT on the trainable route, with ``adapters`` {layer:
    {"a", "b"}} (f32 leaves) and their ``scale``."""

    def __init__(self, params, cfg, scheme, adapters: Dict, scale: float,
                 control: Optional[str] = None):
        super().__init__(params, cfg, scheme, control=control)
        self.adapters, self.scale = adapters, scale
        self.use_adapters = True
        self._deq: Dict[str, torch.Tensor] = {}

    def _weight(self, name: str, w: torch.Tensor, bits: int, sym: bool) -> torch.Tensor:
        """The dequantized bf16 weight [K, N], made once."""
        if name not in self._deq:
            q, d, z = quantize_weight(w, bits, sym)
            self._deq[name] = ((q + z[:, None]) * d[:, None]).t().to(BF16).contiguous()
        return self._deq[name]

    def linear(self, name: str, lp: Dict, x: torch.Tensor) -> torch.Tensor:
        pol = self.policy.get(name)
        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k)
        if pol is None or not pol.quantized:
            y = _MmF32.apply(self._act16(x2), self._w16(lp["w"]))
        else:
            xq = fake_quant_rows(x2, pol.a_bits).to(BF16)
            y = _MmF32.apply(xq, self._weight(name, lp["w"], pol.w_bits, pol.w_sym))
        y = y + lp["b"].float()
        ab = self.adapters.get(name) if self.use_adapters else None
        if ab is not None:
            if self.control == "bf16_adapters":
                h = x2.to(BF16) @ ab["a"].to(BF16)
                y = y + (h @ (ab["b"] * self.scale).to(BF16)).float()
            else:
                y = y + (x2.float() @ ab["a"]) @ (ab["b"] * self.scale)
        return y.reshape(*lead, -1)

    def block(self, i, x, e0, ctx, grid):
        if torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(super().block, i, x, e0, ctx, grid,
                                                     use_reentrant=False,
                                                     preserve_rng_state=False)
        return super().block(i, x, e0, ctx, grid)


def noised(x0, noise, t: float, n_train: int = 1000):
    s = t / n_train
    return (1.0 - s) * x0 + s * noise


def distill_loss(model: QLoRAReference, batch: Dict, guide: float) -> torch.Tensor:
    """mean((v_student - (v_u + g (v_c - v_u)))^2); the teacher is the base
    without adapters, no gradient."""
    xt = noised(batch["x0"], batch["noise"], batch["t"])
    with torch.no_grad():
        model.use_adapters = False
        both = model.forward(torch.cat([xt, xt]), batch["t"],
                             torch.cat([batch["context"], batch["null_context"]]))
        model.use_adapters = True
        cond, uncond = both[:1], both[1:]
        target = uncond + guide * (cond - uncond)
        del both
    student = model.forward(xt, batch["t"], batch["context"])
    return torch.mean(torch.square(student - target))


class AdamW:
    """Clip by global norm (scale by max / |g| when |g| >= max), then AdamW
    (decoupled weight decay), on a list of f32 leaves."""

    def __init__(self, leaves: List[torch.Tensor], lr: float, weight_decay: float,
                 max_norm: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.leaves, self.lr, self.wd, self.max_norm = leaves, lr, weight_decay, max_norm
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> float:
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        if norm >= self.max_norm:
            grads = [g / norm * self.max_norm for g in grads]
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
        return float(norm)


def train_steps(model: QLoRAReference, leaves: List[torch.Tensor], opt: AdamW,
                batches: List[Dict], guide: float) -> Dict:
    """The steps, one batch each: (losses, the first step's clipped gradients,
    the sum of each leaf's squared gradient over the steps)."""
    losses, first, energy = [], None, [torch.zeros((), device=p.device) for p in leaves]
    for batch in batches:
        for p in leaves:
            p.grad = None
        loss = distill_loss(model, batch, guide)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        losses.append(float(loss.detach()))
        energy = [e + g.double().square().sum() for e, g in zip(energy, grads)]
        opt.step(grads)
        if first is None:
            first = [m / (1 - opt.b1) for m in opt.m]
    return {"losses": losses, "first_grads": first,
            "grad_energy": [float(math.sqrt(e)) for e in energy]}
