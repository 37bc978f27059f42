"""CFG-schedule step distillation for the Wan DiT (counterpart of
wanq_tpu/training/distill.py).

The student learns to match, in one forward, the frozen teacher's
CFG-combined flow prediction ``v_u + g (v_c - v_u)`` at a guidance scale
drawn per step; the loss is the mean square error. Three step builders, as
in ``wanq_tpu``:

* :func:`make_distill_step`: every parameter trains (the teacher is a
  separate tree);
* :func:`make_lora_distill_step`: FP LoRA, the base doubles as the teacher;
* :func:`make_qlora_distill_step`: a frozen quantized base (int8 mode, which
  ``dit_forward(training=True)`` runs as the differentiable dequant route)
  plus adapters riding its quant state; the same base without adapters is
  the teacher.

The teacher runs under ``torch.no_grad()`` (``wanq_tpu``'s stop_gradient; on
the card its attention stays on the plain K4 launch). The optimizer is
optax's ``chain(clip_by_global_norm, adamw)`` written out:
:func:`clip_by_global_norm_` scales by ``max / |g|`` only when ``|g| >= max``
(no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``), then
``torch.optim.AdamW`` with every hyperparameter passed as optax's defaults
(betas 0.9 / 0.999, eps 1e-8, ``DistillConfig.weight_decay``; torch's default
decay 1e-2 is never used). A step updates the trained tensors, the
optimizer and the EMA in place and returns them, with the loss and the
gradients' global norm before clipping. The LoRA scale stays outside the
optimizer.

Under a sharding plan (``plan=``, as ``wanq_tpu``'s builders take it) every
rank runs the three forwards through ``dit_forward(plan=)``: each takes its
dp rows of the batch and its tokens, and every rank computes the same loss on
the gathered output. The backward runs through the plan's collectives
(``parallel/sharding.py``); the update then sums the gradients over the data
axes (``ShardingPlan.reduce_grads``) before the clip, the global norm and
AdamW, so every rank applies the same update and the trained tensors stay
equal on every rank, bit for bit. Under FSDP every parameter of
``make_distill_step`` trains as its shard (a ``Shard``'s local tensor, in its
pack), and the global norm sums the shards' squares over the storage ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from wanq_tpu_torch.configs import WanConfig
from wanq_tpu_torch.models.dit import dit_forward
from wanq_tpu_torch.parallel.sharding import Shard, pack_params
from wanq_tpu_torch.training.lora import SCALE, apply_lora, merge_lora_into_quant_state


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-4
    max_grad_norm: float = 1.0
    ema_decay: float = 0.95
    cfg_mid: float = 5.0  # per-step guidance draw in [mid - 2, mid + 5]
    num_train_timesteps: int = 1000
    seq_len: int = 512
    # recompute each DiT block in the backward (dit_forward remat=True)
    remat: bool = False


@dataclasses.dataclass
class TrainState:
    params: Any
    ema_params: Any
    opt_state: Any  # the torch.optim.AdamW over ``params``' tensors: its own state
    step: int = 0


def _leaves(tree) -> List[torch.Tensor]:
    """The trained tensors of a tree (the LoRA scale excluded; a Shard's local
    tensor), in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, Shard):
        return [tree.local]
    if isinstance(tree, dict):
        return [t for k, v in tree.items() if k != SCALE for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _stored(tree) -> List[bool]:
    """For each of :func:`_leaves`, whether it is a Shard's (stored split)."""
    if isinstance(tree, Shard):
        return [True]
    if torch.is_tensor(tree):
        return [False]
    if isinstance(tree, dict):
        return [f for k, v in tree.items() if k != SCALE for f in _stored(v)]
    if isinstance(tree, (list, tuple)):
        return [f for v in tree for f in _stored(v)]
    return []


def _tree_map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, Shard):
        return Shard(fn(tree.local), tree.dim, tree.full_shape)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def init_train_state(params, cfg: DistillConfig) -> Tuple[TrainState, torch.optim.Optimizer]:
    """(state, optimizer). The trained tree is a copy of ``params`` that
    takes gradients (the caller's tree stays as it is, e.g. as the teacher);
    the EMA starts equal to it."""
    params = _tree_map(lambda t: t.detach().clone(), params)
    if any(_stored(params)):
        pack_params(params)  # the cloned shards gather from packs of their own
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tx = torch.optim.AdamW(leaves, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=cfg.weight_decay, amsgrad=False, maximize=False)
    ema = _tree_map(lambda t: t.detach().clone(), params)
    return TrainState(params=params, ema_params=ema, opt_state=tx), tx


@torch.no_grad()
def ema_update(ema, params, decay: float):
    """ema = decay * ema + (1 - decay) * params, in place; returns ema."""
    for e, p in zip(_leaves(ema), _leaves(params)):
        e.copy_(decay * e + (1.0 - decay) * p)
    return ema


def draw_guidance(seed: int, cfg_mid: float) -> float:
    """The step's guidance scale: a seeded draw from [mid - 2, mid + 5]
    (``wanq_tpu``'s numpy draw)."""
    rng = np.random.default_rng(seed)
    return float(rng.integers(int(cfg_mid) - 2, int(cfg_mid) + 6))


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over every tensor, in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float, norm=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient times max / |g| when
    the global norm |g| (``norm``, else :func:`global_norm` of ``grads``) >=
    max. Returns |g| (before clipping)."""
    norm = global_norm(grads) if norm is None else norm
    if norm >= max_norm:
        for g in grads:
            g.copy_(g / norm.to(g.dtype) * max_norm)
    return norm


def _noised(x0, noise, t, dcfg: DistillConfig):
    sigma = (t / dcfg.num_train_timesteps)[:, None, None, None, None]
    return (1.0 - sigma) * x0 + sigma * noise


def _distill_loss(student, teacher, g) -> torch.Tensor:
    """mean((v_student - (v_u + g (v_c - v_u)))^2); ``teacher()`` -> (v_c, v_u)
    runs without autograd, before the student."""
    with torch.no_grad():
        tcond, tuncond = teacher()
        v_teacher = tuncond + g * (tcond - tuncond)
    return torch.mean(torch.square(student() - v_teacher))


@torch.no_grad()
def _planned_norm(grads, stored, plan) -> torch.Tensor:
    """The global norm of gradients some of which are shards (``stored``):
    their squares sum over the storage ranks."""
    sq = sum(g.float().square().sum() for g, st in zip(grads, stored) if st)
    group = plan.storage()[0]
    if group is not None:
        dist.all_reduce(sq, group=group)
    return torch.sqrt(sum((g.float().square().sum() for g, st in zip(grads, stored) if not st),
                          sq))


def _update(loss_fn, trained, ema, tx, dcfg: DistillConfig, plan=None):
    """Gradients of loss_fn() w.r.t. the trained tensors, summed over the
    plan's data axes, clip, AdamW, EMA."""
    leaves = _leaves(trained)
    tx.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    for t in leaves:  # a tensor the loss does not reach: a zero gradient, as optax sees it
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    grads = [t.grad for t in leaves]
    norm = None
    if plan is not None:
        stored = _stored(trained)
        with torch.no_grad():
            plan.reduce_grads([g for g, st in zip(grads, stored) if not st])
            plan.reduce_grads([g for g, st in zip(grads, stored) if st], stored=True)
        if any(stored):
            norm = _planned_norm(grads, stored, plan)
    gnorm = clip_by_global_norm_(grads, dcfg.max_grad_norm, norm)
    tx.step()
    ema_update(ema, trained, dcfg.ema_decay)
    return loss.detach(), gnorm


def _refuse_ti2v(model_cfg: WanConfig) -> None:
    """Distillation draws one timestep a sample; Wan2.2 TI2V's image-to-video
    (per-frame timesteps, frame 0 held) has no training path here."""
    if model_cfg.model_type == "ti2v":
        raise NotImplementedError(
            f"distillation / LoRA / QLoRA of {model_cfg.name} (TI2V: per-frame timesteps, "
            "frame 0 held to the image) is not supported; it runs inference only")


def make_distill_step(model_cfg: WanConfig, dcfg: DistillConfig, tx, plan=None) -> Callable:
    """step(params, ema_params, opt_state, teacher_params, x0, noise, t,
    context, null_context, g) -> (params, ema_params, opt_state, loss,
    gnorm): every parameter of ``params`` (the optimizer's) trains. The
    step's loss function is ``step.loss_fn(params, teacher_params, x0, noise,
    t, context, null_context, g)``. ``plan``: a ShardingPlan (see the module
    docstring); both trees then hold this rank's storage."""
    _refuse_ti2v(model_cfg)

    def loss_fn(params, teacher_params, x0, noise, t, context, null_context, g):
        xt = _noised(x0, noise, t, dcfg)
        fwd = lambda p, c, **kw: dit_forward(p, model_cfg, xt, t, c, dcfg.seq_len,
                                             training=True, plan=plan, **kw)
        return _distill_loss(lambda: fwd(params, context, remat=dcfg.remat),
                             lambda: (fwd(teacher_params, context),
                                      fwd(teacher_params, null_context)), g)

    def step(params, ema_params, opt_state, teacher_params, x0, noise, t, context,
             null_context, g):
        loss, gnorm = _update(lambda: loss_fn(params, teacher_params, x0, noise, t, context,
                                              null_context, g), params, ema_params, tx, dcfg,
                              plan)
        return params, ema_params, opt_state, loss, gnorm

    step.loss_fn = loss_fn
    return step


def make_lora_distill_step(model_cfg: WanConfig, dcfg: DistillConfig, tx,
                           plan=None) -> Callable:
    """FP LoRA: step(lora, ema_lora, opt_state, base_params, x0, noise, t,
    context, null_context, g); the student is ``apply_lora(base_params,
    lora)`` (under FSDP merged into each gathered weight), the base the
    teacher. ``step.loss_fn(lora, base_params, ...)``."""
    _refuse_ti2v(model_cfg)

    def loss_fn(lora, base_params, x0, noise, t, context, null_context, g):
        xt = _noised(x0, noise, t, dcfg)
        fwd = lambda p, c, **kw: dit_forward(p, model_cfg, xt, t, c, dcfg.seq_len,
                                             training=True, plan=plan, **kw)
        return _distill_loss(lambda: fwd(apply_lora(base_params, lora), context,
                                         remat=dcfg.remat),
                             lambda: (fwd(base_params, context),
                                      fwd(base_params, null_context)), g)

    def step(lora, ema_lora, opt_state, base_params, x0, noise, t, context, null_context, g):
        loss, gnorm = _update(lambda: loss_fn(lora, base_params, x0, noise, t, context,
                                              null_context, g), lora, ema_lora, tx, dcfg, plan)
        return lora, ema_lora, opt_state, loss, gnorm

    step.loss_fn = loss_fn
    return step


def make_qlora_distill_step(model_cfg: WanConfig, dcfg: DistillConfig, tx,
                            plan=None) -> Callable:
    """QLoRA: step(lora, ema_lora, opt_state, params, qctx, x0, noise, t,
    context, null_context, g). ``qctx`` is the frozen base (an int8 QuantCtx,
    its FP weights may be stripped; ``params`` carries the leaves that are
    not quantized); the student runs it with the adapters merged into its
    state, the teacher without. ``step.loss_fn(lora, params, qctx, ...)``."""
    _refuse_ti2v(model_cfg)

    def loss_fn(lora, params, qctx, x0, noise, t, context, null_context, g):
        xt = _noised(x0, noise, t, dcfg)
        fwd = lambda ctx, c, **kw: dit_forward(params, model_cfg, xt, t, c, dcfg.seq_len,
                                               ctx=ctx, training=True, plan=plan, **kw)
        student_ctx = dataclasses.replace(
            qctx, state=merge_lora_into_quant_state(qctx.state, lora))
        return _distill_loss(lambda: fwd(student_ctx, context, remat=dcfg.remat),
                             lambda: (fwd(qctx, context), fwd(qctx, null_context)), g)

    def step(lora, ema_lora, opt_state, params, qctx, x0, noise, t, context, null_context, g):
        loss, gnorm = _update(lambda: loss_fn(lora, params, qctx, x0, noise, t, context,
                                              null_context, g), lora, ema_lora, tx, dcfg, plan)
        return lora, ema_lora, opt_state, loss, gnorm

    step.loss_fn = loss_fn
    return step


def distill_step(state: TrainState, step_fn: Callable, teacher_params,
                 batch: Dict[str, torch.Tensor], dcfg: DistillConfig
                 ) -> Tuple[TrainState, Dict[str, float]]:
    """One outer step: draw the guidance from the step count, run the step,
    advance the count."""
    g = draw_guidance(state.step, dcfg.cfg_mid)
    params, ema, opt_state, loss, gnorm = step_fn(
        state.params, state.ema_params, state.opt_state, teacher_params, batch["x0"],
        batch["noise"], batch["t"], batch["context"], batch["null_context"], g)
    new_state = TrainState(params, ema, opt_state, state.step + 1)
    return new_state, {"loss": float(loss), "grad_norm": float(gnorm), "guidance": g}
