"""Text-to-video denoise pipeline (counterpart of
wanq_tpu/pipelines/text2video.py).

The cond/uncond pair runs as one B=2 DiT forward per solver step
(``cfg_mode="batched"``) or as two B-sized forwards (``"sequential"``, the
reference's own schedule: the same math at half the peak activation
memory, which T2V-14B at 720p needs); the UniPC scheduler runs between
steps. One class serves FP, calibration, simulated and int8 inference
through the QuantCtx mode. Step caches (:class:`StepCachePolicy` on a static
schedule, :class:`AdaptiveCachePolicy` from the input drift) skip whole
forwards or the uncond branch; the per-step actions are ``full``, ``cond``
(one B-sized forward against the cached uncond) and ``reuse`` (no forward:
the last prediction, or a Lagrange forecast through the last executed
ones). ``sample_solver`` is UniPC or DPM++. ``quant_ctx_schedule`` switches
the QuantCtx by timestep (e.g. W8A8 at high noise, W4A8 below), and
:meth:`WanT2V.capture_attn_maps` captures pooled self-attention maps from
the deployed model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from wanq_tpu_torch.configs import WanConfig
from wanq_tpu_torch.models.dit import dit_forward
from wanq_tpu_torch.quant.qlinear import QuantCtx
from wanq_tpu_torch.solvers.dpm import (
    FlowDPMSolverMultistepScheduler,
    get_sampling_sigmas,
    retrieve_timesteps,
)
from wanq_tpu_torch.solvers.unipc import FlowUniPCMultistepScheduler
from wanq_tpu_torch.utils.trace import PIPE_STEP, span


def compute_target_shape(cfg: WanConfig, size: Tuple[int, int],
                         frame_num: int) -> Tuple[int, int, int, int]:
    """Latent shape (C, F, H, W)."""
    w, h = size
    return (cfg.z_dim, (frame_num - 1) // cfg.vae_stride[0] + 1,
            h // cfg.vae_stride[1], w // cfg.vae_stride[2])


def compute_seq_len(cfg: WanConfig, target_shape, sp_size: int = 1,
                    align: Optional[int] = None) -> int:
    """Token count rounded up to the sequence-parallel degree and, for long
    sequences, to 512 (the DiT pads and masks tokens past the valid length)."""
    _, f, h, w = target_shape
    tokens = (h // cfg.patch_size[1]) * (w // cfg.patch_size[2]) * f
    if align is None:
        align = 512 if tokens >= 4096 else 1
    m = math.lcm(sp_size, align)
    return int(math.ceil(tokens / m)) * m


def _check_order(order: int) -> None:
    if order not in (0, 1, 2):
        raise ValueError(f"order must be 0, 1 or 2, got {order}")


@dataclasses.dataclass(frozen=True)
class StepCachePolicy:
    """Step caching on a static schedule (beyond the reference, which runs
    the full CFG pair every step).

    * ``cfg_interval`` K: the uncond branch is refreshed every K-th model
      evaluation; in between only the cond branch runs (a B-sized forward)
      and combines with the cached uncond.
    * ``reuse_interval`` R: the model runs every R-th step; the steps
      between reuse the last noise prediction (or forecast it, ``order``).

    ``warmup`` / ``tail`` steps at the ends of the trajectory always run the
    full pair. ``order`` 1 / 2 extrapolates a skipped step's prediction to
    its timestep through the last order + 1 executed predictions (Lagrange);
    ``max_horizon`` > 0 caps the order-1 coefficient (t - t1) / (t1 - t0).
    """

    cfg_interval: int = 1
    reuse_interval: int = 1
    warmup: int = 4
    tail: int = 4
    order: int = 0
    max_horizon: float = 0.0

    def __post_init__(self):
        _check_order(self.order)

    def plan(self, n_steps: int) -> List[str]:
        """Per-step actions 'full' | 'cond' | 'reuse'. The cfg cycle counts
        model evaluations (steps that are not reused), so the two mechanisms
        interleave instead of landing on the same offsets."""
        acts = []
        n_eval = 0
        for i in range(n_steps):
            if i < self.warmup or i >= n_steps - self.tail:
                acts.append("full")
                n_eval += 1
                continue
            if self.reuse_interval > 1 and (i - self.warmup) % self.reuse_interval:
                acts.append("reuse")
                continue
            acts.append("cond" if self.cfg_interval > 1 and n_eval % self.cfg_interval
                        else "full")
            n_eval += 1
        return acts

    @property
    def active(self) -> bool:
        return self.cfg_interval > 1 or self.reuse_interval > 1


@dataclasses.dataclass(frozen=True)
class AdaptiveCachePolicy:
    """Step reuse decided by the trajectory (TeaCache-style). Each step
    measures the relative L1 drift of the model input against the previous
    step's, d = mean|x_i - x_{i-1}| / (mean|x_{i-1}| + 1e-8), maps it through
    the polynomial ``poly`` (``np.polyval`` coefficients; identity by
    default, a fitted one turns ``threshold`` into an output-space
    tolerance, see :func:`fit_drift_poly`) and adds it to an accumulator;
    while the accumulator stays below ``threshold`` the step reuses the last
    prediction, else the model runs and the accumulator resets.
    ``cfg_interval``, ``warmup`` / ``tail``, ``order`` and ``max_horizon``
    act as in :class:`StepCachePolicy`."""

    threshold: float = 0.08
    warmup: int = 4
    tail: int = 4
    cfg_interval: int = 1
    poly: Tuple[float, ...] = (1.0, 0.0)
    order: int = 0
    max_horizon: float = 0.0

    def __post_init__(self):
        _check_order(self.order)

    @property
    def active(self) -> bool:
        return self.threshold > 0.0 or self.cfg_interval > 1


def _lagrange_weights(ts: List[float], t: float) -> List[float]:
    """Extrapolation weights at ``t`` for the distinct nodes ``ts``."""
    return [math.prod((t - tj) / (ti - tj) for tj in ts if tj != ti) for ti in ts]


def _forecast(exec_hist, t: float, policy) -> torch.Tensor:
    """A skipped step's noise prediction at timestep ``t`` from the last
    executed (timestep, prediction) pairs: linear through two (the
    coefficient capped by ``max_horizon``), quadratic through three."""
    if len(exec_hist) == 2:
        (t0, p0), (t1, p1) = exec_hist
        c = (t - t1) / (t1 - t0)
        if policy.max_horizon > 0.0:
            c = min(c, policy.max_horizon)
        weights = [-c, 1.0 + c]
    else:
        weights = _lagrange_weights([ti for ti, _ in exec_hist], t)
    out = None
    for w, (_, p) in zip(weights, exec_hist):
        term = p * torch.tensor(w, dtype=torch.float32, device=p.device)
        out = term if out is None else out + term
    return out


def _rel_l1(a: torch.Tensor, ref: torch.Tensor) -> float:
    """mean|a - ref| / (mean|ref| + 1e-8), read to the host."""
    return float(((a - ref).abs().mean() / (ref.abs().mean() + 1e-8)).item())


def fit_drift_poly(pipe, context, context_null, degree: int = 4,
                   **gen_kw) -> Tuple[float, ...]:
    """Fit :class:`AdaptiveCachePolicy`'s polynomial on one trajectory: an
    all-evaluate adaptive pass records, for each pair of consecutive
    executed forwards, the input drift ``d`` and the realized output change
    ``o``; least squares fits o ~ polyval(poly, d)."""
    pol = AdaptiveCachePolicy(threshold=1e-12, warmup=1, tail=0)
    pipe.generate(context, context_null, cache_policy=pol, **gen_kw)
    pts = [(e["d"], e["o"]) for e in (pipe.last_adaptive_trace or []) if "o" in e]
    if len(pts) < 2:
        raise ValueError(f"need >= 2 executed-step pairs to fit, got {len(pts)} "
                         "(too few sampling_steps?)")
    d = np.asarray([p[0] for p in pts])
    o = np.asarray([p[1] for p in pts])
    return tuple(float(c) for c in np.polyfit(d, o, min(degree, len(pts) - 1)))


def simulate_adaptive_actions(policy: AdaptiveCachePolicy, drifts: List[float]) -> List[str]:
    """The actions :class:`AdaptiveCachePolicy` takes on the per-step input
    drifts ``drifts`` (``drifts[i]``: step i's input against step i-1's;
    index 0 is ignored, the first step always runs): the accumulator
    arithmetic of :meth:`WanT2V._generate_cached`, replayed."""
    n = len(drifts)
    acc, n_eval = 0.0, 0
    acts: List[str] = []
    for i in range(n):
        if i < policy.warmup or i >= n - policy.tail or i == 0:
            act = "full"
        else:
            acc += float(np.polyval(policy.poly, drifts[i]))
            if acc < policy.threshold:
                act = "reuse"
            elif policy.cfg_interval > 1 and n_eval % policy.cfg_interval:
                act = "cond"
            else:
                act = "full"
        if act != "reuse":
            acc = 0.0
            n_eval += 1
        acts.append(act)
    return acts


@dataclasses.dataclass
class WanT2V:
    """Latent-space pipeline; text encoding and VAE decode are not part of
    it (the CLIs take random or precomputed text states). After a cached
    run, ``last_cache_stats`` counts its actions and, under an adaptive
    policy, ``last_adaptive_trace`` holds one entry per decided step: the
    drift ``d``, the accumulator ``acc``, the action ``act`` and, where the
    model ran again, the realized output change ``o``.

    ``quant_ctx_schedule``: timestep-aware mixed precision, a descending
    list ``[(t_threshold, ctx), ...]``; a step runs the ctx of the first
    entry with ``t >= t_threshold`` (an fp-mode ctx or None: the plain
    forward), ``quant_ctx`` when none matches. Calibration ignores it.

    Multi-GPU (``shardings``, a ``parallel/sharding.py`` ShardingPlan): every
    rank builds the pipeline with the same plan over its storage of the
    params, draws the same latents from the seed and gets the same latents
    back; the sequence rounds up to a multiple of the plan's sp x ring."""

    config: WanConfig
    params: Dict[str, Any]
    quant_ctx: Optional[QuantCtx] = None
    device: Any = "cuda"
    quant_ctx_schedule: Optional[List[Tuple[float, Optional[QuantCtx]]]] = None
    shardings: Optional[Any] = None
    last_cache_stats: Optional[Dict[str, int]] = dataclasses.field(default=None, init=False)
    last_adaptive_trace: Optional[List[Dict[str, Any]]] = dataclasses.field(
        default=None, init=False)

    def __post_init__(self):
        if self.quant_ctx_schedule:
            threshs = [t for t, _ in self.quant_ctx_schedule]
            if threshs != sorted(threshs, reverse=True):
                raise ValueError("quant_ctx_schedule thresholds must be descending "
                                 f"(the first match wins); got {threshs}")

    @property
    def sp_size(self) -> int:
        """The degree the sequence rounds up to: the plan's sp x ring, 1 without one."""
        return 1 if self.shardings is None else self.shardings.sp_size

    def _ctx_at(self, t: float, ctx: Optional[QuantCtx]) -> Optional[QuantCtx]:
        """The ctx a step at timestep ``t`` runs: the schedule's (as a plain
        forward unless it is a sim or int8 ctx), else ``ctx``."""
        if not self.quant_ctx_schedule:
            return ctx
        sched = self.quant_ctx
        for thresh, c in self.quant_ctx_schedule:
            if t >= thresh:
                sched = c
                break
        return sched if sched is not None and sched.mode in ("sim", "int8") else None

    def _timesteps(self, latents, t: float) -> torch.Tensor:
        """The timesteps a forward of ``latents`` at step ``t`` takes: one a
        sample, [B] on the device (the TI2V pipeline gives one a frame)."""
        return torch.full((latents.shape[0],), float(t), dtype=torch.float32,
                          device=latents.device)

    def _held(self, latents):
        """The latents the loop carries into a step: the initial draw and
        each solver step's output, as they are (the TI2V pipeline holds its
        conditioning frame)."""
        return latents

    def _cond(self, latents, t: float, context, ctx: Optional[QuantCtx], seq_len: int,
              extra: Optional[Dict[str, torch.Tensor]] = None):
        """One B-sized forward. ``extra``: more dit_forward inputs of the
        batch (the i2v conditioning ``y`` and ``clip_fea``)."""
        return dit_forward(self.params, self.config, latents, self._timesteps(latents, t),
                           context, seq_len, ctx=ctx, plan=self.shardings, **(extra or {}))

    def _split(self, latents, t: float, context, context_null, ctx: Optional[QuantCtx],
               seq_len: int, sequential: bool = False,
               extra: Optional[Dict[str, torch.Tensor]] = None):
        """(cond, uncond): one [2B] forward, or two B-sized ones when
        ``sequential``."""
        if sequential:
            return (self._cond(latents, t, context, ctx, seq_len, extra),
                    self._cond(latents, t, context_null, ctx, seq_len, extra))
        b = latents.shape[0]
        extra2 = {k: torch.cat([v, v], dim=0) for k, v in (extra or {}).items()}
        out = self._cond(torch.cat([latents, latents], dim=0), t,
                         torch.cat([context, context_null], dim=0), ctx, seq_len, extra2)
        return out[:b], out[b:]

    def _step(self, latents, t: float, context, context_null, guide_scale: float,
              ctx: Optional[QuantCtx], seq_len: int, sequential: bool = False,
              extra: Optional[Dict[str, torch.Tensor]] = None):
        """One CFG step's noise prediction."""
        cond, uncond = self._split(latents, t, context, context_null, ctx, seq_len, sequential,
                                   extra)
        return uncond + guide_scale * (cond - uncond)

    def _make_scheduler(self, sample_solver: str, sampling_steps: int, shift: float):
        """The solver, its timesteps set: ``unipc`` or ``dpm++``."""
        n_train = self.config.num_train_timesteps
        if sample_solver == "unipc":
            sch = FlowUniPCMultistepScheduler(num_train_timesteps=n_train, shift=1.0)
            sch.set_timesteps(sampling_steps, shift=shift)
        elif sample_solver == "dpm++":
            sch = FlowDPMSolverMultistepScheduler(num_train_timesteps=n_train, shift=1.0)
            retrieve_timesteps(sch, sigmas=get_sampling_sigmas(sampling_steps, shift))
        else:
            raise ValueError(f"unknown sample_solver {sample_solver!r}")
        return sch

    def _deployed_ctx(self) -> Optional[QuantCtx]:
        """The ctx the denoise loop runs: a sim or int8 one, or an fp-mode one
        that carries the temporal window; else None."""
        q = self.quant_ctx
        if q is not None and (q.mode in ("sim", "int8") or q.attn_window is not None):
            return q
        return None

    def _initial_latents(self, shape, seed: int, noise: Optional[torch.Tensor]):
        """``noise`` on the device, or a torch.Generator draw from ``seed``
        (a random seed when negative)."""
        dev = torch.device(self.device)
        if noise is None:
            seed = seed if seed >= 0 else int(np.random.randint(0, 2**31))
            gen = torch.Generator(device=dev).manual_seed(seed)
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise {tuple(noise.shape)} != {tuple(shape)}")
        return noise.to(device=dev, dtype=torch.float32)

    def generate(
        self,
        context: torch.Tensor,
        context_null: torch.Tensor,
        size: Tuple[int, int] = (832, 480),
        frame_num: int = 81,
        shift: float = 5.0,
        sample_solver: str = "unipc",
        sampling_steps: int = 50,
        guide_scale: float = 5.0,
        seed: int = -1,
        collect_calib: bool = False,
        noise: Optional[torch.Tensor] = None,
        cache_policy=None,
        cfg_mode: str = "batched",
        on_step: Optional[Callable[[int, float, torch.Tensor], None]] = None,
    ):
        """Denoise loop. context / context_null: [B, text_len, text_dim].
        Returns latents [B, C, F, h, w] (and the calibration stats
        {layer: [T, C]} when ``collect_calib``). ``noise`` replaces the
        initial draw (a torch.Generator seeded with ``seed``), e.g. with
        another implementation's draw. ``sample_solver``: ``unipc`` or
        ``dpm++``. ``cache_policy`` (a :class:`StepCachePolicy` or
        :class:`AdaptiveCachePolicy`) caches steps when active; ``cfg_mode``
        is ``"batched"`` (one [2B] forward a step) or ``"sequential"`` (two
        B-sized forwards). Calibration takes neither a cache nor sequential
        CFG: it observes every site of the batched pair every step.
        ``on_step(i, t, latents)`` runs after each solver step."""
        if cfg_mode not in ("batched", "sequential"):
            raise ValueError(f"unknown cfg_mode {cfg_mode!r}")
        sequential = cfg_mode == "sequential"
        if sequential and collect_calib:
            raise ValueError("calibration observes the cond/uncond pair in one batched "
                             "forward; run it with cfg_mode='batched'")
        cached = cache_policy is not None and cache_policy.active
        if cached and collect_calib:
            raise ValueError("calibration must observe every site every step; run it "
                             "without a cache_policy")
        cfg = self.config
        dev = torch.device(self.device)
        target_shape = compute_target_shape(cfg, size, frame_num)
        seq_len = compute_seq_len(cfg, target_shape, self.sp_size)
        latents = self._held(self._initial_latents((context.shape[0], *target_shape), seed,
                                                   noise))
        context = context.to(dev)
        context_null = context_null.to(dev)

        sch = self._make_scheduler(sample_solver, sampling_steps, shift)
        if collect_calib:
            if self.quant_ctx is None or self.quant_ctx.mode != "calib":
                raise ValueError("collect_calib needs a calib-mode quant_ctx")
            ctx = self.quant_ctx
        else:
            ctx = self._deployed_ctx()

        with torch.no_grad():
            if cached:
                return self._generate_cached(cache_policy, sch, latents, ctx, context,
                                             context_null, guide_scale, seq_len,
                                             sequential, on_step)
            all_stats: Dict[str, List[np.ndarray]] = {}
            # GPTQ input Hessians sum over the sweep in a running accumulator
            # on the device ([C, C] f64 each: no per-step host copy)
            hess: Dict[str, torch.Tensor] = {}
            for i, t in enumerate(sch.timesteps):
                with span(PIPE_STEP):
                    step_ctx = ctx if collect_calib else self._ctx_at(float(t), ctx)
                    noise_pred = self._step(latents, float(t), context, context_null, guide_scale,
                                            step_ctx, seq_len, sequential)
                    if collect_calib:
                        for k, v in ctx.collect.items():
                            if k.endswith(".hess"):
                                hess[k] = v if k not in hess else hess[k] + v
                            else:
                                all_stats.setdefault(k, []).append(v.float().cpu().numpy())
                        ctx.collect.clear()
                    latents = self._held(sch.step(noise_pred, int(t), latents))
                if on_step is not None:
                    on_step(i, float(t), latents)
        if collect_calib:
            return latents, {**{k: np.stack(v, axis=0) for k, v in all_stats.items()}, **hess}
        return latents

    def _generate_cached(self, policy, sch, latents, ctx, context, context_null,
                         guide_scale: float, seq_len: int, sequential: bool, on_step,
                         extra: Optional[Dict[str, torch.Tensor]] = None):
        """The denoise loop under a step cache. A static policy plans its
        actions up front; an adaptive one decides each step from the input
        drift, one scalar read a step. A ``full`` step runs the pair (as
        ``cfg_mode`` says), a ``cond`` step one B-sized forward against the
        last uncond, a ``reuse`` step no forward. ``extra``: the i2v
        conditioning of every forward."""
        timesteps = sch.timesteps
        n_steps = len(timesteps)
        adaptive = isinstance(policy, AdaptiveCachePolicy)
        actions = None if adaptive else policy.plan(n_steps)
        acc, n_eval = 0.0, 0
        x_prev = prev_exec_pred = last_uncond = last_pred = None
        trace: List[Dict[str, Any]] = []
        stats = {"full": 0, "cond": 0, "reuse": 0}
        # the last order + 1 executed (t, prediction) pairs: forecasts come
        # from model outputs only, never from earlier forecasts
        exec_hist: List[Tuple[float, torch.Tensor]] = []
        for i, t in enumerate(timesteps):
            with span(PIPE_STEP):
                t = float(t)
                step_ctx = self._ctx_at(t, ctx)
                if not adaptive:
                    act = actions[i]
                elif i < policy.warmup or i >= n_steps - policy.tail or x_prev is None:
                    act = "full" if (i < policy.warmup or i >= n_steps - policy.tail
                                     or last_uncond is None) else (
                        "cond" if policy.cfg_interval > 1 and n_eval % policy.cfg_interval
                        else "full")
                else:
                    d = _rel_l1(latents, x_prev)
                    acc += float(np.polyval(policy.poly, d))
                    if acc < policy.threshold:
                        act = "reuse"
                    elif policy.cfg_interval > 1 and n_eval % policy.cfg_interval:
                        act = "cond"
                    else:
                        act = "full"
                    trace.append({"step": i, "d": d, "acc": acc, "act": act})
                if act == "reuse" and last_pred is not None:
                    if policy.order and len(exec_hist) >= 2:
                        noise_pred = _forecast(exec_hist[-(policy.order + 1):], t, policy)
                    else:
                        noise_pred = last_pred
                elif act == "cond" and last_uncond is not None:
                    cond = self._cond(latents, t, context, step_ctx, seq_len, extra)
                    noise_pred = last_uncond + guide_scale * (cond - last_uncond)
                else:
                    act = "full"
                    cond, last_uncond = self._split(latents, t, context, context_null, step_ctx,
                                                    seq_len, sequential, extra)
                    noise_pred = last_uncond + guide_scale * (cond - last_uncond)
                if adaptive and act != "reuse":
                    # the realized output change between consecutive executed
                    # forwards: what fit_drift_poly pairs with d
                    if trace and trace[-1]["step"] == i and prev_exec_pred is not None:
                        trace[-1]["o"] = _rel_l1(noise_pred, prev_exec_pred)
                    prev_exec_pred = noise_pred
                    acc = 0.0
                    n_eval += 1
                if policy.order and act != "reuse":
                    exec_hist.append((t, noise_pred))
                    del exec_hist[:-(policy.order + 1)]
                stats[act] += 1
                last_pred = noise_pred
                x_prev = latents
                latents = self._held(sch.step(noise_pred, int(t), latents))
            if on_step is not None:
                on_step(i, t, latents)
        self.last_cache_stats = stats
        self.last_adaptive_trace = trace if adaptive else None
        return latents

    def capture_attn_maps(self, context: torch.Tensor, size: Tuple[int, int] = (832, 480),
                          frame_num: int = 81, pool: int = 256, reduce: str = "mean",
                          t: float = 500.0, seed: int = 0,
                          latents: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
        """One forward through the deployed model (fp, sim or int8
        ``quant_ctx``) returning {block.self_attn: [H, S/pool, S/pool]}
        pooled post-softmax self-attention maps: the input of
        ``quant.attn.select_temporal_windows`` where no FP copy of the model
        runs a calibration sweep. The forward runs dense whatever the ctx's
        window, and the maps come from the unscaled q, as calibration's do
        (wanq_tpu's deployed capture scales q twice). ``latents`` replaces
        the draw from ``seed``."""
        cfg = self.config
        target_shape = compute_target_shape(cfg, size, frame_num)
        seq_len = compute_seq_len(cfg, target_shape, self.sp_size)
        context = context.to(torch.device(self.device))
        latents = self._initial_latents((context.shape[0], *target_shape), seed, latents)
        base = self.quant_ctx if self.quant_ctx is not None else QuantCtx(mode="fp")
        cctx = dataclasses.replace(base, collect={}, attn_map_pool=pool,
                                   attn_map_reduce=reduce, attn_window=None)
        with torch.no_grad():
            self._cond(latents, t, context, cctx, seq_len)
        maps = {k[: -len(".attn_map")]: v.float().cpu().numpy()
                for k, v in cctx.collect.items() if k.endswith(".attn_map")}
        if not maps:
            raise RuntimeError("no attention maps captured: the forward never reached the "
                               "pooled-map hook (models/dit.py _self_attention)")
        return maps

    def collect_calibration(self, context, context_null, sampling_steps: int = 30,
                            **kw) -> Dict[str, np.ndarray]:
        """FP denoise sweep returning {layer: [T, C]} statistics, one row per
        batched CFG step, and {layer.hess: [C, C]} input Hessians summed over
        the steps, on the device (with the ctx's ``hessian_regex``)."""
        if self.quant_ctx is None or self.quant_ctx.mode != "calib":
            raise ValueError("collect_calibration needs a calib-mode quant_ctx")
        _, stats = self.generate(context, context_null, sampling_steps=sampling_steps,
                                 collect_calib=True, **kw)
        return stats
