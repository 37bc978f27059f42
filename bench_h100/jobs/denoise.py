"""Job kind ``denoise``: quantized text-to-video denoise steps through the
program's ``WanT2V.generate`` on an int8 ``QuantCtx``, built as the
program's ``quant_generate`` builds it.

The traffic's ``generate`` entry passes to ``generate`` as it stands (with
the video's size), its optional ``ctx`` entry to the ``QuantCtx`` (e.g.
``attn_window``, K4's band mode), so a cell of another solver setting or a
temporal window is a data file.

Set-up (timed as ``setup_s``): the weights drawn on the card from the seed;
a calibration sweep of ``calib_steps`` through ``collect_calibration`` on
inputs drawn from the seed; ``prepare_quant_state`` under the cell's scheme,
``strip_quantized_weights`` where asked; then ``warmup_steps`` denoise steps of video 0.

Window: videos one after another (closed loop), each with its own noise and
text states from the seed, ``steps`` UniPC steps of batched CFG, until a step
ends after ``--seconds``. The step time is the window's wall time over the
steps it completed; the host waits for the card after each step. Each step's
CFG pair (the conditional and unconditional velocities the model produced)
and the latents the step returns are copied to the host for the check.

Check (after the window, the program's state freed): the reference
(``reference/``) draws the weights again, calibrates itself on the same
inputs, and computes the CFG pair at one step drawn from the seed, from the
program's latents at that step; it combines each step's pair of the program
(guidance) and replays its UniPC on them. Three numbers, each beside its
limit in the cell file: the pair's worst relative L2 gap (``forward_rel_l2``;
the whole DiT forward of both rows), the latents' widest relative L2 gap over
the window's steps (``sampler_rel_l2``: the guidance combine and the solver),
and the count of timesteps that differ from the reference's schedule. The
pair is compared before guidance, which multiplies each row's rounding gap
about seven-fold at guidance 5 but not a fault that moves both rows."""

from __future__ import annotations

import gc
import random
from typing import Dict

import arith
import draw
from harness import log, now, rel_l2, run_window
from reference.scheme import load_scheme
from reference.unipc import replay, sigmas_and_timesteps
from reference.wan import WanReference, guided, set_full_f32

KIND = "serve"
RATE = "denoise_s_per_step"


# the program's methods through which the window's records are taken
HOOKS = ("_split", "_make_scheduler")


class _Closed(Exception):
    """Raised from the step callback once the window's time has passed."""


def wan_config(cfg: Dict):
    """The program's WanConfig of a configuration file."""
    from wanq_tpu_torch.configs import WanConfig

    keys = ("text_len", "text_dim", "z_dim", "in_dim", "out_dim", "dim", "ffn_dim", "freq_dim",
            "num_heads", "num_layers", "qk_norm", "cross_attn_norm", "eps",
            "num_train_timesteps", "param_dtype", "residual_dtype")
    return WanConfig(name=cfg["name"], model_type="t2v", vae_stride=tuple(cfg["vae_stride"]),
                     patch_size=tuple(cfg["patch_size"]),
                     window_size=tuple(cfg["window_size"]), **{k: cfg[k] for k in keys})


def _gen_kw(traffic: Dict) -> Dict:
    """``generate``'s keywords: the video's size and the traffic's
    ``generate`` entry, passed through as it stands."""
    return dict(size=(traffic["width"], traffic["height"]), frame_num=traffic["frames"],
                **traffic["generate"])


def _sequential(traffic: Dict) -> bool:
    return traffic["generate"].get("cfg_mode", "batched") == "sequential"


def setup(job) -> Dict:
    """The program's pipeline on the quantized state, warmed up."""
    import torch

    from wanq_tpu_torch.models.dit import linear_layer_names
    from wanq_tpu_torch.pipelines.text2video import WanT2V
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state, strip_quantized_weights
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    set_full_f32()
    cfg, traffic, dev = job.cfg, job.spec["traffic"], job.device
    wcfg = wan_config(cfg)
    t0 = now()
    params = draw.draw_params(cfg, job.seed, dev)
    noise, text, null = draw.draw_calibration(cfg, traffic, job.seed, dev)
    t1 = now()
    calib = WanT2V(wcfg, params, quant_ctx=QuantCtx(mode="calib", collect_minmax=True),
                   device=dev).collect_calibration(
        text, null, sampling_steps=traffic["calib_steps"], noise=noise,
        **{k: v for k, v in _gen_kw(traffic).items() if k != "cfg_mode"})
    t2 = now()
    qcfg = QuantConfig.from_yaml(job.scheme_path)
    policies, state, rotations = prepare_quant_state(params, linear_layer_names(wcfg), qcfg,
                                                     calib=calib, targets="int8")
    if job.spec.get("strip_fp", False):
        params = strip_quantized_weights(params, policies)
    del calib, noise, text, null
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    t3 = now()
    ctx = QuantCtx(mode="int8", policies=policies, state=state, rotations=rotations,
                   attn=qcfg.attn_cfg, cross_attn=qcfg.cross_attn_cfg,
                   **traffic.get("ctx", {}))
    pipe = WanT2V(wcfg, params, quant_ctx=ctx, device=dev)
    run = {"pipe": pipe, "pending": [], "record": None, "buffers": []}
    _record_solver_calls(run)
    noise, text, null = draw.draw_video(cfg, traffic, job.seed, 0, dev)
    _steps(job, run, noise, text, null, limit=traffic["warmup_steps"])
    t4 = now()
    run["buffers"] = _host_buffers(job, noise.shape, (t4 - t3) / traffic["warmup_steps"])
    log(f"set-up: weights and inputs {t1 - t0:.2f} s, calibration {t2 - t1:.2f} s, PTQ and "
        f"strip {t3 - t2:.2f} s, warm-up ({traffic['warmup_steps']} steps) {t4 - t3:.2f} s")
    return run


def _host_buffers(job, shape, step_s: float):
    """Page-locked host tensors for the window's records (each step's pair and
    latents), made before it opens: twice the steps the warm-up's pace puts in
    the window, and two more. The card copies into them without the host, so
    a step's record costs about a millisecond of copying and no host time."""
    import torch

    if job.device == "cpu":
        return []
    n = 3 * (2 * int(job.seconds / max(step_s, 1e-3)) + 2)
    return [torch.empty(shape, dtype=torch.float32, pin_memory=True) for _ in range(n)]


def _to_host(run: Dict, t):
    """t (f32) copied to the host: into the next page-locked buffer, without
    waiting, when one is left (the step's synchronize follows); else a plain
    copy."""
    if run["buffers"]:
        return run["buffers"].pop().copy_(t.detach(), non_blocking=True)
    return t.detach().float().cpu()


def _record_solver_calls(run: Dict) -> None:
    """Keep each step's CFG pair and its solver call's (timestep, latents out)
    until the step callback reads them: the pipeline's pair and the scheduler
    it makes are wrapped, their arithmetic untouched. The benchmark reads the
    program here, through ``WanT2V._split`` and ``WanT2V._make_scheduler``;
    without them it stops with the reason."""
    pipe, pending = run["pipe"], run["pending"]
    missing = [a for a in HOOKS if not callable(getattr(pipe, a, None))]
    if missing:
        raise RuntimeError(f"WanT2V has no {missing}: the benchmark records each step's CFG "
                           f"pair and solver call through {HOOKS} (bench_h100/README.md)")
    make, split = pipe._make_scheduler, pipe._split

    def split_recorded(*args, **kw):
        cond, uncond = split(*args, **kw)
        run["pair"] = (cond, uncond)
        return cond, uncond

    def make_recorded(*args, **kw):
        sch = make(*args, **kw)
        inner = sch.step

        def step(model_output, timestep, sample):
            out = inner(model_output, timestep, sample)
            pending.append((int(timestep), out))
            return out

        sch.step = step
        return sch

    pipe._make_scheduler = make_recorded
    pipe._split = split_recorded


def _steps(job, run: Dict, noise, text, null, limit=None, deadline=None, marks=None,
           video: int = 0, counts=None):
    """One video through ``generate``, stopped after ``limit`` steps or at the
    first step that ends past ``deadline``; True when stopped. Steps are
    recorded when ``run['record']`` is a list."""
    import torch

    from wanq_tpu_torch.ops import _lib

    traffic, dev = job.spec["traffic"], job.device
    done = [0]

    def on_step(i, t, latents):
        if dev != "cpu":
            torch.cuda.synchronize()
        stamp = now()
        if not run["pending"] or "pair" not in run:
            raise RuntimeError(f"step {i} of generate did not go through both WanT2V._split "
                               f"(the CFG pair) and its scheduler's step, which the benchmark "
                               f"records ({HOOKS}; bench_h100/README.md)")
        timestep, out = run["pending"].pop()
        run["pending"].clear()
        cond, uncond = run.pop("pair")
        if run["record"] is not None:
            run["record"].append({"video": video, "step": i, "t": timestep,
                                  "c": _to_host(run, cond), "u": _to_host(run, uncond),
                                  "x": _to_host(run, out)})
        if marks is not None:
            marks.append(stamp)
            counts.append(_lib.launch_counts())
        done[0] += 1
        if (limit is not None and done[0] >= limit) or (deadline is not None
                                                        and stamp >= deadline):
            raise _Closed

    try:
        run["pipe"].generate(text, null, sampling_steps=traffic["steps"], noise=noise,
                             on_step=on_step, **_gen_kw(traffic))
        return False
    except _Closed:
        return True


def window(job, run: Dict) -> Dict:
    """Videos one after another until a step ends after ``job.seconds``."""
    cfg, traffic = job.cfg, job.spec["traffic"]
    run["record"] = []

    def loop(deadline, marks, counts):
        video = 0
        while True:
            noise, text, null = draw.draw_video(cfg, traffic, job.seed, video, job.device)
            if _steps(job, run, noise, text, null, deadline=deadline, marks=marks,
                      video=video, counts=counts):
                return
            video += 1

    return run_window(job, loop, 2 if _sequential(traffic) else 1)


def trace_context(job, win: Dict) -> Dict:
    """What the per-layer readers read: the trace, the step count and the
    arithmetic of one step's work (one CFG pair: a batch of two, or two of
    one under sequential CFG)."""
    traffic, scheme = job.spec["traffic"], load_scheme(job.scheme_path)
    batch, forwards = (1, 2) if _sequential(traffic) else (2, 1)
    work = arith.forward_work(job.cfg, scheme, traffic, batch)
    attn = arith.attention_calls(job.cfg, traffic, batch)
    gemm = arith.int_gemm_calls(job.cfg, scheme, traffic, batch)
    return {"kind": KIND, **win["trace"], "steps": win["steps"],
            "least_s_per_step": forwards * arith.least_time_s(work),
            "attn_bound_s_per_step": forwards * sum(c["bound_s"] * c["count"] for c in attn),
            "gemm_bound_s_per_step": forwards * sum(c["bound_s"] * c["count"] for c in gemm),
            "step_s": win["window_s"] / win["steps"]}


def free(run: Dict):
    """Drop the program's state before the reference runs; returns what the
    check reads (the window's record)."""
    import torch

    record = run["record"]
    run.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # the last step's copies to the host
        torch.cuda.empty_cache()
    return record


def check(job, record, control=None) -> Dict[str, float]:
    """The three numbers compared (see the module's docstring). ``control``:
    one of the cell's controls, the reference one precision below the
    configuration's in the forward; the guidance and the sampler stay f32,
    so a control has to fail through ``forward_rel_l2`` itself."""
    import torch

    cfg, traffic, dev = job.cfg, job.spec["traffic"], job.device
    gen = traffic["generate"]
    steps, shift, g = traffic["steps"], gen["shift"], gen["guide_scale"]
    _, timesteps = sigmas_and_timesteps(steps, shift, cfg["num_train_timesteps"])
    mismatches = sum(int(r["t"] != int(timesteps[r["step"]])) for r in record)
    # the latents after each step: the program's pairs combined and the
    # sampler replayed on them
    widest, inputs = 0.0, {}
    for video in sorted({r["video"] for r in record}):
        rows = [r for r in record if r["video"] == video]
        noise, _, _ = draw.draw_video(cfg, traffic, job.seed, video, dev)
        velocities = [guided(r["c"].to(dev), r["u"].to(dev), g) for r in rows]
        want = replay(noise.float(), velocities, steps, shift)
        for r, w in zip(rows, want):
            widest = max(widest, rel_l2(r["x"].to(dev), w.float()))
        inputs[video] = [noise] + [r["x"] for r in rows]
    # the pair at one step drawn from the seed
    pick = record[random.Random(job.seed).randrange(len(record))]
    set_full_f32()
    params = draw.draw_params(cfg, job.seed, dev)
    ref = WanReference(params, cfg, load_scheme(job.scheme_path), control=control,
                       window=traffic.get("ctx", {}).get("attn_window"))
    with torch.no_grad():
        c_noise, c_text, c_null = draw.draw_calibration(cfg, traffic, job.seed, dev)
        _, c_ts = sigmas_and_timesteps(traffic["calib_steps"], shift, cfg["num_train_timesteps"])
        ref.calibrate(c_noise, float(c_ts[0]), c_text, c_null)
        _, text, null = draw.draw_video(cfg, traffic, job.seed, pick["video"], dev)
        x_in = inputs[pick["video"]][pick["step"]].to(dev).float()
        cond, uncond = ref.pair(x_in, float(timesteps[pick["step"]]), text, null)
    gap = max(rel_l2(pick["c"].to(dev), cond), rel_l2(pick["u"].to(dev), uncond))
    del ref, params
    log(f"check{f' (control {control})' if control else ''}: video {pick['video']} step "
        f"{pick['step']} (t {pick['t']}): the CFG pair's worst rel L2 {gap:.6g}; sampler widest "
        f"rel L2 {widest:.6g} over {len(record)} steps; timestep mismatches {mismatches}")
    return {"forward_rel_l2": gap, "sampler_rel_l2": widest, "timestep_mismatches": mismatches}
