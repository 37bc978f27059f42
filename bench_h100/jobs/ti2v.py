"""Job kind ``ti2v``: quantized image-to-video denoise steps of Wan2.2
TI2V-5B through the program's ``WanTI2V.generate`` on an int8 ``QuantCtx``,
built as the ``denoise`` job builds it (``jobs/denoise.py``, whose records,
host buffers and freeing it reuses).

Each video (and the calibration sweep) has its own noise, text states and
conditioning latent, a seeded N(0, 1) draw [z_dim, 1, h, w] in place of the
Wan2.2 VAE's encoding of an image (no such VAE is in the repository). The
program holds latent frame 0 to it and runs every forward on one timestep a
latent frame, 0 for frame 0.

Window: as the denoise job's (videos back to back, whole steps, the host
waiting for the card after each step); each step's CFG pair and the latents
the loop carries on (frame 0 held) are copied to the host for the check. The
launch check of the harness compares the per-block counts, the per-frame
modulation's ``ln_modulate_quant_rows`` and ``gate_residual_rows`` among
them; the time MLP's ``time_embedding_rows`` is counted a forward, not a
block, so the job takes it out of the window's counts before the harness
reads them and logs its own check of it against the cell's
``launches_per_forward``.

Traced, it also credits the device time to the program's spans
(``spans.reduce_trace_with_spans`` in place of ``harness.reduce_trace``
around its window), for ``embed_head_ms.serve``, and gives the step's K1 and
K13 byte bound (``arith_ti2v.py``) for ``modulate_roofline.serve``.

Check (the program's state freed): the reference (``reference/ti2v.py``)
draws the weights again, calibrates itself on the same inputs, and computes
the CFG pair at one step drawn from the seed from the program's latents at
that step with per-token timesteps, frame 0 at 0; it combines each step's
pair of the program and replays UniPC with frame 0 held. The three numbers
of the denoise job, each beside its limit in the cell file; the pair's gap is
the worst of each row whole and of its latent frame 0 alone, where a
timestep that ignores the frames shows most (the head's modulation reads the
time embedding, so frame 0's velocity moves with its t)."""

from __future__ import annotations

import dataclasses
import gc
import random
from typing import Dict

import arith_ti2v
import draw
import harness
import spans
from harness import log, now, rel_l2, run_window
from jobs import denoise
from reference.scheme import load_scheme
from reference.ti2v import TI2VReference, held, replay_held
from reference.unipc import sigmas_and_timesteps
from reference.wan import guided, set_full_f32

KIND = "serve"
RATE = "denoise_s_per_step"
# the draw streams of the conditioning latents (draw.py's tags stop below)
COND = 3000000


def wan_config(cfg: Dict):
    """The program's WanConfig of a configuration file."""
    return dataclasses.replace(denoise.wan_config(cfg), model_type=cfg["model_type"],
                               sample_fps=cfg.get("sample_fps", 16))


def cond_latent(cfg: Dict, traffic: Dict, seed: int, index: int, device):
    """Video ``index``'s conditioning latent [z_dim, 1, h, w] (index -1: the
    calibration sweep's), N(0, 1) f32."""
    import torch

    c, _, h, w = draw.latent_shape(cfg, traffic["width"], traffic["height"], traffic["frames"])
    return torch.randn((c, 1, h, w), generator=draw.generator(seed, COND + index, device),
                       device=device)


def setup(job) -> Dict:
    """The program's TI2V pipeline on the quantized state, warmed up."""
    import torch

    from wanq_tpu_torch.models.dit import linear_layer_names
    from wanq_tpu_torch.pipelines.textimage2video import WanTI2V
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state, strip_quantized_weights
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    set_full_f32()
    cfg, traffic, dev = job.cfg, job.spec["traffic"], job.device
    wcfg = wan_config(cfg)
    t0 = now()
    params = draw.draw_params(cfg, job.seed, dev)
    noise, text, null = draw.draw_calibration(cfg, traffic, job.seed, dev)
    z = cond_latent(cfg, traffic, job.seed, -1, dev)
    t1 = now()
    calib = WanTI2V(wcfg, params, quant_ctx=QuantCtx(mode="calib", collect_minmax=True),
                    device=dev).collect_calibration(
        text, null, sampling_steps=traffic["calib_steps"], noise=noise, cond_latent=z,
        **{k: v for k, v in denoise._gen_kw(traffic).items() if k != "cfg_mode"})
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
    pipe = WanTI2V(wcfg, params, quant_ctx=ctx, device=dev)
    run = {"pipe": pipe, "pending": [], "record": None, "buffers": []}
    denoise._record_solver_calls(run)
    _steps(job, run, 0, limit=traffic["warmup_steps"])
    t4 = now()
    shape = draw.latent_shape(cfg, traffic["width"], traffic["height"], traffic["frames"])
    run["buffers"] = denoise._host_buffers(job, (1, *shape),
                                           (t4 - t3) / traffic["warmup_steps"])
    log(f"set-up: weights and inputs {t1 - t0:.2f} s, calibration {t2 - t1:.2f} s, PTQ and "
        f"strip {t3 - t2:.2f} s, warm-up ({traffic['warmup_steps']} steps) {t4 - t3:.2f} s")
    return run


def _steps(job, run: Dict, video: int, limit=None, deadline=None, marks=None, counts=None):
    """Video ``video`` through ``generate``, stopped after ``limit`` steps or
    at the first step that ends past ``deadline``; True when stopped. Steps
    are recorded when ``run['record']`` is a list: the CFG pair and the
    latents the loop carries on (frame 0 held)."""
    import torch

    from wanq_tpu_torch.ops import _lib

    cfg, traffic, dev = job.cfg, job.spec["traffic"], job.device
    noise, text, null = draw.draw_video(cfg, traffic, job.seed, video, dev)
    z = cond_latent(cfg, traffic, job.seed, video, dev)
    done = [0]

    def on_step(i, t, latents):
        if dev != "cpu":
            torch.cuda.synchronize()
        stamp = now()
        if not run["pending"] or "pair" not in run:
            raise RuntimeError(f"step {i} of generate did not go through both WanT2V._split "
                               f"(the CFG pair) and its scheduler's step, which the benchmark "
                               f"records ({denoise.HOOKS}; bench_h100/README.md)")
        timestep, _ = run["pending"].pop()
        run["pending"].clear()
        cond, uncond = run.pop("pair")
        if run["record"] is not None:
            run["record"].append({"video": video, "step": i, "t": timestep,
                                  "c": denoise._to_host(run, cond),
                                  "u": denoise._to_host(run, uncond),
                                  "x": denoise._to_host(run, latents)})
        if marks is not None:
            marks.append(stamp)
            counts.append(_lib.launch_counts())
        done[0] += 1
        if (limit is not None and done[0] >= limit) or (deadline is not None
                                                        and stamp >= deadline):
            raise denoise._Closed

    try:
        run["pipe"].generate(text, null, cond_latent=z, sampling_steps=traffic["steps"],
                             noise=noise, on_step=on_step, **denoise._gen_kw(traffic))
        return False
    except denoise._Closed:
        return True


def window(job, run: Dict) -> Dict:
    """Videos one after another until a step ends after ``job.seconds``."""
    from wanq_tpu_torch.ops import _lib

    run["record"] = []
    forwards = 2 if denoise._sequential(job.spec["traffic"]) else 1

    def loop(deadline, marks, counts):
        video = 0
        try:
            while not _steps(job, run, video, deadline=deadline, marks=marks, counts=counts):
                video += 1
        finally:
            # counted a forward: the harness's check is per block
            rows = _lib.LAUNCHES.pop("time_embedding_rows", 0)
            want = {k: n * len(marks) * forwards
                    for k, n in job.spec.get("launches_per_forward", {}).items()}
            log(f"launch check a forward: time_embedding_rows {rows}; the cell's per-forward "
                f"counts x {len(marks) * forwards} forwards: {want}; "
                f"{'equal' if {'time_embedding_rows': rows} == want else 'DIFFERENT'}")

    if not job.trace or harness.reduce_trace is not spans.reduce_trace:
        return run_window(job, loop, forwards)
    harness.reduce_trace = spans.reduce_trace_with_spans
    try:
        return run_window(job, loop, forwards)
    finally:
        harness.reduce_trace = spans.reduce_trace


def trace_context(job, win: Dict) -> Dict:
    """The denoise job's readings, the step's K1 and K13 byte bound, and the
    spans' device seconds (``spans``, where the trace was credited)."""
    out = denoise.trace_context(job, win)
    traffic, scheme = job.spec["traffic"], load_scheme(job.scheme_path)
    batch, forwards = (1, 2) if denoise._sequential(traffic) else (2, 1)
    calls = arith_ti2v.modulate_calls(job.cfg, scheme, traffic, batch)
    out["modulate_bound_s_per_step"] = forwards * sum(c["bound_s"] * c["count"] for c in calls)
    return out


free = denoise.free


def check(job, record, control=None) -> Dict[str, float]:
    """The three numbers compared (see the module's docstring). ``control``:
    one of the cell's controls, the reference one precision below the
    configuration's in the forward; guidance and the sampler stay f32."""
    import torch

    cfg, traffic, dev = job.cfg, job.spec["traffic"], job.device
    gen = traffic["generate"]
    steps, shift, g = traffic["steps"], gen["shift"], gen["guide_scale"]
    _, timesteps = sigmas_and_timesteps(steps, shift, cfg["num_train_timesteps"])
    mismatches = sum(int(r["t"] != int(timesteps[r["step"]])) for r in record)
    widest, inputs = 0.0, {}
    for video in sorted({r["video"] for r in record}):
        rows = [r for r in record if r["video"] == video]
        noise, _, _ = draw.draw_video(cfg, traffic, job.seed, video, dev)
        z = cond_latent(cfg, traffic, job.seed, video, dev)
        velocities = [guided(r["c"].to(dev), r["u"].to(dev), g) for r in rows]
        want = replay_held(noise.float(), velocities, steps, shift, lambda x: held(x, z))
        for r, w in zip(rows, want):
            widest = max(widest, rel_l2(r["x"].to(dev), w.float()))
        inputs[video] = [held(noise.float(), z)] + [r["x"] for r in rows]
    pick = record[random.Random(job.seed).randrange(len(record))]
    set_full_f32()
    params = draw.draw_params(cfg, job.seed, dev)
    ref = TI2VReference(params, cfg, load_scheme(job.scheme_path), control=control,
                        window=traffic.get("ctx", {}).get("attn_window"))
    with torch.no_grad():
        c_noise, c_text, c_null = draw.draw_calibration(cfg, traffic, job.seed, dev)
        c_z = cond_latent(cfg, traffic, job.seed, -1, dev)
        _, c_ts = sigmas_and_timesteps(traffic["calib_steps"], shift, cfg["num_train_timesteps"])
        ref.calibrate(held(c_noise, c_z), float(c_ts[0]), c_text, c_null)
        _, text, null = draw.draw_video(cfg, traffic, job.seed, pick["video"], dev)
        x_in = inputs[pick["video"]][pick["step"]].to(dev).float()
        cond, uncond = ref.pair(x_in, float(timesteps[pick["step"]]), text, null)
    # each row whole and its held frame alone: frame 0's tokens are the ones
    # whose timestep differs from the rest
    gap = max(rel_l2(got.to(dev)[:, :, part], want[:, :, part])
              for got, want in ((pick["c"], cond), (pick["u"], uncond))
              for part in (slice(None), slice(0, 1)))
    del ref, params
    log(f"check{f' (control {control})' if control else ''}: video {pick['video']} step "
        f"{pick['step']} (t {pick['t']}): the CFG pair's worst rel L2 {gap:.6g}; sampler widest "
        f"rel L2 {widest:.6g} over {len(record)} steps; timestep mismatches {mismatches}")
    return {"forward_rel_l2": gap, "sampler_rel_l2": widest, "timestep_mismatches": mismatches}
