"""Job kind ``qlora``: QLoRA distillation steps through the program's
``training.make_qlora_distill_step`` (remat, clip, AdamW), the base built as
the program builds it: ``prepare_quant_state`` under the cell's scheme (int8
targets), ``strip_quantized_weights``, an int8 ``QuantCtx``.

Set-up (timed as ``setup_s``): the weights and the initial adapters drawn on
the card from the seed (a ~ N(0, 1/r), b = 0), the base, the train state and
its optimizer, then the first ``followed_steps`` steps through the step the
window calls, each on a batch of its own drawn from the seed (x0, noise, t,
two text states): they build every shape and warm every kernel, and the
check follows them. Window: the same step on batch after batch until a step
ends after ``--seconds``; the host waits for the card after each step.

Check (after the window, the program's state freed): the reference
(``reference/train.py``) draws the weights, the adapters and the batches
again, quantizes the base itself, runs the followed steps, and takes the
loss of the window's first step (its state after them, the window's first
batch). Three numbers, each beside its limit: the worst relative loss gap of
the followed steps and the window's first; the first gradient as the
optimizer got it (AdamW's first moment after step 1 over 1 - beta1), the
worst leaf's gap of norms; the adapters' change over the followed steps, the
worst leaf's gap of norms. A leaf's gap is taken against the larger of its
reference norm and the median leaf's; leaves whose reference gradient over
the followed steps is under a thousandth of the median leaf's are left out
of the change. The whole first gradient's relative L2 gap and cosine (every
leaf together) are logged beside them: no fault read yet separates them
from sound runs, so they are not compared."""

from __future__ import annotations

import gc
import math
import re
import statistics
from typing import Dict, List

import arith
import draw
from harness import log, now, run_window
from jobs.denoise import wan_config
from reference.scheme import load_scheme
from reference.train import AdamW, QLoRAReference, distill_loss, train_steps
from reference.wan import set_full_f32

KIND = "train"
RATE = "train_s_per_step"


def adapter_names(cfg: Dict, targets: str) -> List[str]:
    from reference.scheme import block_sites

    pat = re.compile(targets)
    return [f"blocks.{i}.{s}" for s in block_sites() for i in range(cfg["num_layers"])
            if pat.search(f"blocks.{i}.{s}")]


def _dims(cfg: Dict, site: str):
    d, f = cfg["dim"], cfg["ffn_dim"]
    return {"ffn.0": (d, f), "ffn.2": (f, d)}.get(site.split(".", 2)[-1], (d, d))


def _sync(job):
    import torch

    if job.device != "cpu":
        torch.cuda.synchronize()


def setup(job) -> Dict:
    import torch

    from wanq_tpu_torch.models.dit import linear_layer_names
    from wanq_tpu_torch.quant import QuantConfig
    from wanq_tpu_torch.quant.ptq import prepare_quant_state, strip_quantized_weights
    from wanq_tpu_torch.quant.qlinear import QuantCtx
    from wanq_tpu_torch.training import DistillConfig, init_train_state, make_qlora_distill_step

    set_full_f32()
    cfg, tr, dev = job.cfg, job.spec["traffic"], job.device
    wcfg = wan_config(cfg)
    t0 = now()
    params = draw.draw_params(cfg, job.seed, dev)
    names = adapter_names(cfg, tr["targets"])
    lora = draw.draw_lora(names, [_dims(cfg, n) for n in names], tr["rank"], tr["alpha"],
                          job.seed, dev)
    qcfg = QuantConfig.from_yaml(job.scheme_path)
    pol, state, rot = prepare_quant_state(params, linear_layer_names(wcfg), qcfg, targets="int8")
    params = strip_quantized_weights(params, pol)
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    qctx = QuantCtx(mode="int8", policies=pol, state=state, rotations=rot)
    valid, _ = arith.seq_tokens(cfg, tr)
    dcfg = DistillConfig(learning_rate=tr["learning_rate"], weight_decay=tr["weight_decay"],
                         max_grad_norm=tr["max_grad_norm"], seq_len=valid, remat=tr["remat"])
    tstate, tx = init_train_state(lora, dcfg)
    step = make_qlora_distill_step(wcfg, dcfg, tx)
    run = {"step": step, "state": tstate, "tx": tx, "params": params, "qctx": qctx,
           "names": names, "losses": [], "window_losses": []}
    t1 = now()
    for i in range(tr["followed_steps"]):
        loss = _one(job, run, i)
        run["losses"].append(loss)
        if i == 0:
            run["first_grads"] = {n: [_first_grad(tx, p) for p in _pair(tstate.params, n)]
                                  for n in names}
    run["followed"] = {n: [p.detach().cpu().clone() for p in _pair(tstate.params, n)]
                       for n in names}
    t2 = now()
    log(f"set-up: weights, adapters and the base {t1 - t0:.2f} s; the {tr['followed_steps']} "
        f"followed steps {t2 - t1:.2f} s, losses {run['losses']}")
    return run


def _first_grad(tx, p):
    """The gradient AdamW took at its first step: its first moment over
    1 - beta1 (zero where it holds no state for the leaf)."""
    m = tx.state.get(p, {}).get("exp_avg")
    beta1 = tx.param_groups[0]["betas"][0]
    return (m / (1 - beta1) if m is not None else p.detach() * 0).cpu()


def _pair(lora, name):
    return lora[name]["a"], lora[name]["b"]


def _one(job, run: Dict, i: int) -> float:
    """Step ``i`` of the program on batch ``i``; its loss (read after the step)."""
    tr = job.spec["traffic"]
    b = draw.draw_batch(job.cfg, tr, job.seed, i, job.device)
    st = run["state"]
    _, _, _, loss, _ = run["step"](st.params, st.ema_params, run["tx"], run["params"],
                                   run["qctx"], b["x0"], b["noise"], b["t"], b["context"],
                                   b["null_context"], tr["guide_scale"])
    return float(loss)


def window(job, run: Dict) -> Dict:
    """The same step on batch after batch until one ends after ``job.seconds``."""
    from wanq_tpu_torch.ops import _lib

    def loop(deadline, marks, counts):
        i = job.spec["traffic"]["followed_steps"]
        while True:
            run["window_losses"].append(_one(job, run, i))
            _sync(job)
            marks.append(now())
            counts.append(_lib.launch_counts())
            i += 1
            if marks[-1] >= deadline:
                return

    return run_window(job, loop)


def free(run: Dict) -> Dict:
    """Drop the program's state; returns what the check reads."""
    import torch

    keep = {k: run[k] for k in ("names", "losses", "first_grads", "followed",
                                "window_losses")}
    run.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return keep


def _gap(got: List[float], want: List[float]) -> float:
    """The worst leaf's |norm gap| over the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(want)
    return max(abs(g - w) / max(w, med, 1e-30) for g, w in zip(got, want))


def check(job, kept: Dict, control=None) -> Dict[str, float]:
    import torch

    cfg, tr, dev = job.cfg, job.spec["traffic"], job.device
    set_full_f32()
    names = kept["names"]
    params = draw.draw_params(cfg, job.seed, dev)
    lora = draw.draw_lora(names, [_dims(cfg, n) for n in names], tr["rank"], tr["alpha"],
                          job.seed, dev)
    start = {n: [p.clone() for p in _pair(lora, n)] for n in names}
    leaves = [p for n in names for p in _pair(lora, n)]
    for p in leaves:
        p.requires_grad_(True)
    model = QLoRAReference(params, cfg, load_scheme(job.scheme_path),
                           {n: lora[n] for n in names}, float(lora["__scale__"]),
                           control=control)
    opt = AdamW(leaves, tr["learning_rate"], tr["weight_decay"], tr["max_grad_norm"])
    nf = tr["followed_steps"]
    batches = [draw.draw_batch(cfg, tr, job.seed, i, dev) for i in range(nf)]
    got = train_steps(model, leaves, opt, batches, tr["guide_scale"])
    with torch.no_grad():
        window_loss = float(distill_loss(model, draw.draw_batch(cfg, tr, job.seed, nf, dev),
                                         tr["guide_scale"]))
    prog_losses = kept["losses"] + kept["window_losses"][:1]
    ref_losses = got["losses"] + [window_loss]
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    ref_g = got["first_grads"]
    prog_g = [g.to(dev) for n in names for g in kept["first_grads"][n]]
    ref_first = [float(g.norm()) for g in ref_g]
    prog_first = [float(g.norm()) for g in prog_g]
    grad_gap = _gap(prog_first, ref_first)
    diff = [float((p.double() - r.double()).norm()) for p, r in zip(prog_g, ref_g)]
    grad_rel = math.sqrt(sum(d * d for d in diff)) / max(math.sqrt(sum(
        r * r for r in ref_first)), 1e-30)
    med = statistics.median(ref_first)
    leaf_rel = [d / max(r, med, 1e-30) for d, r in zip(diff, ref_first)]
    cos = sum(float((p.double() * r.double()).sum()) for p, r in zip(prog_g, ref_g)) / max(
        math.sqrt(sum(x * x for x in prog_first)) * math.sqrt(sum(r * r for r in ref_first)),
        1e-30)
    del prog_g
    energy = got["grad_energy"]
    floor = 1e-3 * statistics.median(energy)
    ref_change, prog_change = [], []
    for k, (n, p, p0, pp) in enumerate(
            (n, p, p0, pp) for n in names
            for p, p0, pp in zip(_pair(lora, n), start[n], kept["followed"][n])):
        if energy[k] < floor:
            continue
        ref_change.append(float((p.detach() - p0).norm()))
        prog_change.append(float((pp.to(dev) - p0).norm()))
    change_gap = _gap(prog_change, ref_change)
    log(f"check{f' (control {control})' if control else ''}: losses program {prog_losses} "
        f"reference {ref_losses} (the last the window's first step); first gradient worst "
        f"leaf gap {grad_gap:.6g}, whole rel L2 {grad_rel:.6g}, cosine {cos:.8g}, leaves' rel "
        f"L2 median {statistics.median(leaf_rel):.6g} worst {max(leaf_rel):.6g}; change after "
        f"{nf} steps worst leaf gap {change_gap:.6g} over {len(ref_change)} of {len(leaves)} "
        f"leaves; window losses {kept['window_losses']}")
    del model, params, lora
    return {"loss_rel_gap": loss_gap, "first_grad_gap": grad_gap, "change_gap": change_gap}


def trace_context(job, win: Dict) -> Dict:
    tr = job.spec["traffic"]
    work = arith.train_step_work(job.cfg, tr)
    calls = arith.train_attention_calls(job.cfg, tr)
    return {"kind": KIND, **win["trace"], "steps": win["steps"],
            "least_s_per_step": work / arith.PEAK_OPS["bf16"],
            "attn_bound_s_per_step": sum(c["bound_s"] * c["count"] for c in calls),
            "step_s": win["window_s"] / win["steps"]}
