"""modulate_roofline.serve: the byte bound of the step's K1 and K13 launches
(``arith_ti2v.modulate_calls``: the residual stream, the codes, scales and
sums, the per-frame table's rows) over their device time, the kernels matched
by name, in %. Read where the job gives the bound (the ti2v cell); nothing
where no K1 or K13 launch ran."""

NAMES = ("ln_mod_quant_kernel", "gate_residual_kernel")


def read(t):
    if not t or t.get("kind") != "serve" or "modulate_bound_s_per_step" not in t:
        return None
    spent = sum(s for name, (s, _) in t["kernels"].items() if any(k in name for k in NAMES))
    if spent <= 0:
        return None
    return 100.0 * t["modulate_bound_s_per_step"] * t["steps"] / spent
