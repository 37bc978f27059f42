"""attn_roofline.serve: the bound of the step's K4 launches (self and
cross, ``arith.attention_calls``) over their device time, in %. Read in the
denoise cells; nothing where no K4 launch ran."""

from harness import kernel_seconds


def read(t):
    if not t or t.get("kind") != "serve":
        return None
    spent = kernel_seconds(t["kernels"], ("K4",))
    if spent <= 0:
        return None
    return 100.0 * t["attn_bound_s_per_step"] * t["steps"] / spent
