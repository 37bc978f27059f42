"""attn_roofline.train: the bound of a QLoRA step's attention launches (K4
plain and residual, K12, K11; ``arith.train_attention_calls``) over their
device time, in %. Read in the QLoRA cells; nothing where none ran."""

from harness import kernel_seconds


def read(t):
    if not t or t.get("kind") != "train":
        return None
    spent = kernel_seconds(t["kernels"], ("K4", "K11", "K12"))
    if spent <= 0:
        return None
    return 100.0 * t["attn_bound_s_per_step"] * t["steps"] / spent
