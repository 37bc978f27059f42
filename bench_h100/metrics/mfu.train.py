"""mfu.train: the least time of one QLoRA step's work (``arith.train_step_work``
at the bf16 peak: the trainable route multiplies bf16 operands) over the
measured step time, in %. Read in the QLoRA cells."""


def read(t):
    if not t or t.get("kind") != "train":
        return None
    return 100.0 * t["least_s_per_step"] / t["step_s"]
