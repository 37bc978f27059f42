"""glue_ms.train: device milliseconds per QLoRA step outside the program's
hand kernels (the trainable route's fake-quant and dequant passes, library
GEMMs, elementwise ops, the optimizer), from the trace's kernel names. Read in
the QLoRA cells."""

from harness import kernel_tag


def read(t):
    if not t or t.get("kind") != "train":
        return None
    glue = sum(s for name, (s, _) in t["kernels"].items() if kernel_tag(name) is None)
    return 1e3 * glue / t["steps"]
