"""glue_ms.serve: device milliseconds per denoise step outside the
program's hand kernels (library GEMMs, elementwise ops, reductions, copies),
from the trace's kernel names. Read in the denoise cells."""

from harness import kernel_tag


def read(t):
    if not t or t.get("kind") != "serve":
        return None
    glue = sum(s for name, (s, _) in t["kernels"].items() if kernel_tag(name) is None)
    return 1e3 * glue / t["steps"]
