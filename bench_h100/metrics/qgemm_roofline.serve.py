"""qgemm_roofline.serve: the bound of the step's int GEMM launches (K2 and
K8, their GELU + quant mode included; ``arith.int_gemm_calls``) over their
device time, in %. Read in the denoise cells; nothing where none ran."""

from harness import kernel_seconds


def read(t):
    if not t or t.get("kind") != "serve":
        return None
    spent = kernel_seconds(t["kernels"], ("K2", "K8"))
    if spent <= 0 or t["gemm_bound_s_per_step"] <= 0:
        return None
    return 100.0 * t["gemm_bound_s_per_step"] * t["steps"] / spent
