"""wanq_tpu_torch: the PyTorch / CUDA port of wanq_tpu for one NVIDIA H100.

It mirrors wanq_tpu's layout (configs/, quant/, ops/, models/, solvers/,
pipelines/, cli/) and function names. Every Pallas kernel on the W8A8
denoise path has a hand-written CUDA kernel under csrc/ (built for sm_90a
at first use) and a plain PyTorch version beside it, which runs for CPU
tensors and serves as the kernel's oracle. The package imports torch and
numpy, never JAX.
"""
