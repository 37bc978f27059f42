"""Quantization (counterpart of wanq_tpu/quant): configs and policies, the
quantizers, PTQ (RTN, SmoothQuant masks, Hadamard rotations) and its npz
artifact, the quant-aware linear (FP, calibration, simulated and int kernel
modes), the simulated attention quantizers, the outlier-heavy draws, the
capacity planner (``--auto_bits_gib``) and the streamed quantized base."""

from wanq_tpu_torch.quant.attn import AttnQuantCfg
from wanq_tpu_torch.quant.config import FP_POLICY, LayerPolicy, QuantConfig
from wanq_tpu_torch.quant.hadamard import random_hadamard_matrix, rotation_for_dim
from wanq_tpu_torch.quant.planner import (
    CapacityPlan,
    class_weight_bytes,
    measure_class_errors,
    plan_capacity_bits,
)
from wanq_tpu_torch.quant.ptq import (
    load_quant_state,
    prepare_quant_state,
    rebuild_rotations,
    save_quant_state,
)
from wanq_tpu_torch.quant.quantizers import QuantizerCfg
from wanq_tpu_torch.quant.smooth import channel_mask
from wanq_tpu_torch.quant.stream import build_streamed_quant_base

__all__ = ["AttnQuantCfg", "CapacityPlan", "FP_POLICY", "LayerPolicy", "QuantConfig",
           "QuantizerCfg", "build_streamed_quant_base", "channel_mask", "class_weight_bytes",
           "load_quant_state", "measure_class_errors", "plan_capacity_bits",
           "prepare_quant_state", "random_hadamard_matrix", "rebuild_rotations",
           "rotation_for_dim", "save_quant_state"]
