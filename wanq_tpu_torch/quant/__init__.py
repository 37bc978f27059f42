"""Quantization (counterpart of wanq_tpu/quant): configs and policies, the
quantizers, PTQ (RTN, SmoothQuant masks, Hadamard rotations) and its npz
artifact, the quant-aware linear (FP, calibration, simulated and int kernel
modes), the simulated attention quantizers and the outlier-heavy draws."""

from wanq_tpu_torch.quant.attn import AttnQuantCfg
from wanq_tpu_torch.quant.config import FP_POLICY, LayerPolicy, QuantConfig
from wanq_tpu_torch.quant.hadamard import random_hadamard_matrix, rotation_for_dim
from wanq_tpu_torch.quant.ptq import (
    load_quant_state,
    prepare_quant_state,
    rebuild_rotations,
    save_quant_state,
)
from wanq_tpu_torch.quant.quantizers import QuantizerCfg
from wanq_tpu_torch.quant.smooth import channel_mask

__all__ = ["AttnQuantCfg", "FP_POLICY", "LayerPolicy", "QuantConfig", "QuantizerCfg",
           "channel_mask", "load_quant_state", "prepare_quant_state", "random_hadamard_matrix",
           "rebuild_rotations", "rotation_for_dim", "save_quant_state"]
