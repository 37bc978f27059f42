"""Quantization (counterpart of wanq_tpu/quant): configs and policies, the
quantizers, RTN PTQ, the quant-aware linear (FP, calibration, simulated and
int kernel modes) and the simulated attention quantizers."""

from wanq_tpu_torch.quant.attn import AttnQuantCfg
from wanq_tpu_torch.quant.config import FP_POLICY, LayerPolicy, QuantConfig
from wanq_tpu_torch.quant.quantizers import QuantizerCfg

__all__ = ["AttnQuantCfg", "FP_POLICY", "LayerPolicy", "QuantConfig", "QuantizerCfg"]
