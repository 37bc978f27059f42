"""Quantization (counterpart of wanq_tpu/quant, the subset that the int8
and int4 kernel routes need)."""

from wanq_tpu_torch.quant.config import FP_POLICY, LayerPolicy, QuantConfig
from wanq_tpu_torch.quant.quantizers import QuantizerCfg

__all__ = ["FP_POLICY", "LayerPolicy", "QuantConfig", "QuantizerCfg"]
