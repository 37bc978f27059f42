"""Quantization (counterpart of wanq_tpu/quant, the W8A8 subset)."""

from wanq_tpu_torch.quant.config import FP_POLICY, LayerPolicy, QuantConfig
from wanq_tpu_torch.quant.quantizers import QuantizerCfg

__all__ = ["FP_POLICY", "LayerPolicy", "QuantConfig", "QuantizerCfg"]
