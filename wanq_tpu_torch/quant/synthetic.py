"""Outlier-heavy weight and activation draws (counterpart of
wanq_tpu/quant/synthetic.py).

The weights here are Gaussian random draws, the distribution on which
SmoothQuant's channel mask and QuaRot's rotation have nothing to recover
(no per-channel outliers). These helpers build the regime those methods
were published for: activations with a few "hot" channels one to two
orders of magnitude above the median, injected at the residual-stream
producers so that LayerNorm keeps them dominant at every quantized input,
and cross-channel correlation.
"""

from __future__ import annotations

import numpy as np
import torch


def outlier_channel_scales(dim: int, n_hot: int, hot_scale: float = 100.0,
                           spread_sigma: float = 0.0, seed: int = 0) -> np.ndarray:
    """Per-channel scale vector [dim]: lognormal spread + ``n_hot`` hot
    channels."""
    rng = np.random.default_rng(seed)
    s = (np.exp(rng.normal(0.0, spread_sigma, size=dim)).astype(np.float32)
         if spread_sigma > 0 else np.ones(dim, np.float32))
    s[rng.choice(dim, n_hot, replace=False)] *= hot_scale
    return s


def inject_stream_outliers(params, cfg, chan_scale: np.ndarray):
    """Scale the output columns of every residual-stream producer
    (patch_embedding, each block's self_attn.o, cross_attn.o and ffn.2) by
    ``chan_scale`` [cfg.dim], so every quantized linear input becomes
    outlier-heavy. Mutates and returns ``params`` (list-form ``blocks``);
    each weight keeps its dtype and device."""
    if chan_scale.shape != (cfg.dim,):
        raise ValueError(f"chan_scale: ({cfg.dim},) expected, got {chan_scale.shape}")
    sc = torch.from_numpy(chan_scale.astype(np.float32))

    def scaled(leaf):
        w = leaf["w"]
        return {**leaf, "w": (w.float() * sc.to(w.device)[None, :]).to(w.dtype)}

    params["patch_embedding"] = scaled(params["patch_embedding"])
    for blk in params["blocks"]:
        blk["self_attn"]["o"] = scaled(blk["self_attn"]["o"])
        blk["cross_attn"]["o"] = scaled(blk["cross_attn"]["o"])
        blk["ffn"]["2"] = scaled(blk["ffn"]["2"])
    return params


def correlated_outlier_acts(m: int, dim: int, n_hot: int, hot_scale: float = 60.0,
                            spread_sigma: float = 1.2, corr_sigma: float = 1.0,
                            seed: int = 0, draw_seed: int = 1) -> np.ndarray:
    """[m, dim] f32 activations with hot channels and cross-channel
    correlation. ``seed`` fixes the channel structure (scales and mixing,
    shared by calibration and held-out draws), ``draw_seed`` the sample."""
    rng = np.random.default_rng(seed)
    cs = outlier_channel_scales(dim, n_hot, hot_scale, spread_sigma, seed)
    q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    spec = np.exp(rng.normal(0.0, corr_sigma, size=dim))
    mix = (q * spec[None, :]) @ q.T
    z = np.random.default_rng(draw_seed).normal(size=(m, dim))
    return ((z @ mix) * cs[None, :]).astype(np.float32)


def sqnr_db(y_quant, y_ref) -> float:
    """Signal-to-quantization-noise ratio in dB (f64 sums); tensors on any
    device or arrays."""
    yq, yf = (np.asarray(y.detach().cpu() if isinstance(y, torch.Tensor) else y, np.float64)
              for y in (y_quant, y_ref))
    return float(10.0 * np.log10((yf ** 2).sum() / ((yq - yf) ** 2).sum()))
