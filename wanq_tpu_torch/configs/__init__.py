"""Model configs (counterpart of wanq_tpu/configs): the same fields and
values, with dtypes resolved to torch dtypes."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class WanConfig:
    name: str = "t2v-1.3B"
    model_type: str = "t2v"  # 't2v' | 'i2v' | 'ti2v'

    # t5
    t5_model: str = "umt5_xxl"
    t5_checkpoint: str = "models_t5_umt5-xxl-enc-bf16.pth"
    t5_tokenizer: str = "google/umt5-xxl"
    text_len: int = 512
    text_dim: int = 4096

    # vae
    vae_checkpoint: str = "Wan2.1_VAE.pth"
    vae_stride: Tuple[int, int, int] = (4, 8, 8)
    z_dim: int = 16

    # clip (i2v only)
    clip_checkpoint: str = ""
    clip_dim: int = 1280

    # transformer
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    in_dim: int = 16
    out_dim: int = 16
    dim: int = 1536
    ffn_dim: int = 8960
    freq_dim: int = 256
    num_heads: int = 12
    num_layers: int = 30
    window_size: Tuple[int, int] = (-1, -1)
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6

    # inference
    num_train_timesteps: int = 1000
    sample_fps: int = 16
    param_dtype: str = "bfloat16"
    # dtype of the residual stream between blocks (norms compute f32)
    residual_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def res_dtype(self) -> torch.dtype:
        return getattr(torch, self.residual_dtype)


SAMPLE_NEG_PROMPT = (
    "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，整体发灰，最差质量，"
    "低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，画得不好的手部，画得不好的脸部，畸形的，"
    "毁容的，形态畸形的肢体，手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
)

# shipped configs ride a bf16 residual stream; tests/tiny keep f32
t2v_1_3B = WanConfig(name="t2v-1.3B", residual_dtype="bfloat16")

t2v_14B = WanConfig(
    name="t2v-14B", dim=5120, ffn_dim=13824, num_heads=40, num_layers=40,
    residual_dtype="bfloat16",
)

i2v_14B = WanConfig(
    name="i2v-14B", model_type="i2v", residual_dtype="bfloat16", dim=5120,
    ffn_dim=13824, num_heads=40, num_layers=40, in_dim=36,
    clip_checkpoint="models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth",
)

t2i_14B = dataclasses.replace(t2v_14B, name="t2i-14B")

# Wan2.2's TI2V-5B (config.json and wan/configs/wan_ti2v_5B.py of the Wan2.2
# release): per-frame timesteps, frame 0 held to the image's latent in
# image-to-video mode (pipelines/textimage2video.py); the Wan2.2 VAE (48
# channels, 16x spatial) is not in the repository
ti2v_5B = WanConfig(
    name="ti2v-5B", model_type="ti2v", residual_dtype="bfloat16", dim=3072, ffn_dim=14336,
    num_heads=24, num_layers=30, in_dim=48, out_dim=48, z_dim=48, vae_stride=(4, 16, 16),
    vae_checkpoint="Wan2.2_VAE.pth", sample_fps=24,
)

WAN_CONFIGS: Dict[str, WanConfig] = {
    "t2v-1.3B": t2v_1_3B,
    "t2v-14B": t2v_14B,
    "i2v-14B": i2v_14B,
    "t2i-14B": t2i_14B,
    "ti2v-5B": ti2v_5B,
}

SIZE_CONFIGS: Dict[str, Tuple[int, int]] = {
    "720*1280": (720, 1280),
    "1280*720": (1280, 720),
    "480*832": (480, 832),
    "832*480": (832, 480),
    "1024*1024": (1024, 1024),
    "1280*704": (1280, 704),
    "704*1280": (704, 1280),
    "64*64": (64, 64),
}


# the pixel area an i2v run keeps, by --size (the image's aspect sets the shape)
MAX_AREA_CONFIGS: Dict[str, int] = {
    "720*1280": 720 * 1280,
    "1280*720": 1280 * 720,
    "480*832": 480 * 832,
    "832*480": 832 * 480,
}


def tiny_config(**overrides) -> WanConfig:
    """A CPU-testable miniature of the Wan architecture (task 'tiny')."""
    base = dict(
        name="tiny", dim=96, ffn_dim=192, freq_dim=32, num_heads=4,
        num_layers=2, text_len=16, text_dim=64, param_dtype="float32",
    )
    base.update(overrides)
    return WanConfig(**base)


WAN_CONFIGS["tiny"] = tiny_config()

SUPPORTED_SIZES: Dict[str, Tuple[str, ...]] = {
    "t2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2v-1.3B": ("480*832", "832*480"),
    "i2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2i-14B": tuple(SIZE_CONFIGS.keys()),
    "ti2v-5B": ("1280*704", "704*1280"),
    "tiny": tuple(SIZE_CONFIGS.keys()),
}
