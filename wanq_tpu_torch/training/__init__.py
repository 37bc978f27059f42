"""Training (counterpart of wanq_tpu/training): CFG distillation, full,
LoRA and QLoRA, the adapters and the latent data path."""

from wanq_tpu_torch.training.distill import (
    DistillConfig,
    TrainState,
    distill_step,
    ema_update,
    init_train_state,
    make_distill_step,
    make_lora_distill_step,
    make_qlora_distill_step,
)
from wanq_tpu_torch.training.lora import merge_lora_into_quant_state
