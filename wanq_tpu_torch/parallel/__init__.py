"""Multi-GPU serving over torch.distributed (counterpart of wanq_tpu/parallel):
FSDP weight storage, Ulysses and ring sequence parallelism, data parallelism."""
from wanq_tpu_torch.parallel.launch import init_distributed
from wanq_tpu_torch.parallel.ring import ring_attention
from wanq_tpu_torch.parallel.sharding import (
    AXES,
    ShardingPlan,
    make_mesh,
    param_shardings,
    shard_params,
    shard_t5_params,
)
