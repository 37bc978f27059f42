"""Process-group launch (counterpart of wanq_tpu/parallel/launch.py).

``wanq_tpu`` is one controller process per host; the port is SPMD: one
process per card, started by torchrun, each running the same program on its
shard. torchrun sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and the
rendezvous in ``MASTER_ADDR`` / ``MASTER_PORT``):

    torchrun --nproc_per_node 8 -m wanq_tpu_torch.cli.quant_generate \\
        --task t2v-14B --ulysses_size 8 --dit_fsdp ...
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

# the collectives of a denoise step finish in seconds; a rank that died
# leaves the others waiting this long before they raise
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(device: str = "cuda", init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None) -> int:
    """Join the process group and return the world size. ``rank`` and
    ``world_size`` default to torchrun's ``RANK`` / ``WORLD_SIZE`` (1 without
    them), the rendezvous to ``env://``. At world 1 with no ``init_method``
    it does nothing; an explicit ``init_method`` makes a group of any size,
    one rank included. A CUDA ``device`` takes NCCL on card ``LOCAL_RANK``
    (raising without a card or NCCL: nothing goes on on the CPU), the CPU
    gloo. An existing group is kept."""
    if dist.is_initialized():
        return dist.get_world_size()
    rank = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
    world_size = (int(os.environ.get("WORLD_SIZE", "1")) if world_size is None
                  else int(world_size))
    if world_size == 1 and init_method is None:
        return 1
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available() or not dist.is_nccl_available():
            raise RuntimeError(f"--device {device}: a multi-rank run needs a CUDA card and NCCL")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    logging.info("torch.distributed (%s): rank %d of %d", backend, rank, world_size)
    return world_size


def is_main_rank() -> bool:
    """True on rank 0, and without a process group: the rank that writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0
