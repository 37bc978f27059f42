"""Streamed per-block quantized model construction (counterpart of
wanq_tpu/quant/stream.py).

Builds a quantized Wan DiT whose full-precision form never exists anywhere:
each block is drawn on the device, its linears are int-quantized
(``prepare_layer_state``), the FP copies are stripped and the FP block is
dropped before the next one is drawn, so the build holds one block of FP
weights and its quantization temporaries beyond the quant state. This is the
base of T2V-14B QLoRA on one card (``chip_smoke.py`` phase 9).

Unlike ``wanq_tpu``, which resolves ``blocks.0.*`` and applies that policy to
every block (its scan stacks the state, so a class needs one policy), the
port resolves each block's own policy: a config whose regex names a block
index quantizes that block as it says.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

BLOCK_LINEARS = (
    "self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o",
    "cross_attn.q", "cross_attn.k", "cross_attn.v", "cross_attn.o",
    "ffn.0", "ffn.2",
)
# the seeds of the streamed draws: the prelude, the head's redraw, block i
PRELUDE_SEED, HEAD_SEED, BLOCK_SEED = 0, 7, 100


def head_draw(shape, dtype, device) -> torch.Tensor:
    """``head.head``'s weight redrawn as 0.02 N(0, 1) from ``HEAD_SEED`` on
    ``device`` (the generators leave it zero, the DiT convention)."""
    gen = torch.Generator(device=device).manual_seed(HEAD_SEED)
    return (0.02 * torch.randn(shape, generator=gen, device=device)).to(dtype)


def build_streamed_quant_base(
    cfg,
    qcfg,
    *,
    randomize_head: bool = True,
    act_minmax_synth: Optional[Tuple[float, float]] = (8.0, -8.0),
    log: Optional[Callable[[str], None]] = None,
    device="cuda",
):
    """→ (params, qctx, total_quant_bytes).

    ``params``: the DiT's params, the blocks a list, with the quantized
    linears' FP weights stripped to the [1, 1] placeholders of
    ``strip_quantized_weights``. ``qctx``: an int8-mode QuantCtx whose
    ``state`` holds ``blocks.{i}.{linear}`` for every block and quantized
    linear. ``act_minmax_synth``: frozen bounds for static-act sites when no
    calibration ran (random-init probes; ±8 bounds GELU outputs — real
    deployments calibrate and pass None to require calib data). Drawn on
    ``device``, the card unless the caller asks for the CPU.
    """
    from wanq_tpu_torch.models import dit
    from wanq_tpu_torch.quant.ptq import (
        params_get,
        prepare_layer_state,
        strip_quantized_weights,
    )
    from wanq_tpu_torch.quant.qlinear import QuantCtx

    log = log or (lambda m: None)
    t0 = time.time()
    params = dit.make_nonblock_generator(cfg, device=device)(PRELUDE_SEED)
    if randomize_head:
        # head.head is zero-init (DiT convention); randomize so outputs —
        # and timings — reflect the full network, not a zero graph
        w = params["head"]["head"]["w"]
        params["head"]["head"]["w"] = head_draw(w.shape, w.dtype, device)
    gen_block = dit.make_block_generator(cfg, device=device)
    synth = (
        (np.asarray([act_minmax_synth[0]], np.float32),
         np.asarray([act_minmax_synth[1]], np.float32))
        if act_minmax_synth is not None else None
    )
    policies: Dict[str, object] = {}
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    blocks = []
    for i in range(cfg.num_layers):
        pols = {ln: qcfg.resolve(f"blocks.{i}.{ln}") for ln in BLOCK_LINEARS}
        bp = gen_block(BLOCK_SEED + i)
        for ln, pol in pols.items():
            policies[f"blocks.{i}.{ln}"] = pol
            if not pol.is_quantized:
                continue
            static = pol.act is not None and not pol.act.dynamic
            state[f"blocks.{i}.{ln}"] = prepare_layer_state(
                pol, params_get(bp, ln)["w"], targets="int8",
                act_minmax=synth if static else None)
        blocks.append(strip_quantized_weights(
            {"blocks": [bp]}, {f"blocks.0.{ln}": pol for ln, pol in pols.items()})["blocks"][0])
        del bp  # the FP block goes before the next one is drawn
        if i % 10 == 0:
            log(f"  layer {i} quantized ({time.time() - t0:.0f}s)")
    params["blocks"] = blocks
    total_qbytes = sum(t.numel() * t.element_size() for st in state.values()
                       for t in st.values())
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    log(f"streamed quantized base in {time.time() - t0:.0f}s: "
        f"{total_qbytes / 2**30:.2f} GiB int-at-rest")
    return params, QuantCtx(mode="int8", policies=policies, state=state), total_qbytes
