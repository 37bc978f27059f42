"""Named ranges in the denoise loop and the DiT forward, for a
``torch.profiler`` trace.

``span(name)`` enters ``torch.profiler.record_function(name)`` while a
profiler runs and is a shared no-op otherwise, so an untraced run pays one
flag read a span. In a trace with CUDA activity each range also appears on
the device's timeline (a user annotation around the kernels launched inside
it), so a kernel can be credited to the innermost span that launched it on
the trace's one clock.

The spans split a denoise step completely:

* ``pipe.step``: one step of a denoise loop, from its start through the
  solver's ``step`` (not the caller's ``on_step``): the CFG batch's inputs,
  the split, guidance and the solver outside the forwards;
* ``dit.forward``: one DiT forward: patchify, the patch / time / text
  embeddings, the pad, the rope tables, the head and unpatchify outside the
  blocks (under a sharding plan also the blocks' weight gathers);
* ``dit.block``: one block: its modulation add and its three gated residual
  updates outside the sub-layers;
* ``dit.self_attn``, ``dit.cross_attn``, ``dit.ffn``: each sub-layer from its
  producer (the norm, modulate and quantizer) through its output projection.

A renamed or removed span is a change of what a trace reader reads."""

from __future__ import annotations

import contextlib

import torch

PIPE_STEP = "pipe.step"
DIT_FORWARD = "dit.forward"
DIT_BLOCK = "dit.block"
SELF_ATTN = "dit.self_attn"
CROSS_ATTN = "dit.cross_attn"
FFN = "dit.ffn"

# outermost first
SPAN_NAMES = (PIPE_STEP, DIT_FORWARD, DIT_BLOCK, SELF_ATTN, CROSS_ATTN, FFN)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a ``torch.profiler`` runs;
    otherwise the one shared no-op context, which records nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
