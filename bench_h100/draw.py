"""Everything a run feeds the model, drawn on the device from ``--seed``:
the DiT's weights in the layout the program and the reference both read
(a dict tree whose paths are the Wan module names, linear weights ``w``
[C_in, C_out] in the served dtype, biases and norm gains f32), the text
states and the noise of each video, the calibration inputs and the
training batches. Each stream is a ``torch.Generator`` on the device seeded
from (seed, tag), so the reference can draw the same tensors again after the
program's state is freed. One call per matrix; nothing passes through the
host."""

from __future__ import annotations

import math
from typing import Dict

import torch

# tags of the streams drawn from one seed
WEIGHTS, CALIB, LORA, VIDEO, BATCH = 0, 1, 2, 1000, 1000000


def generator(seed: int, tag: int, device) -> torch.Generator:
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(tag) * 0xBF58476D1CE4E5B9) % (2**63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def draw_params(cfg: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """Random weights of a Wan T2V DiT of ``cfg``'s widths: xavier-uniform
    linears, N(0, 0.02) text and time embeddings and head, N(0, 0.02) biases,
    norm gains 1 + N(0, 0.1), modulation N(0, 1) / sqrt(dim)."""
    g = generator(seed, WEIGHTS, device)
    d = cfg["dim"]

    def normal(shape, std, mean=0.0, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device=device).normal_(mean, std, generator=g)

    def lin(c_in, c_out, std=None):
        w = torch.empty((c_in, c_out), dtype=dtype, device=device)
        if std is None:
            bound = math.sqrt(6.0 / (c_in + c_out))
            w.uniform_(-bound, bound, generator=g)
        else:
            w.normal_(0.0, std, generator=g)
        return {"w": w, "b": normal((c_out,), 0.02, dt=dtype).float()}

    def gain():
        return normal((d,), 0.1, mean=1.0, dt=dtype).float()

    def modulation(n):
        return normal((1, n, d), 1.0) / math.sqrt(d)

    patch = math.prod(cfg["patch_size"])
    params = {
        "patch_embedding": lin(patch * cfg["in_dim"], d),
        "text_embedding": {"0": lin(cfg["text_dim"], d, 0.02), "2": lin(d, d, 0.02)},
        "time_embedding": {"0": lin(cfg["freq_dim"], d, 0.02), "2": lin(d, d, 0.02)},
        "time_projection": {"1": lin(d, 6 * d)},
        "head": {"head": lin(d, patch * cfg["out_dim"], 0.02), "modulation": modulation(2)},
    }
    blocks = []
    for _ in range(cfg["num_layers"]):
        blocks.append({
            "self_attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                          "norm_q": gain(), "norm_k": gain()},
            "cross_attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                           "norm_q": gain(), "norm_k": gain()},
            "norm3": {"w": gain(), "b": normal((d,), 0.02, dt=dtype).float()},
            "ffn": {"0": lin(d, cfg["ffn_dim"]), "2": lin(cfg["ffn_dim"], d)},
            "modulation": modulation(6),
        })
    params["blocks"] = blocks
    return params


def latent_shape(cfg: Dict, width: int, height: int, frames: int):
    """(C, F, H, W) of the latents of a ``width`` x ``height`` x ``frames`` video."""
    st = cfg["vae_stride"]
    return (cfg["z_dim"], (frames - 1) // st[0] + 1, height // st[1], width // st[2])


def _video(cfg: Dict, traffic: Dict, seed: int, tag: int, device):
    g = generator(seed, tag, device)
    shape = latent_shape(cfg, traffic["width"], traffic["height"], traffic["frames"])
    text = (1, cfg["text_len"], cfg["text_dim"])
    noise = torch.randn((1, *shape), generator=g, device=device)
    return noise, torch.randn(text, generator=g, device=device), torch.randn(
        text, generator=g, device=device)


def draw_video(cfg: Dict, traffic: Dict, seed: int, index: int, device):
    """(noise [1, C, F, H, W], text states, null text states [1, text_len,
    text_dim]) of video ``index``, all f32."""
    return _video(cfg, traffic, seed, VIDEO + index, device)


def draw_calibration(cfg: Dict, traffic: Dict, seed: int, device):
    """The calibration sweep's (noise, text states, null text states)."""
    return _video(cfg, traffic, seed, CALIB, device)


def draw_lora(names, dims, rank: int, alpha: float, seed: int, device) -> Dict:
    """Initial QLoRA adapters: {"__scale__": alpha / rank, layer: {"a":
    N(0, 1/rank) [C_in, rank], "b": zeros [rank, C_out]}}, f32 (the adapted
    model starts as the base)."""
    g = generator(seed, LORA, device)
    lora = {"__scale__": torch.tensor(alpha / rank, dtype=torch.float32)}
    for name, (c_in, c_out) in zip(names, dims):
        a = torch.randn((c_in, rank), generator=g, device=device) / math.sqrt(rank)
        lora[name] = {"a": a, "b": torch.zeros((rank, c_out), device=device)}
    return lora


def draw_batch(cfg: Dict, traffic: Dict, seed: int, index: int, device) -> Dict:
    """Training batch ``index``: x0 and noise [batch, C, F, H, W], the timestep
    t [batch] (an integer in ``traffic["t_range"]``), text and null text
    states [batch, text_len, text_dim]."""
    g = generator(seed, BATCH + index, device)
    b = traffic["batch"]
    shape = (b, *latent_shape(cfg, traffic["width"], traffic["height"], traffic["frames"]))
    text = (b, cfg["text_len"], cfg["text_dim"])
    lo, hi = traffic["t_range"]
    return {"x0": torch.randn(shape, generator=g, device=device),
            "noise": torch.randn(shape, generator=g, device=device),
            "t": torch.randint(lo, hi + 1, (b,), generator=g, device=device).float(),
            "context": torch.randn(text, generator=g, device=device),
            "null_context": torch.randn(text, generator=g, device=device)}
