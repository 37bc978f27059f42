"""Latent dataset and prefetching loader for the distillation trainer
(counterpart of wanq_tpu/training/data.py).

* :class:`LatentDataset` reads a JSON index (a list of ``{"latent": path,
  "context": path?}`` entries, paths relative to the index); each sample is
  an npz holding ``latents [C, F, h, w]`` and optionally ``context [L, D]``
  inline when no separate context file is given.
* :func:`length_grouped_batches` shuffles and groups indices by temporal
  length so each batch stacks to one shape (``wanq_tpu``'s numpy draws: the
  same batches for a seed).
* :func:`prefetch_to_device` stages the next batches on a host thread
  (``np.stack``, pinned host memory when the target is the card) while the
  step runs, and copies each batch to the device with ``non_blocking``.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


class LatentDataset:
    """JSON-indexed precomputed latents (+ text embeddings)."""

    def __init__(self, index_path: str, num_latent_t: int = -1):
        self.root = os.path.dirname(os.path.abspath(index_path))
        with open(index_path) as f:
            self.entries: List[Dict[str, str]] = json.load(f)
        self.num_latent_t = num_latent_t
        self._lengths: Optional[List[int]] = None

    def __len__(self) -> int:
        return len(self.entries)

    def _path(self, rel: str) -> str:
        return rel if os.path.isabs(rel) else os.path.join(self.root, rel)

    def lengths(self) -> List[int]:
        """Each sample's latent frame count F (after the num_latent_t trim),
        read once."""
        if self._lengths is None:
            out = []
            for e in self.entries:
                with np.load(self._path(e["latent"])) as z:
                    f = int(z["latents"].shape[1])
                out.append(f if self.num_latent_t < 0 else min(f, self.num_latent_t))
            self._lengths = out
        return self._lengths

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        e = self.entries[i]
        with np.load(self._path(e["latent"])) as z:
            lat = np.asarray(z["latents"], np.float32)
            ctx = np.asarray(z["context"], np.float32) if "context" in z.files else None
        if "context" in e:
            with np.load(self._path(e["context"])) as z:
                ctx = np.asarray(z[z.files[0]], np.float32)
        if self.num_latent_t >= 0:
            lat = lat[:, : self.num_latent_t]
        out = {"latents": lat}
        if ctx is not None:
            out["context"] = ctx
        return out


def length_grouped_batches(lengths: Sequence[int], batch_size: int,
                           seed: int = 0) -> List[List[int]]:
    """Shuffled batches of indices of one latent length each; a group's
    remainder short of a batch is dropped."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(lengths))
    by_len: Dict[int, List[int]] = {}
    for i in order:
        by_len.setdefault(int(lengths[int(i)]), []).append(int(i))
    batches = []
    for group in by_len.values():
        for j in range(0, len(group) - batch_size + 1, batch_size):
            batches.append(group[j: j + batch_size])
    rng.shuffle(batches)
    return batches


def prefetch_to_device(dataset: LatentDataset, batches: Sequence[Sequence[int]],
                       prefetch: int = 2, device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches as tensors on ``device``; a host thread stacks up to
    ``prefetch`` batches ahead (into pinned memory for the card, so the copy
    runs asynchronously). An error in the thread (a missing or corrupt npz)
    is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    end = object()
    pin = torch.device(device).type == "cuda"

    def producer():
        try:
            for idxs in batches:
                samples = [dataset[i] for i in idxs]
                batch = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
                         for k in samples[0]}
                q.put({k: v.pin_memory() for k, v in batch.items()} if pin else batch)
        except BaseException as exc:  # noqa: BLE001 -- raised in the consumer
            q.put(("__error__", exc))
        finally:
            q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            break
        if isinstance(item, tuple) and item[0] == "__error__":
            raise item[1]
        yield {k: v.to(device, non_blocking=True) for k, v in item.items()}
