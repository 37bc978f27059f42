"""ImageReward / HPS / PickScore adapter, the text-to-image reward-model
evaluation (counterpart of wanq_tpu/utils/imagereward.py).

The reference scores t2i outputs with external pretrained reward models
through ``eval/image/evaluation/test_score.py``: a CocoDataset reads
``--img_dir`` images named ``output_{index}.jpg`` against a
``--prompts_path`` text file (one prompt per line), calls
``model.score(prompt, image_path)`` per sample and writes
``result_{mode}/result-score.json`` as ``{id: reward}``
(test_score.py:18-107). The reward nets stay external; this module writes
their input layout (:func:`export_imagereward`, which needs imageio) and
reads their output JSON back into a summary (:func:`ingest_imagereward`),
as utils/vbench.py does for VBench.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np

METRICS = ("ImageReward", "HPS", "Aesthetic", "CLIP", "BLIP", "PickScore")


def export_imagereward(
    images: np.ndarray,
    prompts: Sequence[str],
    out_dir: str,
    value_range=(-1.0, 1.0),
) -> str:
    """Write t2i outputs in the reward-scoring layout. Returns out_dir.

    images: [N, H, W, 3] float in ``value_range`` (or uint8).
    Produces ``output_{i}.jpg`` + ``prompts.txt`` + a runner script
    mirroring the reference's test-score.sh invocation.
    """
    import imageio.v2 as imageio

    images = np.asarray(images)
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"export_imagereward needs images [N, H, W, 3], got {images.shape}")
    if len(prompts) != images.shape[0]:
        raise ValueError(f"{len(prompts)} prompts for {images.shape[0]} images")
    os.makedirs(out_dir, exist_ok=True)

    if images.dtype != np.uint8:
        lo, hi = value_range
        images = np.clip((images.astype(np.float32) - lo) / (hi - lo), 0, 1)
        images = (images * 255.0 + 0.5).astype(np.uint8)

    for i, img in enumerate(images):
        imageio.imwrite(os.path.join(out_dir, f"output_{i}.jpg"), img)

    prompts_path = os.path.join(out_dir, "prompts.txt")
    with open(prompts_path, "w") as f:
        for p in prompts:
            f.write(p.strip().replace("\n", " ") + "\n")

    runner = os.path.join(out_dir, "run_imagereward.sh")
    with open(runner, "w") as f:
        f.write(
            "#!/bin/sh\n"
            "# generated by wanq_tpu_torch — run inside the reference's\n"
            "# eval/image/evaluation dir (reward-model checkpoints there).\n"
            "# Scores land in result_set/result-score.json; ingest with\n"
            "#   wanq_tpu_torch.cli.evaluate --imagereward_results <json>\n"
            'METRIC="${1:-ImageReward}"\n'
            f'python test_score.py --metric "$METRIC" --mode set '
            f'--img_dir "{os.path.abspath(out_dir)}" '
            f'--prompts_path "{os.path.abspath(prompts_path)}"\n'
        )
    os.chmod(runner, 0o755)
    return out_dir


def ingest_imagereward(result_json: str) -> Dict[str, float]:
    """Read a ``result-score.json`` (``{id: reward}``, test_score.py:97)
    back into ``{'reward_mean': .., 'reward_min': .., 'reward_max': ..,
    'n_scored': ..}``."""
    with open(result_json) as f:
        scores = json.load(f)
    vals = [float(v) for v in scores.values()]
    if not vals:
        raise ValueError(f"{result_json}: no scores")
    return {
        "reward_mean": float(np.mean(vals)),
        "reward_min": float(np.min(vals)),
        "reward_max": float(np.max(vals)),
        "n_scored": float(len(vals)),
    }
