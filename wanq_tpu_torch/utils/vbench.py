"""VBench output adapter (counterpart of wanq_tpu/utils/vbench.py).

The reference's headline evaluation is the VBench 8-dimension suite
(eval/video/Vbench/evaluate.py + main.sh). Its loader expects a directory
of videos named ``<prompt>.mp4`` (``VBench.build_full_info_json`` matches
``f'{prompt}{special_str}.mp4'`` against ``os.listdir(videos_path)``,
vbench/__init__.py:33-59) and a full-info JSON of
``{prompt_en, dimension, video_list}`` entries (``--custom_input`` builds
one from the file names alone, :26-31).

This module writes that layout from generated videos, so the external
VBench tooling (its pretrained evaluator nets stay outside this repo)
scores them unchanged:

    out_dir/
      <group>/<prompt>.mp4 ...       (one folder per dimension group,
                                      as main.sh's VIDEO_PATH/<group>)
      vbench_full_info.json          (the custom full-info list)
      run_vbench.sh, run_external_metrics.sh

and reads VBench's ``*_eval_results.json`` back
(:func:`ingest_vbench_results`). The videos go through
utils/video.py::cache_video, which needs imageio: without it the export
raises ImportError. Usage: ``cli.evaluate --vbench_out DIR --prompts
prompts.txt`` or :func:`export_vbench`.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

# the 8 dimensions the reference selects (eval/video/Vbench/main.sh) and
# the video-subdir group each is evaluated from
DIMENSION_GROUPS: Dict[str, str] = {
    "aesthetic_quality": "overall_consistency",
    "imaging_quality": "overall_consistency",
    "overall_consistency": "overall_consistency",
    "scene": "scene",
    "background_consistency": "scene",
    "subject_consistency": "subject_consistency",
    "dynamic_degree": "subject_consistency",
    "motion_smoothness": "subject_consistency",
}


def _safe_name(prompt: str) -> str:
    """VBench names videos by the literal prompt; only strip characters
    that cannot appear in a filename."""
    return re.sub(r"[/\0]", "_", prompt.strip())


def export_vbench(
    videos: np.ndarray,
    prompts: Sequence[str],
    out_dir: str,
    fps: int = 16,
    dimensions: Optional[Sequence[str]] = None,
    value_range=(-1.0, 1.0),
) -> str:
    """Write ``videos`` ([N, C, T, H, W] or [N, T, H, W, C] float) in the
    VBench-consumable layout. Returns the full-info json path.

    One copy of each video lands in every dimension-group subdir it is
    evaluated from (main.sh routes e.g. aesthetic_quality and
    imaging_quality to the same ``overall_consistency`` folder)."""
    from wanq_tpu_torch.utils.video import cache_video

    videos = np.asarray(videos, np.float32)
    if videos.ndim != 5:
        raise ValueError(f"export_vbench needs videos [N, T, H, W, C], got {videos.shape}")
    if videos.shape[-1] in (1, 3) and videos.shape[1] not in (1, 3):
        videos = videos.transpose(0, 4, 1, 2, 3)  # N,T,H,W,C → N,C,T,H,W
    if len(prompts) != videos.shape[0]:
        raise ValueError(f"{len(prompts)} prompts for {videos.shape[0]} videos")

    dims = list(dimensions) if dimensions else list(DIMENSION_GROUPS)
    unknown = [d for d in dims if d not in DIMENSION_GROUPS]
    if unknown:
        raise ValueError(f"unknown VBench dimensions: {unknown}")
    groups = sorted({DIMENSION_GROUPS[d] for d in dims})

    full_info: List[dict] = []
    for prompt, vid in zip(prompts, videos):
        fname = f"{_safe_name(prompt)}.mp4"
        paths = []
        for g in groups:
            gdir = os.path.join(out_dir, g)
            os.makedirs(gdir, exist_ok=True)
            saved = cache_video(vid, os.path.join(gdir, fname), fps=fps,
                                value_range=value_range)
            if saved:
                paths.append(saved)
        full_info.append(
            {"prompt_en": prompt.strip(), "dimension": dims,
             "video_list": paths}
        )

    info_path = os.path.join(out_dir, "vbench_full_info.json")
    os.makedirs(out_dir, exist_ok=True)
    with open(info_path, "w") as f:
        json.dump(full_info, f, indent=1, ensure_ascii=False)

    # runner script mirroring the reference's main.sh invocation pattern
    runner = os.path.join(out_dir, "run_vbench.sh")
    vdir = os.path.abspath(os.path.join(out_dir, groups[0]))
    with open(runner, "w") as f:
        f.write("#!/bin/sh\n# generated by wanq_tpu_torch — run inside the\n")
        f.write("# reference's eval/video/Vbench dir (external nets there)\n")
        f.write('OUT="${1:-./evaluation_results}"\n')
        for d in dims:
            g = DIMENSION_GROUPS[d]
            f.write(
                f'python evaluate.py --output_path "$OUT" '
                f"--dimension '{d}' --videos_path "
                f'"{os.path.abspath(os.path.join(out_dir, g))}" '
                f"--custom_input\n"
            )
    os.chmod(runner, 0o755)

    # external multi-aspect glue (ref eval/video/metrics/
    # simplebench_comp_101.sh): DOVER VQA + RAFT flow-score over the same
    # exported videos — run inside the reference's eval/video/metrics dir
    ext = os.path.join(out_dir, "run_external_metrics.sh")
    with open(ext, "w") as f:
        f.write(
            "#!/bin/sh\n"
            "# generated by wanq_tpu_torch — run inside the reference's\n"
            "# eval/video/metrics dir (DOVER / RAFT checkpoints there);\n"
            "# the in-repo equivalents (FPFVD, CLIP metrics, flickering,\n"
            "# classical flow-score) live in `wanq_tpu_torch.cli.evaluate`.\n"
            'RESULTS="${1:-./logs/wanq}"\nmkdir -p "$RESULTS"\n'
            f'python3 evaluate_a_set_of_videos.py --dir_videos "{vdir}" '
            '--dir_results "$RESULTS"\n'
            "cd ./RAFT\n"
            f'python3 optical_flow_scores.py --dir_videos "{vdir}" '
            "--metric 'flow_score' --dir_results \"../$RESULTS\"\ncd ..\n"
        )
    os.chmod(ext, 0o755)
    return info_path


def ingest_vbench_results(paths) -> Dict[str, float]:
    """Read VBench ``*_eval_results.json`` outputs back into one summary.

    The reference runner saves one JSON per dimension-group invocation
    (``save_json(results_dict, output_name)``, vbench/__init__.py:88)
    where ``results_dict[dimension]`` is ``[avg_score, per_video_list]``
    (each ``compute_<dimension>`` returns that pair) or occasionally a
    bare float. ``paths`` may be individual JSON files or directories to
    scan for ``*_eval_results.json``.

    Returns ``{dimension: score, ..., 'vbench_mean_raw': mean}`` — the
    raw arithmetic mean across dimensions (VBench's leaderboard applies
    per-dimension min-max normalization with constants that live in the
    external suite; raw scores are what its JSON carries).
    """
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(
                os.path.join(p, f) for f in sorted(os.listdir(p))
                if f.endswith("_eval_results.json")
            )
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no *_eval_results.json under {paths}")

    out: Dict[str, float] = {}
    for fp in files:
        with open(fp) as f:
            results = json.load(f)
        for dim, res in results.items():
            if isinstance(res, (list, tuple)):
                score = float(res[0])
            elif isinstance(res, dict):  # some dims key by 'score'
                score = float(res.get("score", next(iter(res.values()))))
            else:
                score = float(res)
            out[dim] = score
    out["vbench_mean_raw"] = sum(
        v for k, v in out.items() if k != "vbench_mean_raw"
    ) / max(len(out), 1)
    return out
