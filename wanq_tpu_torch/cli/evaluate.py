"""Offline fidelity evaluation (counterpart of wanq_tpu/cli/evaluate.py):
PSNR, relative error, cosine and FPFVD between an FP output set and a
quantized one, and optionally the CLIP and motion metrics.

    python -m wanq_tpu_torch.cli.evaluate --fp fp.npz --quant q.npz \\
        [--clip_metrics] [--flow_score] [--device cuda]

Inputs are .npz files. The array is taken from the key 'videos'
([N, T, H, W, 3]), else 'latents' ([N, C, F, h, w] DiT latents, scored
through fvd.latents_as_videos), else 'images' ([N, H, W, 3] t2i outputs,
scored with FPFID), else the first array (a 4-D channels-last array is
images, a 5-D one videos when its last axis is 3, latents otherwise). As
in wanq_tpu, 'latents' comes before 'video': on the npz of generate or
fp_generate, which holds both, evaluate scores the latents; save the
decoded frames as 'videos' [N, T, H, W, 3] to score them.

The feature nets and the CLIP tower run on ``--device`` (the card unless
told otherwise; a CUDA device without a card raises). Without
``--clip_checkpoint`` the CLIP tower is random: drawn on the card by a
``torch.Generator`` (other bits than wanq_tpu's numpy draw) or, on the CPU,
wanq_tpu's own draw. The report prints as one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _load(path: str):
    """-> (array, kind) with kind in {'videos', 'latents', 'images'}."""
    data = np.load(path)
    for kind in ("videos", "latents", "images"):
        if kind in data.files:
            return data[kind], kind
    arr = data[data.files[0]]
    if arr.ndim == 4 and arr.shape[-1] == 3:
        return arr, "images"
    if arr.ndim != 5:
        raise SystemExit(
            f"{path}: expected videos [N,T,H,W,3], latents [N,C,F,h,w], or "
            f"images [N,H,W,3]; got shape {arr.shape}. Save under an "
            "explicit 'videos'/'latents'/'images' key to disambiguate.")
    return arr, "videos" if arr.shape[-1] == 3 else "latents"


def _prompts(args, n: int):
    if not args.prompts:
        return [f"sample_{i:04d}" for i in range(n)]
    with open(args.prompts) as f:
        return [ln.strip() for ln in f if ln.strip()]


def clip_params(cfg, checkpoint, device):
    """The CLIP tower's params on ``device``: the checkpoint's, else a
    random draw (on the card by a torch.Generator seeded 0, on the CPU
    init_clip_params' numpy draw, wanq_tpu's bits)."""
    from wanq_tpu_torch.models import clip as clipm

    if checkpoint is None and str(device).startswith("cuda"):
        return clipm.init_clip_params_on_device(cfg, seed=0, device=device)
    return clipm.CLIPModel(cfg, checkpoint_path=checkpoint, device=device).params


def parse_args(argv=None):
    p = argparse.ArgumentParser("wanq_tpu_torch evaluate")
    p.add_argument("--fp", required=True, help="FP outputs (.npz)")
    p.add_argument("--quant", required=True, help="quantized outputs (.npz)")
    p.add_argument("--feat_dim", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clip_metrics", action="store_true",
                   help="also CLIP-Temp, temporal flicker and the FP-vs-quant CLIP frame "
                        "cosine through models/clip.py's tower (utils/clip_metrics.py)")
    p.add_argument("--clip_checkpoint", default=None,
                   help="Wan CLIP .pth for real CLIP features (random weights otherwise)")
    p.add_argument("--flow_score", action="store_true",
                   help="also the motion flow-score of both sets (utils/flow.py: classical "
                        "optical flow; the reference uses RAFT, an external pretrained net)")
    p.add_argument("--vbench_out", default=None,
                   help="also export the QUANT videos in VBench's layout (<group>/<prompt>.mp4, "
                        "a full-info json and a runner script; needs imageio)")
    p.add_argument("--prompts", default=None,
                   help="prompt file (one per line) naming the videos or images for "
                        "--vbench_out / --imagereward_out")
    p.add_argument("--fps", type=int, default=16)
    p.add_argument("--vbench_results", nargs="+", default=None,
                   help="fold VBench *_eval_results.json files (or dirs of them) into the report")
    p.add_argument("--imagereward_out", default=None,
                   help="export the QUANT images in the reward-scoring layout (output_{i}.jpg, "
                        "prompts.txt, a runner; t2i only, needs imageio)")
    p.add_argument("--imagereward_results", default=None,
                   help="fold a reward model's result-score.json into the report")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the feature nets, the CLIP tower and the flow; "
                        "'cpu' for tests and tiny runs")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from wanq_tpu_torch.cli.common import check_device
    from wanq_tpu_torch.utils.fvd import I3DLikeFeatures, fpfvd_report, latents_as_videos

    check_device(args.device)
    dev = args.device
    fp, fp_kind = _load(args.fp)
    q, q_kind = _load(args.quant)
    if fp_kind == "latents":
        fp, fp_kind = latents_as_videos(fp), "videos"
    if q_kind == "latents":
        q, q_kind = latents_as_videos(q), "videos"
    if fp.shape != q.shape or fp_kind != q_kind:
        raise SystemExit(f"--fp is {fp_kind} {fp.shape}, --quant {q_kind} {q.shape}")
    default_net = args.feat_dim == 256 and args.seed == 0

    if fp_kind == "images":  # t2i: FPFID
        from wanq_tpu_torch.utils.image_metrics import InceptionLikeFeatures, fpfid_report

        net = None if default_net else InceptionLikeFeatures(args.feat_dim, args.seed, device=dev)
        rep = fpfid_report(fp, q, feature_fn=net, device=dev)
    else:
        net = None if default_net else I3DLikeFeatures(args.feat_dim, args.seed, device=dev)
        rep = fpfvd_report(fp, q, feature_fn=net, device=dev)

    if args.clip_metrics:
        from wanq_tpu_torch.models import clip as clipm
        from wanq_tpu_torch.utils.clip_metrics import clip_fidelity_report

        cfg = clipm.CLIP_XLM_ROBERTA_VIT_H_14
        params = clip_params(cfg, args.clip_checkpoint, dev)
        fp_v = fp[:, None] if fp_kind == "images" else fp
        q_v = q[:, None] if q_kind == "images" else q
        crep = clip_fidelity_report(fp_v, q_v, params, cfg, device=dev)
        del params
        if fp_kind == "images":
            # single-frame "videos": the temporal metrics would read a
            # constant 1.0, a perfect score; only the frame-level entries stay
            crep = {k: v for k, v in crep.items()
                    if not k.startswith(("clip_temp", "flicker"))}
        rep.update(crep)
        if not args.clip_checkpoint:
            rep["clip_random_init"] = 1.0  # a rank-preserving probe only

    if args.flow_score:
        if fp_kind == "images":
            raise SystemExit("--flow_score needs videos, not t2i images")
        from wanq_tpu_torch.utils.flow import flow_score

        rep["flow_score_fp"] = flow_score(fp, device=dev)
        rep["flow_score_quant"] = flow_score(q, device=dev)

    if args.vbench_out:
        from wanq_tpu_torch.utils.vbench import export_vbench

        if fp_kind == "images":
            raise SystemExit("--vbench_out needs videos, not t2i images")
        prompts = _prompts(args, q.shape[0])
        if len(prompts) != q.shape[0]:
            raise SystemExit(f"{len(prompts)} prompts for {q.shape[0]} videos")
        info = export_vbench(q, prompts, args.vbench_out, fps=args.fps)
        rep["vbench_export"] = 1.0
        print(f"VBench layout written: {info}")

    if args.vbench_results:
        from wanq_tpu_torch.utils.vbench import ingest_vbench_results

        rep.update({f"vbench_{k}" if not k.startswith("vbench") else k: v
                    for k, v in ingest_vbench_results(args.vbench_results).items()})

    if args.imagereward_out:
        from wanq_tpu_torch.utils.imagereward import export_imagereward

        if q_kind != "images":
            raise SystemExit("--imagereward_out needs t2i images")
        export_imagereward(q, _prompts(args, q.shape[0]), args.imagereward_out)
        rep["imagereward_export"] = 1.0
        print(f"reward-scoring layout written: {args.imagereward_out}")

    if args.imagereward_results:
        from wanq_tpu_torch.utils.imagereward import ingest_imagereward

        rep.update(ingest_imagereward(args.imagereward_results))

    print(json.dumps({k: float(v) for k, v in rep.items()}))
    return rep


if __name__ == "__main__":
    main()
