"""PTQ CLI (counterpart of wanq_tpu/cli/ptq.py): quant params (scales,
zero points, SmoothQuant masks, the rotation seed) and the deployed
weights, saved as the quant-state artifact that ``quant_generate
--quant_params`` loads (wanq_tpu's npz format, readable by either package).

    python -m wanq_tpu_torch.cli.ptq --task t2v-1.3B --random_init \
        --quant_config quant_configs/config.yaml \
        --calib_data quant_data/calib_data_wanx1.npz --save_path quant_params.npz

The weights are made on ``--device`` (the card by default) and the PTQ runs
there, the rotations' f64 transforms included. ``--targets int8`` leaves the
f32 fake-quant weights that only sim mode reads out of the artifact.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np

from wanq_tpu_torch.cli.common import add_common_args, load_params, setup_logging, validate_args
from wanq_tpu_torch.configs import SIZE_CONFIGS, WAN_CONFIGS
from wanq_tpu_torch.models.dit import linear_layer_names
from wanq_tpu_torch.quant import QuantConfig
from wanq_tpu_torch.quant.ptq import load_reference_calib, prepare_quant_state, save_quant_state

# A calibrated band denser than this saves little: K4's band mode takes time
# in proportion to the kv tiles it visits, on an H100 0.68x the dense call at
# density 0.65 (r = 8) and 0.99x at 1.0 (PERF.md, K4 band rows, chip_smoke.py).
BAND_DENSITY_WARN = 0.9


def parse_args(argv=None):
    p = argparse.ArgumentParser("wanq_tpu_torch ptq")
    add_common_args(p)
    p.add_argument("--quant_config", type=str, required=True)
    p.add_argument("--calib_data", type=str, default=None,
                   help="npz from get_calib_data (or a reference .pth); default: the YAML's "
                        "calib_data.save_path with .pth read as .npz")
    p.add_argument("--save_path", type=str, default="quant_params.npz")
    p.add_argument("--rotation_seed", type=int, default=0)
    p.add_argument("--targets", type=str, default="both", choices=["both", "int8", "sim"],
                   help="the deployed weights the artifact holds: both (wanq_tpu's artifact: "
                        "the f32 fake-quant w_q that sim mode reads beside the int codes), "
                        "int8 (the codes only, for --hardware: at 14B the f32 w_q would be "
                        "~40 GB) or sim")
    p.add_argument("--suggest_window", type=float, default=0.0, metavar="THRESHOLD",
                   help="derive sliding temporal-window radii from the calibration attention "
                        "maps (get_calib_data --attn_map_pool N --attn_map_reduce mean): per "
                        "head the smallest radius keeping >= THRESHOLD of the attention mass, "
                        "and one radius for all (their max). Logged and returned; deploy with "
                        "quant_generate --attn_window. 0 = off")
    p.add_argument("--check_reference_params", type=str, default=None,
                   metavar="QUANT_PARAMS_PTH",
                   help="after PTQ, import a reference quant_params.pth and log a scale-dict "
                        "parity report (per-layer max rel err of delta_w / zp_w / channel_mask "
                        "/ static act scales)")
    return p.parse_args(argv)


def generate(args):
    """Run PTQ and write the artifact; returns its path, or (path, radius)
    with --suggest_window."""
    setup_logging()
    validate_args(args, mesh=False)
    cfg = WAN_CONFIGS[args.task]
    qcfg = QuantConfig.from_yaml(args.quant_config)
    params = load_params(args, cfg)
    calib = None
    path = args.calib_data or (
        qcfg.calib_save_path and qcfg.calib_save_path.replace(".pth", ".npz"))
    if path:
        try:
            calib = load_reference_calib(path) if path.endswith(".pth") else dict(np.load(path))
            logging.info("loaded calibration data: %d entries from %s", len(calib), path)
        except FileNotFoundError:
            logging.warning("no calibration data at %s", path)

    t0 = time.time()
    policies, state, _ = prepare_quant_state(params, linear_layer_names(cfg), qcfg,
                                             calib=calib, seed=args.rotation_seed,
                                             targets=args.targets)
    n_q = sum(p.is_quantized for p in policies.values())
    logging.info("PTQ done in %.2fs: %d/%d layers quantized", time.time() - t0, n_q,
                 len(policies))
    save_quant_state(args.save_path, state, seed=args.rotation_seed)
    logging.info("saved %s", args.save_path)

    if args.suggest_window > 0.0:
        return args.save_path, _suggest_window(args, cfg, calib)
    if args.check_reference_params:
        from wanq_tpu_torch.quant.ptq import compare_scale_dicts, load_reference_quant_params

        report = compare_scale_dicts(state, load_reference_quant_params(
            args.check_reference_params))
        layer, key, err = report["worst"]
        logging.info("scale-dict parity vs %s: %d shared layers, worst %s.%s rel_err=%.3e, "
                     "pass(rtol=1e-3)=%s", args.check_reference_params, len(report["layers"]),
                     layer, key, err, report["pass"])
        for lname, errs in sorted(report["layers"].items()):
            bad = {k: v for k, v in errs.items() if v > 1e-3}
            if bad:
                logging.warning("  %s: %s", lname, bad)
    return args.save_path


def _suggest_window(args, cfg, calib) -> int:
    """Per-head radii from the pooled calibration maps, logged with the one
    deployable radius (their max), which is returned."""
    from wanq_tpu_torch.models.attention import TemporalWindow
    from wanq_tpu_torch.pipelines.text2video import compute_target_shape
    from wanq_tpu_torch.quant.attn import (
        collapse_window_radii, per_head_window_radii, select_temporal_windows)

    maps = {k[: -len(".attn_map")]: np.asarray(v, np.float64).mean(axis=0)
            for k, v in (calib or {}).items() if k.endswith(".attn_map")}
    if not maps:
        raise SystemExit("--suggest_window needs pooled attention maps in the calibration "
                         "artifact; run get_calib_data with --attn_map_pool N "
                         "--attn_map_reduce mean")
    pool = int(calib.get("attn_map_pool", 1))
    ts = compute_target_shape(cfg, SIZE_CONFIGS[args.size], args.frame_num)
    tpf = (ts[2] // cfg.patch_size[1]) * (ts[3] // cfg.patch_size[2])
    n_frames = ts[1] // cfg.patch_size[0]
    radii = select_temporal_windows(maps, tpf, pool, threshold=args.suggest_window,
                                    valid_len=n_frames * tpf)
    radius = collapse_window_radii(radii)
    for lname, r in sorted(radii.items()):
        logging.info("  %s: per-head radii %s", lname, r.tolist())
    per_head = ",".join(str(int(r)) for r in per_head_window_radii(radii))
    logging.info("suggested sliding-window radius (mass >= %.2f, %d latent frames): %d; "
                 "deploy with --attn_window %d, or per head --attn_window %s",
                 args.suggest_window, n_frames, radius, radius, per_head)
    density = float(np.mean([
        TemporalWindow(tpf, int(np.max(r)), head_radii=tuple(int(x) for x in r)).density(n_frames)
        for r in radii.values()]))
    if density > BAND_DENSITY_WARN:
        logging.warning(
            "calibrated band density %.2f is above %.2f: K4's band mode then visits nearly "
            "every kv tile and saves little over dense attention; deploy dense or lower "
            "--suggest_window (maps this uniform usually mean random-init weights)",
            density, BAND_DENSITY_WARN)
    return radius


if __name__ == "__main__":
    generate(parse_args())
