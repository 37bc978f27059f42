"""Output helpers (counterpart of wanq_tpu/utils/video.py): a [-1, 1] video
or image to an mp4, GIF or image file. imageio is imported when a file is
written; where it is missing, :func:`cache_video` and :func:`cache_image`
raise ImportError and write nothing."""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np


def _to_uint8(video: np.ndarray, value_range=(-1.0, 1.0)) -> np.ndarray:
    lo, hi = value_range
    v = np.clip((video - lo) / (hi - lo), 0.0, 1.0)
    return (v * 255.0).round().astype(np.uint8)


def _imageio():
    try:
        import imageio
    except ImportError as e:
        raise ImportError(
            "writing a video or image file needs the imageio package, which is not "
            "installed; the decoded frames are still in the npz's 'video' array") from e
    return imageio


def cache_video(tensor, save_file: str, fps: int = 30, value_range=(-1.0, 1.0),
                retry: int = 5) -> Optional[str]:
    """Save a [C, T, H, W] (or [B, C, T, H, W]: the first sample) video as
    an mp4 (libx264), or as a GIF where imageio has no mp4 backend. Returns
    the path written, None after ``retry`` failed attempts."""
    imageio = _imageio()
    arr = np.asarray(tensor, dtype=np.float32)
    if arr.ndim == 5:
        arr = arr[0]
    if arr.ndim != 4 or arr.shape[0] not in (1, 3):
        raise ValueError(f"expected [C, T, H, W] with C in (1, 3), got {arr.shape}")
    frames = _to_uint8(arr, value_range).transpose(1, 2, 3, 0)  # T, H, W, C
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    for _ in range(retry):
        try:
            writer = imageio.get_writer(save_file, fps=fps, codec="libx264", quality=8)
            for f in frames:
                writer.append_data(f)
            writer.close()
            return save_file
        except ValueError:
            # no mp4 backend (imageio-ffmpeg absent): a GIF through Pillow
            gif = os.path.splitext(save_file)[0] + ".gif"
            logging.warning("no mp4 backend; writing %s instead", gif)
            imageio.mimsave(gif, list(frames), duration=1000.0 / fps, loop=0)
            return gif
        except OSError as e:
            logging.warning("cache_video retry after %s", e)
    logging.error("cache_video failed for %s", save_file)
    return None


def cache_image(tensor, save_file: str, value_range=(-1.0, 1.0)) -> Optional[str]:
    """Save a [C, H, W] (or [B, C, H, W]: the first sample) image."""
    imageio = _imageio()
    arr = np.asarray(tensor, dtype=np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    imageio.imwrite(save_file, _to_uint8(arr, value_range).transpose(1, 2, 0))
    return save_file


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    v = str(v).lower()
    if v in ("yes", "true", "t", "y", "1"):
        return True
    if v in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"invalid boolean value {v!r}")
