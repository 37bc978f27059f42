"""Vision-input preprocessing for the vision-language prompt expander
(counterpart of wanq_tpu/utils/vision.py; the reference vendors Qwen-VL's
helpers, wan/utils/qwen_vl_utils.py: smart_resize :54, fetch_image :85,
fetch_video :274, process_vision_info :344).

Host code on PIL and numpy: its outputs feed a Hugging Face processor,
never the card. Qwen2.5-VL takes images whose sides are multiples of the
patch factor (28) with the pixel count clamped to a budget; videos are
sampled to an even frame count at ~2 fps within [4, 768] frames, each
frame resized under a per-frame pixel budget. A URL input raises: fetch
it first and pass a local path.
"""

from __future__ import annotations

import base64
import io
import math
import os
from typing import Any, Dict, List, Tuple, Union

import numpy as np

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = 24576 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768


def round_by_factor(n: float, factor: int) -> int:
    return round(n / factor) * factor


def ceil_by_factor(n: float, factor: int) -> int:
    return math.ceil(n / factor) * factor


def floor_by_factor(n: float, factor: int) -> int:
    return math.floor(n / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
) -> Tuple[int, int]:
    """(h, w) → the nearest dims that are multiples of ``factor`` with
    h*w in [min_pixels, max_pixels], aspect ratio preserved (≤ MAX_RATIO)."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"aspect ratio must be < {MAX_RATIO}, "
            f"got {max(height, width) / min(height, width):.1f}"
        )
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = floor_by_factor(height / beta, factor)
        w_bar = floor_by_factor(width / beta, factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def _open_image(image: Any):
    from PIL import Image

    if hasattr(image, "convert"):  # already a PIL image
        return image.convert("RGB")
    if isinstance(image, np.ndarray):
        return Image.fromarray(image.astype(np.uint8)).convert("RGB")
    if isinstance(image, str):
        if image.startswith("data:image"):
            _, b64 = image.split("base64,", 1)
            return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
        if image.startswith("file://"):
            return Image.open(image[len("file://"):]).convert("RGB")
        if image.startswith(("http://", "https://")):
            raise ValueError(
                "URL image inputs need network access; download first and "
                "pass a local path"
            )
        if os.path.exists(image):
            return Image.open(image).convert("RGB")
    raise ValueError(f"unrecognized image input: {type(image)}")


def fetch_image(ele: Union[Dict[str, Any], Any],
                size_factor: int = IMAGE_FACTOR):
    """Dict {'image'|'image_url', 'resized_height/width'? ,
    'min/max_pixels'?} (or a bare image) → resized RGB PIL image."""
    if not isinstance(ele, dict):
        ele = {"image": ele}
    img = _open_image(ele.get("image", ele.get("image_url")))
    w, h = img.size
    if "resized_height" in ele and "resized_width" in ele:
        rh, rw = smart_resize(
            int(ele["resized_height"]), int(ele["resized_width"]),
            factor=size_factor)
    else:
        rh, rw = smart_resize(
            h, w, factor=size_factor,
            min_pixels=int(ele.get("min_pixels", MIN_PIXELS)),
            max_pixels=int(ele.get("max_pixels", MAX_PIXELS)),
        )
    return img.resize((rw, rh))


def smart_nframes(ele: Dict[str, Any], total_frames: int,
                  video_fps: float) -> int:
    """Frame count to sample: explicit 'nframes' (rounded to FRAME_FACTOR)
    or fps-derived, clamped to [FPS_MIN_FRAMES, min(FPS_MAX_FRAMES, total)]."""
    if "nframes" in ele and "fps" in ele:
        raise ValueError("give only one of nframes / fps")
    if "nframes" in ele:
        nframes = round_by_factor(int(ele["nframes"]), FRAME_FACTOR)
    else:
        fps = float(ele.get("fps", FPS))
        min_f = ceil_by_factor(ele.get("min_frames", FPS_MIN_FRAMES),
                               FRAME_FACTOR)
        max_f = floor_by_factor(
            ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)),
            FRAME_FACTOR)
        nframes = total_frames / video_fps * fps
        nframes = min(max(nframes, min_f), max_f)
        nframes = floor_by_factor(nframes, FRAME_FACTOR)
    if not (FRAME_FACTOR <= nframes <= total_frames):
        raise ValueError(
            f"nframes must be in [{FRAME_FACTOR}, {total_frames}], "
            f"got {nframes}"
        )
    return int(nframes)


def fetch_video(ele: Dict[str, Any]) -> np.ndarray:
    """{'video': path | [frame paths/images], ...} → [T, H, W, 3] uint8,
    frames sampled per smart_nframes and resized per smart_resize."""
    video = ele["video"]
    if isinstance(video, (list, tuple)):
        frames = [np.asarray(fetch_image({"image": f, **{
            k: ele[k] for k in ("resized_height", "resized_width")
            if k in ele}})) for f in video]
        if len(frames) % FRAME_FACTOR:
            frames.append(frames[-1])  # pad to the frame factor
        return np.stack(frames)

    import imageio.v3 as iio

    arr = iio.imread(video)  # [T, H, W, 3]
    meta = {}
    try:
        meta = iio.immeta(video)
    except Exception:  # noqa: BLE001 — fps falls back below
        pass
    video_fps = float(meta.get("fps", FPS))
    total = arr.shape[0]
    nframes = smart_nframes(ele, total, video_fps)
    idx = np.linspace(0, total - 1, nframes).round().astype(int)
    frames = arr[idx]

    h, w = frames.shape[1:3]
    total_px = int(ele.get("total_pixels", VIDEO_TOTAL_PIXELS))
    max_px = max(min(int(ele.get("max_pixels", VIDEO_MAX_PIXELS)),
                     total_px / nframes * FRAME_FACTOR),
                 int(ele.get("min_pixels", VIDEO_MIN_PIXELS)))
    rh, rw = smart_resize(h, w, factor=IMAGE_FACTOR,
                          min_pixels=int(ele.get("min_pixels",
                                                 VIDEO_MIN_PIXELS)),
                          max_pixels=int(max_px))
    from PIL import Image

    out = np.stack([
        np.asarray(Image.fromarray(f).resize((rw, rh))) for f in frames
    ])
    return out


def extract_vision_info(conversations) -> List[Dict[str, Any]]:
    """Flatten chat-format messages into the image/video content dicts."""
    if conversations and isinstance(conversations[0], dict):
        conversations = [conversations]
    infos = []
    for conv in conversations:
        for msg in conv:
            content = msg.get("content")
            if not isinstance(content, (list, tuple)):
                continue
            for ele in content:
                if isinstance(ele, dict) and (
                    "image" in ele or "image_url" in ele or "video" in ele
                    or ele.get("type") in ("image", "image_url", "video")
                ):
                    infos.append(ele)
    return infos


def process_vision_info(conversations):
    """Chat messages → (image_inputs, video_inputs) for an HF VL processor
    (the reference's entry point, qwen_vl_utils.py:344)."""
    images: List[Any] = []
    videos: List[np.ndarray] = []
    for ele in extract_vision_info(conversations):
        if "image" in ele or "image_url" in ele:
            images.append(fetch_image(ele))
        elif "video" in ele:
            videos.append(fetch_video(ele))
        else:
            raise ValueError(f"content carries neither image nor video: {ele}")
    return (images or None), (videos or None)
