"""Host-side video and image IO of the port (numpy, with cv2, imageio and PIL imported
where a file is read or written): the port's own copy of ``lkgd_tpu/data/video_io.py``,
which the port does not import. Readers give ``(T, H, W, 3)`` float32 frames in [0, 1]."""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def read_video_frames(path: str, max_frames: Optional[int] = None) -> Tuple[np.ndarray, float]:
    """Decode a video to (T, H, W, 3) float32 [0,1] + fps."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if max_frames is not None and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames).astype(np.float32) / 255.0, float(fps)


def probe_video(path: str) -> Tuple[int, float]:
    """(frame_count, fps) without decoding. Falls back to a decode count when the container
    header lies (CAP_PROP_FRAME_COUNT <= 0)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if n <= 0:
        n = 0
        while cap.grab():
            n += 1
    cap.release()
    if n <= 0:
        raise ValueError(f"no frames in {path}")
    return n, float(fps)


def read_video_range(path: str, start: int, stop: int, step: int = 1) -> np.ndarray:
    """Decode frames [start:stop:step] to (T, H, W, 3) float32 [0,1] — seeks to
    ``start`` instead of decoding the whole file (the VideoClips.get_clip analog)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    if start > 0:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
    frames = []
    pos = start
    while pos < stop:
        ok, frame = cap.read()
        if not ok:
            break
        if (pos - start) % step == 0:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        pos += 1
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}[{start}:{stop}:{step}]")
    return np.stack(frames).astype(np.float32) / 255.0


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 [0,1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def load_input(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Frames from a video/gif/image path or a directory of frames."""
    if os.path.isdir(path):
        files = sorted(os.listdir(path))
        frames = [read_image(os.path.join(path, f)) for f in files
                  if f.lower().endswith((".png", ".jpg", ".jpeg"))]
        return np.stack(frames[:max_frames] if max_frames else frames)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".png", ".jpg", ".jpeg"):
        return read_image(path)[None]
    if ext == ".gif":
        return read_gif(path)
    frames, _ = read_video_frames(path, max_frames)
    return frames


def read_gif(path: str) -> np.ndarray:
    """(T, H, W, 3) float32 [0, 1] frames of a GIF: imageio's reader where it is installed,
    else PIL's frames taken to RGB, which is what imageio's GIF reader (PIL's) returns."""
    try:
        import imageio.v3 as iio
    except ImportError:
        from PIL import Image, ImageSequence

        with Image.open(path) as im:
            frames = np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)])
    else:
        frames = iio.imread(path)
        if frames.ndim == 3:
            frames = frames[None]
    return frames[..., :3].astype(np.float32) / 255.0


def write_video(path: str, frames: np.ndarray, fps: int = 7) -> None:
    """frames (T, H, W, 3) in [0,1] -> mp4/gif. A GIF is written by PIL alone where imageio
    is not installed (imageio's GIF writer is PIL's)."""
    arr = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    ext = os.path.splitext(path)[1].lower()
    try:
        import imageio.v3 as iio
    except ImportError:
        if ext != ".gif":
            raise
        from PIL import Image

        images = [Image.fromarray(frame) for frame in arr]
        images[0].save(path, save_all=True, append_images=images[1:],
                       duration=int(1000 / fps), loop=0)
        return
    if ext == ".gif":
        iio.imwrite(path, arr, duration=int(1000 / fps), loop=0)
        return
    try:
        iio.imwrite(path, arr, fps=fps)
    except (OSError, ImportError):  # no imageio-ffmpeg backend in this image
        write_mp4(path, arr, fps)


def write_mp4(path, frames: np.ndarray, fps: int = 7) -> None:
    """uint8 (T, H, W, 3) RGB frames -> an ``mp4v`` mp4 through OpenCV alone (the card's
    machine has no imageio-ffmpeg)."""
    import cv2

    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"OpenCV cannot write an mp4 to {path}")
    for frame in frames:
        vw.write(np.ascontiguousarray(frame[..., ::-1]))
    vw.release()


def save_gifs_side_by_side(path: str, videos: Sequence[np.ndarray], fps: int = 7) -> None:
    """Stack videos horizontally into one gif."""
    joined = np.concatenate(list(videos), axis=2)
    write_video(path, joined, fps)


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo reader. (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != 202021.25:
            raise ValueError(f"invalid .flo magic in {path}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(np.float32(202021.25).tobytes())
        f.write(np.int32(w).tobytes())
        f.write(np.int32(h).tobytes())
        f.write(flow.astype(np.float32).tobytes())


def process_frames(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize (T, H, W, C) [0,1] frames to (height, width), aspect-preserving center crop."""
    import cv2

    t, fh, fw, c = frames.shape
    scale = max(height / fh, width / fw)
    rh, rw = int(round(fh * scale)), int(round(fw * scale))
    out = np.empty((t, height, width, c), frames.dtype)
    y0 = (rh - height) // 2
    x0 = (rw - width) // 2
    for i in range(t):
        r = cv2.resize(frames[i], (rw, rh), interpolation=cv2.INTER_AREA if scale < 1
                       else cv2.INTER_LINEAR)
        out[i] = r[y0:y0 + height, x0:x0 + width]
    return out
