"""Training data (counterpart of ``lkgd_tpu/data/datasets.py``), numpy on the host:

* ``MiniDataset``: the LKGD fine-tune's clips, every mp4 of a folder kept in memory;
* ``WebVidCSV``: CSV-indexed clips at a target frame rate, retrying a bad sample;
* ``FramesFlowDataset``: DAVIS-style frame folders with precomputed flow;
* ``JsonVideoDataset`` (``CaptionedClipDataset``): json-indexed clips with captions;
* ``VideoClipIndex`` and ``WindowedClipDataset``: every fixed-length window of a corpus,
  probed once and cached on disk as JSON, corrupt files giving no windows and a failed
  decode retried on another window; ``panda_dataset`` and ``msrvtt_dataset`` build them
  the two ways the corpora of those names are read;
* ``MixDataset``: round-robin over several datasets;
* ``PrefetchLoader``: shuffled batches from a background thread, as torch tensors on a
  device; ``BucketedLoader``: batches of samples of one shape, as numpy arrays.

Each random draw of a dataset comes from the ``rng`` it was given (a
``np.random.Generator``), or, without one, from a fresh unseeded generator an item, as the
JAX package draws. Video decoding is ``lkgd_torch/data/video_io.py`` (numpy; OpenCV is
imported only when a clip is read).
"""

from __future__ import annotations

import csv
import glob
import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lkgd_torch.data import video_io
from lkgd_torch.data.video_io import process_frames, read_flo, read_image, read_video_frames
from lkgd_torch.utils.device import require_device


def _size(sample_size) -> Tuple[int, int]:
    return (sample_size, sample_size) if isinstance(sample_size, int) else tuple(sample_size)


def _rng(rng: Optional[np.random.Generator]) -> np.random.Generator:
    return np.random.default_rng() if rng is None else rng


class MiniDataset:
    """All mp4s of a folder, decoded once and kept in memory ``repeat_num`` times; each item
    is a random frame interval and start, resized, in [-1, 1], flipped left-right with
    probability 1/2: ``{"pixel_values": (T+1, H, W, 3), "fps": ()}``."""

    def __init__(self, video_folder: str, repeat_num: int = 10, sample_size=512,
                 sample_n_frames: int = 25):
        files = sorted(glob.glob(os.path.join(video_folder, "*.mp4")))
        if not files:
            raise FileNotFoundError(f"no mp4 files in {video_folder}")
        self.clips: List[Tuple[np.ndarray, float]] = [read_video_frames(f) for f in files]
        self.clips = self.clips * repeat_num
        self.sample_size = (sample_size, sample_size) if isinstance(sample_size, int) \
            else tuple(sample_size)
        self.sample_n_frames = sample_n_frames

    def __len__(self) -> int:
        return len(self.clips)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng()
        frames, fps = self.clips[idx]
        frame_len = len(frames)
        sample_len = self.sample_n_frames + 1
        if frame_len < sample_len:
            raise ValueError(f"need {sample_len} frames, clip has {frame_len}")
        interval = int(rng.integers(1, max(frame_len // sample_len, 1) + 1))
        start = int(rng.integers(0, max(frame_len - sample_len * interval, 0) + 1))
        sel = frames[start:start + sample_len * interval:interval]
        pixel_values = process_frames(sel, *self.sample_size)
        if rng.random() < 0.5:
            pixel_values = pixel_values[:, :, ::-1].copy()
        return {"pixel_values": pixel_values * 2.0 - 1.0, "fps": np.float32(fps / interval)}


class WebVidCSV:
    """CSV-indexed clips (``videoid`` and ``page_dir``, or ``path``; ``name`` is the
    caption): ``sample_n_frames`` frames at the interval nearest ``target_fps`` (the
    largest that fits in a short clip), from a random start. A sample that fails to load
    is replaced by the next row's, up to 8 tries."""

    def __init__(self, csv_path: str, video_folder: str, sample_size=512,
                 sample_n_frames: int = 14, target_fps: float = 7.0,
                 rng: Optional[np.random.Generator] = None):
        with open(csv_path) as f:
            self.rows = list(csv.DictReader(f))
        self.video_folder = video_folder
        self.sample_size = _size(sample_size)
        self.sample_n_frames = sample_n_frames
        self.target_fps = target_fps
        self.rng = rng

    def __len__(self) -> int:
        return len(self.rows)

    def _load(self, idx: int) -> Dict[str, np.ndarray]:
        row = self.rows[idx]
        rel = row.get("path") or os.path.join(str(row.get("page_dir", "")),
                                              f"{row['videoid']}.mp4")
        frames, fps = read_video_frames(os.path.join(self.video_folder, rel))
        interval = max(int(round(fps / self.target_fps)), 1)
        rng = _rng(self.rng)
        need = self.sample_n_frames * interval
        if len(frames) < need:
            interval = max(len(frames) // self.sample_n_frames, 1)
            need = self.sample_n_frames * interval
        start = int(rng.integers(0, max(len(frames) - need, 0) + 1))
        sel = frames[start:start + need:interval][: self.sample_n_frames]
        out = {"pixel_values": process_frames(sel, *self.sample_size) * 2.0 - 1.0,
               "fps": np.float32(fps / interval)}
        if "name" in row:
            out["caption"] = row["name"]
        return out

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        for attempt in range(8):
            try:
                return self._load((idx + attempt) % len(self))
            except Exception:  # a missing or undecodable file: the next row
                continue
        raise RuntimeError(f"failed to load any sample near index {idx}")


class FramesFlowDataset:
    """Folders of frames (``*.jpg``, ``*.png``; one folder a sequence under ``root``) and,
    under ``flow_root/<sequence>``, precomputed ``.flo`` flow. Each item is
    ``sample_n_frames`` frames from a random start, resized and centre-cropped, in [-1, 1],
    ``{"pixel_values": (T, H, W, 3), "fps": 7}``, with the T-1 flows that follow the start
    (``"flow"``) and the motion bucket they give (``min(300, (1 + mean|flow| / 3.5) * 127)``)
    when ``flow_root`` holds them."""

    def __init__(self, root: str, flow_root: Optional[str] = None, sample_size=512,
                 sample_n_frames: int = 14):
        self.seqs = sorted(d for d in glob.glob(os.path.join(root, "*")) if os.path.isdir(d))
        if not self.seqs:
            raise FileNotFoundError(f"no sequence dirs in {root}")
        self.flow_root = flow_root
        self.sample_size = (sample_size, sample_size) if isinstance(sample_size, int) \
            else tuple(sample_size)
        self.sample_n_frames = sample_n_frames

    def __len__(self) -> int:
        return len(self.seqs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        seq = self.seqs[idx]
        files = sorted(glob.glob(os.path.join(seq, "*.jpg"))
                       + glob.glob(os.path.join(seq, "*.png")))
        rng = np.random.default_rng()
        start = int(rng.integers(0, max(len(files) - self.sample_n_frames, 0) + 1))
        files = files[start:start + self.sample_n_frames]
        frames = np.stack([read_image(f) for f in files])
        pixel_values = process_frames(frames, *self.sample_size)
        out = {"pixel_values": pixel_values * 2.0 - 1.0, "fps": np.float32(7.0)}
        if self.flow_root is not None:
            name = os.path.basename(seq)
            flo_files = sorted(glob.glob(os.path.join(self.flow_root, name, "*.flo")))
            flo_files = flo_files[start:start + self.sample_n_frames - 1]
            if flo_files:
                flows = np.stack([read_flo(f) for f in flo_files])
                out["flow"] = flows
                strength = float(np.linalg.norm(flows, axis=-1).mean())
                out["motion_bucket_id"] = np.int32(min(300, int((1 + strength / 3.5) * 127)))
        return out


class JsonVideoDataset:
    """json-indexed clips, ``[{"path": ..., "caption": ...}, ...]``: ``sample_n_frames``
    consecutive frames from a random start, with the caption where the item has one."""

    def __init__(self, json_path: str, video_folder: str = "", sample_size=512,
                 sample_n_frames: int = 14, rng: Optional[np.random.Generator] = None):
        with open(json_path) as f:
            self.items = json.load(f)
        self.video_folder = video_folder
        self.sample_size = _size(sample_size)
        self.sample_n_frames = sample_n_frames
        self.rng = rng

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.items[idx]
        frames, fps = read_video_frames(os.path.join(self.video_folder, item["path"]))
        rng = _rng(self.rng)
        start = int(rng.integers(0, max(len(frames) - self.sample_n_frames, 0) + 1))
        sel = frames[start:start + self.sample_n_frames]
        out = {"pixel_values": process_frames(sel, *self.sample_size) * 2.0 - 1.0,
               "fps": np.float32(fps)}
        if "caption" in item:
            out["caption"] = item["caption"]
        return out


CaptionedClipDataset = JsonVideoDataset  # captioned corpora read the same way


class VideoClipIndex:
    """Every window of ``clip_length`` frames, every ``frames_between_clips`` frames,
    across a corpus of videos.

    Each video is probed once (frame count and fps, in a thread pool); the result is
    cached as JSON at ``cache_path`` and read back while the list of paths is the same.
    A video that fails to probe, or is shorter than one window, gives no window.
    ``frame_rate``: each video's timeline is resampled to that rate first (window index i
    reads frame floor(i * native_fps / frame_rate)), so every window spans the same time."""

    def __init__(self, video_paths: Sequence[str], clip_length: int,
                 frames_between_clips: int = 1, frame_rate: Optional[float] = None,
                 cache_path: Optional[str] = None, num_workers: int = 16):
        self.video_paths = list(video_paths)
        self.clip_length = clip_length
        self.stride = frames_between_clips
        self.frame_rate = frame_rate

        meta: Optional[dict] = None
        if cache_path and os.path.exists(cache_path):
            with open(cache_path) as f:
                cached = json.load(f)
            if cached.get("paths") == self.video_paths:
                meta = cached
        if meta is None:
            from concurrent.futures import ThreadPoolExecutor

            def probe(path):
                try:
                    return video_io.probe_video(path)
                except Exception:  # corrupt or unreadable: no windows
                    return (0, 0.0)

            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                results = list(pool.map(probe, self.video_paths))
            meta = {"paths": self.video_paths, "frames": [r[0] for r in results],
                    "fps": [r[1] for r in results]}
            if cache_path:
                os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
                with open(cache_path, "w") as f:
                    json.dump(meta, f)
        self.frames = list(meta["frames"])
        self.fps = list(meta["fps"])

        # (video index, first frame on the (resampled) timeline) of every window
        self._clips: List[Tuple[int, int]] = []
        for vi, n in enumerate(self.frames):
            eff = n if frame_rate is None or self.fps[vi] <= 0 else int(
                n * frame_rate / self.fps[vi])
            for start in range(0, eff - clip_length + 1, self.stride):
                self._clips.append((vi, start))

    def num_clips(self) -> int:
        return len(self._clips)

    def __len__(self) -> int:
        return len(self._clips)

    def get_clip(self, idx: int) -> Tuple[np.ndarray, Dict[str, float], int]:
        """(frames (L, H, W, 3) in [0, 1], {"video_fps"}, video index) of window ``idx``."""
        vi, start = self._clips[idx]
        path = self.video_paths[vi]
        native = self.fps[vi]
        if self.frame_rate is None:
            return (video_io.read_video_range(path, start, start + self.clip_length),
                    {"video_fps": native}, vi)
        idxs = np.floor((start + np.arange(self.clip_length))
                        * native / self.frame_rate).astype(int)
        idxs = np.minimum(idxs, self.frames[vi] - 1)
        lo, hi = int(idxs[0]), int(idxs[-1]) + 1
        block = video_io.read_video_range(path, lo, hi)
        return block[np.minimum(idxs - lo, len(block) - 1)], {"video_fps": self.frame_rate}, vi


class WindowedClipDataset:
    """Every ``sample_n_frames + extra_frames``-frame window of a corpus is a sample
    (``VideoClipIndex``), resized, in [-1, 1], flipped left-right with probability 1/2
    when ``flip``, with its caption: from ``caption_file`` (json, video basename ->
    caption) or else from a ``.txt`` beside the video. A window that fails to decode is
    replaced by a random other one, up to 8 tries."""

    def __init__(self, video_paths: Sequence[str], sample_size=512,
                 sample_n_frames: int = 14, frames_between_clips: int = 32,
                 frame_rate: Optional[float] = None, caption_file: Optional[str] = None,
                 cache_path: Optional[str] = None, flip: bool = True, extra_frames: int = 1,
                 rng: Optional[np.random.Generator] = None):
        self.index = VideoClipIndex(video_paths, sample_n_frames + extra_frames,
                                    frames_between_clips, frame_rate, cache_path)
        self.sample_size = _size(sample_size)
        self.sample_n_frames = sample_n_frames
        self.flip = flip
        self.rng = rng
        self.captions = None
        if caption_file:
            with open(caption_file) as f:
                self.captions = json.load(f)

    def __len__(self) -> int:
        return self.index.num_clips()

    def _caption(self, video_idx: int) -> str:
        path = self.index.video_paths[video_idx]
        if self.captions is not None:
            return self.captions.get(os.path.splitext(os.path.basename(path))[0], "")
        txt = os.path.splitext(path)[0] + ".txt"
        if os.path.exists(txt):
            with open(txt) as f:
                return f.read()
        return ""

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = _rng(self.rng)
        for _attempt in range(8):
            try:
                frames, info, vi = self.index.get_clip(idx)
                break
            except Exception:  # a failed decode: another window
                idx = int(rng.integers(0, len(self.index)))
        else:
            raise RuntimeError("8 consecutive clip decode failures")
        pixel_values = process_frames(frames, *self.sample_size)
        if self.flip and rng.random() < 0.5:
            pixel_values = pixel_values[:, :, ::-1].copy()
        return {"pixel_values": pixel_values * 2.0 - 1.0,
                "fps": np.float32(info["video_fps"]), "caption": self._caption(vi)}


def panda_dataset(video_folder: str, sample_size=512, sample_n_frames: int = 14,
                  cache_path: Optional[str] = ".cache/panda.clips.json",
                  rng: Optional[np.random.Generator] = None) -> WindowedClipDataset:
    """The Panda-70M layout: ``video_files.json`` lists the videos; windows of
    ``sample_n_frames + 1`` frames every 32 frames, captions in the sibling ``.txt``."""
    with open(os.path.join(video_folder, "video_files.json")) as f:
        paths = json.load(f)
    return WindowedClipDataset(paths, sample_size, sample_n_frames, frames_between_clips=32,
                               cache_path=cache_path, rng=rng)


def msrvtt_dataset(video_folder: str, caption_file: str, sample_size=512,
                   clip_length: int = 16,
                   cache_path: Optional[str] = ".cache/msrvtt.clips.json",
                   rng: Optional[np.random.Generator] = None) -> WindowedClipDataset:
    """The MSR-VTT layout: every mp4 of the folder, ``clip_length``-frame windows at stride
    1 on a 7 fps timeline, captions from the json file."""
    paths = sorted(glob.glob(os.path.join(video_folder, "*.mp4")))
    return WindowedClipDataset(paths, sample_size, clip_length, frames_between_clips=1,
                               frame_rate=7.0, caption_file=caption_file,
                               cache_path=cache_path, extra_frames=0, rng=rng)


class MixDataset:
    """Round-robin over ``datasets``: item i is item (i // n) (mod its length) of dataset
    i mod n."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)

    def __len__(self) -> int:
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, idx: int):
        d = self.datasets[idx % len(self.datasets)]
        return d[(idx // len(self.datasets)) % len(d)]


class PrefetchLoader:
    """Shuffled, batched, background-prefetched loader: one thread keeps ``prefetch``
    stacked batches queued (numpy arrays, or tensors where the samples hold tensors); each
    is handed out as torch tensors on ``device`` (the keys in ``drop_keys`` stay lists).
    Iterates epoch after epoch until the consumer
    stops; leaving the iteration stops the thread. ``device`` defaults to the card and
    raises when there is none: name ``"cpu"`` to get CPU tensors."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2, device="cuda", drop_keys: Sequence[str] = ("caption",),
                 rows: slice = slice(None)):
        self.rows = rows  # the rows of each batch this process loads (a data-parallel rank's)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.device = require_device(device)
        self.drop_keys = set(drop_keys)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        n = (len(idx) // self.batch_size) * self.batch_size
        return idx[:n].reshape(-1, self.batch_size)

    def _batch(self, batch_idx) -> dict:
        samples = [self.dataset[int(i)] for i in batch_idx[self.rows]]

        def stack(values):  # torch tensors (a tensor cache's, bf16 too) stay tensors
            if isinstance(values[0], torch.Tensor):
                return torch.stack(values)
            return np.stack([np.asarray(v) for v in values])

        return {k: ([s[k] for s in samples] if k in self.drop_keys
                    else stack([s[k] for s in samples])) for k in samples[0]}

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                epoch = 0
                while not stop.is_set():
                    for batch_idx in self._epoch_indices(epoch):
                        if not put(self._batch(batch_idx)):
                            return
                    epoch += 1
            except Exception as err:  # handed to the consumer, which raises it
                put(err)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if isinstance(batch, Exception):
                    raise batch
                yield {k: (torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                           if isinstance(v, np.ndarray) else
                           v.to(self.device) if isinstance(v, torch.Tensor) else v)
                       for k, v in batch.items()}
        finally:
            stop.set()
            thread.join(timeout=5.0)


class BucketedLoader:
    """Batches of one shape: samples are grouped by the shape of ``key`` and a batch is
    emitted, as stacked numpy arrays (the keys of ``drop_keys`` as lists), when its bucket
    holds ``batch_size`` samples. Epoch after epoch, shuffled from ``seed + epoch``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 key: str = "pixel_values", drop_keys: Sequence[str] = ("caption",)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.key = key
        self.drop_keys = set(drop_keys)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(len(self.dataset))
        epoch = 0
        buckets: Dict[tuple, list] = {}
        while True:
            order = idx.copy()
            if self.shuffle:
                np.random.default_rng(self.seed + epoch).shuffle(order)
            for i in order:
                sample = self.dataset[int(i)]
                shape = tuple(np.asarray(sample[self.key]).shape)
                buckets.setdefault(shape, []).append(sample)
                if len(buckets[shape]) == self.batch_size:
                    samples = buckets.pop(shape)
                    yield {k: ([s[k] for s in samples] if k in self.drop_keys
                               else np.stack([np.asarray(s[k]) for s in samples]))
                           for k in samples[0]}
            epoch += 1
