"""Training data (counterpart of ``lkgd_tpu/data/datasets.py``): ``MiniDataset`` (the
LKGD fine-tune's clips), ``FramesFlowDataset`` (DAVIS-style frame folders with precomputed
flow, for flow training) and a loader with the contract of the JAX package's
``PrefetchLoader`` that yields torch tensors on a device.

Video decoding is ``lkgd_torch/data/video_io.py`` (numpy; OpenCV is imported only when a
clip is read).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lkgd_torch.data.video_io import process_frames, read_flo, read_image, read_video_frames
from lkgd_torch.utils.device import require_device


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


class PrefetchLoader:
    """Shuffled, batched, background-prefetched loader: one thread keeps ``prefetch``
    stacked batches queued (numpy arrays, or tensors where the samples hold tensors); each
    is handed out as torch tensors on ``device`` (the keys in ``drop_keys`` stay lists).
    Iterates epoch after epoch until the consumer
    stops; leaving the iteration stops the thread. ``device`` defaults to the card and
    raises when there is none: name ``"cpu"`` to get CPU tensors."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2, device="cuda", drop_keys: Sequence[str] = ("caption",)):
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
        samples = [self.dataset[int(i)] for i in batch_idx]

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
