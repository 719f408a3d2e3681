"""The LKGD fine-tune's training data (counterpart of ``lkgd_tpu/data/datasets.py``):
``MiniDataset`` and a loader with the contract of the JAX package's ``PrefetchLoader``
that yields torch tensors on a device.

Video decoding is ``lkgd_torch/data/video_io.py`` (numpy; OpenCV is imported only when a
clip is read).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from lkgd_torch.data.video_io import process_frames, read_video_frames
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


class PrefetchLoader:
    """Shuffled, batched, background-prefetched loader: one thread keeps ``prefetch``
    stacked numpy batches queued; each is handed out as torch tensors on ``device``
    (the keys in ``drop_keys`` stay lists). Iterates epoch after epoch until the consumer
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
        return {k: ([s[k] for s in samples] if k in self.drop_keys
                    else np.stack([np.asarray(s[k]) for s in samples])) for k in samples[0]}

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
                           if isinstance(v, np.ndarray) else v) for k, v in batch.items()}
        finally:
            stop.set()
            thread.join(timeout=5.0)
