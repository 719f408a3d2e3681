"""The native tensor cache (counterpart of ``lkgd_tpu/data/tensor_cache.py``): precomputed
VAE latents and T5 prompt embeddings packed into ONE mmap'd append-only file with an
in-memory index, the host data path of cached-latent training (``PrecomputedLatentDataset``).

The store is ``native/tensor_cache.cc``, the one source the two packages share: the same
file format, so a cache either package writes reads back, byte for byte, in the other. The
port builds its own copy of the shared library with ``g++ -O2 -std=c++17 -fPIC -shared``
into ``lkgd_torch/_build/`` on first use (rebuilt when the source is newer) and binds it
with ctypes; it writes nothing into ``native/``.

Entries come back as CPU ``torch.Tensor``s. The dtype ids are the JAX package's: float32 0,
float16 1, int32 2, int64 3, uint8 4, bfloat16 5; bfloat16 needs no numpy extension here:
its bytes go through a 16-bit integer view into ``torch.bfloat16`` both ways.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Union

import numpy as np
import torch

_IDS = {torch.float32: 0, torch.float16: 1, torch.int32: 2, torch.int64: 3, torch.uint8: 4,
        torch.bfloat16: 5}
_DTYPE_BY_ID = {i: dt for dt, i in _IDS.items()}
_MAX_DIMS = 8

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "tensor_cache.cc"
LIBRARY = _ROOT / "lkgd_torch" / "_build" / "libtensor_cache.so"

_lib = None
_lib_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The shared library, built from ``native/tensor_cache.cc`` into ``lkgd_torch/_build/``
    when missing or older than its source, then loaded once."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
            LIBRARY.parent.mkdir(parents=True, exist_ok=True)
            tmp = LIBRARY.with_suffix(f".{os.getpid()}.so")
            subprocess.check_call(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o",
                                   str(tmp), str(SOURCE)])
            os.replace(tmp, LIBRARY)
        lib = ctypes.CDLL(str(LIBRARY))
        u8p, u64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64)
        lib.lkgd_cache_open.restype = ctypes.c_void_p
        lib.lkgd_cache_open.argtypes = [ctypes.c_char_p]
        lib.lkgd_cache_close.argtypes = [ctypes.c_void_p]
        lib.lkgd_cache_put.restype = ctypes.c_int
        lib.lkgd_cache_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint8,
                                       ctypes.c_uint8, u64p, ctypes.c_void_p, ctypes.c_uint64]
        lib.lkgd_cache_info.restype = ctypes.c_int
        lib.lkgd_cache_info.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u8p, u8p, u64p, u64p]
        lib.lkgd_cache_get.restype = ctypes.c_int
        lib.lkgd_cache_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_uint64]
        lib.lkgd_cache_count.restype = ctypes.c_uint64
        lib.lkgd_cache_count.argtypes = [ctypes.c_void_p]
        lib.lkgd_cache_key.restype = ctypes.c_uint32
        lib.lkgd_cache_key.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
                                       ctypes.c_uint32]
        _lib = lib
        return lib


class TensorCache:
    """One cache file, opened (created if missing) for appending and reading."""

    def __init__(self, path: str):
        self._lib = library()
        self._h = self._lib.lkgd_cache_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open tensor cache at {path}")

    def close(self) -> None:
        if self._h:
            self._lib.lkgd_cache_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def put(self, key: str, value: Union[torch.Tensor, np.ndarray]) -> None:
        """Append ``value`` (a tensor on any device, or a numpy array) under ``key``; a later
        record of the same key wins."""
        x = torch.as_tensor(value).detach().cpu().contiguous()
        dt = _IDS.get(x.dtype)
        if dt is None:
            raise TypeError(f"unsupported dtype {x.dtype}")
        raw = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
        dims = (ctypes.c_uint64 * max(x.dim(), 1))(*x.shape)
        rc = self._lib.lkgd_cache_put(self._h, key.encode(), dt, x.dim(), dims,
                                      raw.ctypes.data_as(ctypes.c_void_p), raw.nbytes)
        if rc != 0:
            raise IOError(f"cache put failed rc={rc}")

    def _info(self, key: str):
        dt, nd = ctypes.c_uint8(), ctypes.c_uint8()
        dims, nbytes = (ctypes.c_uint64 * _MAX_DIMS)(), ctypes.c_uint64()
        found = self._lib.lkgd_cache_info(self._h, key.encode(), ctypes.byref(dt),
                                          ctypes.byref(nd), dims, ctypes.byref(nbytes)) == 0
        return found, dt.value, tuple(dims[i] for i in range(nd.value))

    def __contains__(self, key: str) -> bool:
        return self._info(key)[0]

    def get(self, key: str) -> torch.Tensor:
        found, dt, shape = self._info(key)
        if not found:
            raise KeyError(key)
        dtype = _DTYPE_BY_ID[dt]
        out = torch.empty(shape, dtype=torch.int16 if dtype == torch.bfloat16 else dtype)
        raw = out.numpy()
        rc = self._lib.lkgd_cache_get(self._h, key.encode(), raw.ctypes.data_as(ctypes.c_void_p),
                                      raw.nbytes)
        if rc != 0:
            raise IOError(f"cache get failed rc={rc}")
        return out.view(torch.bfloat16) if dtype == torch.bfloat16 else out

    def __len__(self) -> int:
        return int(self._lib.lkgd_cache_count(self._h))

    def keys(self) -> List[str]:
        out, buf = [], ctypes.create_string_buffer(4096)
        for i in range(len(self)):
            if self._lib.lkgd_cache_key(self._h, i, buf, 4096):
                out.append(buf.value.decode())
        return out


class PrecomputedLatentDataset:
    """Training samples over a ``TensorCache`` of precomputed tensors, the reference's
    cached-latent path (latents and prompt embeddings computed once, trained on many times).

    Keys: ``<sample>/latents``, ``<sample>/prompt_embeds``, optionally
    ``<sample>/image_latents``, ``image_embeddings``, ``cond_latents``,
    ``domain_features`` and ``flow_features``; samples in the order of their names."""

    FIELDS = ("prompt_embeds", "image_latents", "image_embeddings", "cond_latents",
              "domain_features", "flow_features")

    def __init__(self, cache_path: str):
        self.cache = TensorCache(cache_path)
        names = sorted({k.split("/")[0] for k in self.cache.keys()})
        self.samples = [n for n in names if f"{n}/latents" in self.cache]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        name = self.samples[idx]
        out = {"latents": self.cache.get(f"{name}/latents")}
        for field in self.FIELDS:
            key = f"{name}/{field}"
            if key in self.cache:
                out[field] = self.cache.get(key)
        return out
