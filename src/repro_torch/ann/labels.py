"""Packed label bitmaps.

One row of ``ceil(|U|/32)`` uint32 words per vector. On the host the
words are numpy uint32; on a torch device they are carried as
`torch.int32` views of the same bits (`bitmap_tensor`), because torch's
uint32 has no shifts on the CPU. Kernels read them back as `uint32_t`.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch


def n_words(universe: int) -> int:
    """Number of uint32 words needed for a universe of `universe` labels."""
    return max(1, (int(universe) + 31) // 32)


def pack_one(labels: Iterable[int], universe: int) -> np.ndarray:
    """Pack one label set into a `[W]` uint32 bitmap."""
    words = np.zeros(n_words(universe), dtype=np.uint32)
    for l in labels:
        if not 0 <= l < universe:
            raise ValueError(f"label {l} outside universe [0,{universe})")
        words[l >> 5] |= np.uint32(1) << np.uint32(l & 31)
    return words


def pack_label_sets(label_sets: Sequence[Iterable[int]], universe: int) -> np.ndarray:
    """Pack `N` label sets into a `[N, W]` uint32 bitmap matrix."""
    out = np.zeros((len(label_sets), n_words(universe)), dtype=np.uint32)
    for i, ls in enumerate(label_sets):
        for l in ls:
            out[i, l >> 5] |= np.uint32(1) << np.uint32(l & 31)
    return out


def unpack_one(bitmap: np.ndarray) -> frozenset[int]:
    """Inverse of `pack_one` (host-side utility)."""
    labels = []
    for w, word in enumerate(np.asarray(bitmap, dtype=np.uint32)):
        word = int(word)
        b = 0
        while word:
            if word & 1:
                labels.append((w << 5) + b)
            word >>= 1
            b += 1
    return frozenset(labels)


def bitmap_key(bitmap: np.ndarray) -> bytes:
    """Hashable host-side key for a bitmap (group / pattern lookup)."""
    return np.ascontiguousarray(bitmap, dtype=np.uint32).tobytes()


def bitmap_tensor(bitmaps: np.ndarray, device) -> torch.Tensor:
    """Host uint32 bitmaps -> `torch.int32` tensor of the same bits on
    `device`."""
    words = np.ascontiguousarray(bitmaps, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(device)


def bitmap_numpy(bitmaps: torch.Tensor) -> np.ndarray:
    """Inverse of `bitmap_tensor`: int32 tensor -> host uint32 words."""
    return bitmaps.cpu().numpy().view(np.uint32)


def popcount(bitmaps: torch.Tensor) -> torch.Tensor:
    """Total set-bit count along the last (word) axis -> int32."""
    x = bitmaps.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum(dim=-1).to(torch.int32)
