"""LM data pipeline: mmap token cache + fault-tolerant resumable sampling.

Port of flash_attn_tpu/training/data.py ``TokenDataset`` (:27),
``FaultTolerantSampler`` (:57) and ``LMDataLoader`` (:98), which are numpy
and carry over as they are: the same file, seed and state give the same
batches as the JAX package. The sampler's state_dict is (seed, epoch,
counter), so a resumed run continues exactly where it stopped. The image
loaders wait for the ViT model (ROADMAP.md queue A, item 6).

The batch gather uses the native C++ loader (csrc/dataloader.cpp, threaded
mmap gather) when it builds, falling back to numpy. Token files are flat
binaries of uint16/uint32 token ids.
"""

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from flash_attn_tpu_torch.csrc import native_loader

__all__ = ["TokenDataset", "FaultTolerantSampler", "LMDataLoader"]


class TokenDataset:
    """Memory-mapped flat token file."""

    def __init__(self, path: str, dtype=np.uint16, seqlen: int = 1024):
        self.path = path
        self.dtype = np.dtype(dtype)
        self.seqlen = seqlen
        size = os.path.getsize(path) // self.dtype.itemsize
        self.tokens = np.memmap(path, dtype=self.dtype, mode="r", shape=(size,))
        # +1 token for the shifted label
        self.num_samples = (size - 1) // seqlen
        self._native = native_loader.open_token_file(
            path, self.dtype.itemsize)

    def __len__(self):
        return self.num_samples

    def batch(self, indices: np.ndarray) -> np.ndarray:
        """Gather (len(indices), seqlen+1) token windows."""
        starts = indices.astype(np.int64) * self.seqlen
        if self._native is not None:
            return native_loader.fill_batch(
                self._native, starts, self.seqlen + 1, self.dtype)
        out = np.empty((len(starts), self.seqlen + 1), self.dtype)
        for i, s in enumerate(starts):
            out[i] = self.tokens[s:s + self.seqlen + 1]
        return out


@dataclasses.dataclass
class FaultTolerantSampler:
    """Random permutation sampler whose full state is (seed, epoch, counter)
    — checkpointable and exactly resumable (reference
    fault_tolerant_sampler.py:9)."""
    num_samples: int
    seed: int = 0
    epoch: int = 0
    counter: int = 0
    shuffle: bool = True

    def state_dict(self):
        return {"seed": self.seed, "epoch": self.epoch,
                "counter": self.counter}

    def load_state_dict(self, state):
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        self.counter = int(state["counter"])

    def _perm(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.num_samples)
        rng = np.random.default_rng(self.seed + self.epoch * 1_000_003)
        return rng.permutation(self.num_samples)

    def next_indices(self, n: int) -> np.ndarray:
        """Next n sample indices, rolling over epochs."""
        out = []
        perm = self._perm()
        while n > 0:
            take = min(n, self.num_samples - self.counter)
            out.append(perm[self.counter:self.counter + take])
            self.counter += take
            n -= take
            if self.counter >= self.num_samples:
                self.epoch += 1
                self.counter = 0
                perm = self._perm()
        return np.concatenate(out)


class LMDataLoader:
    """Batches of (input_ids, labels) with resumable state."""

    def __init__(self, dataset: TokenDataset, batch_size: int,
                 sampler: Optional[FaultTolerantSampler] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or FaultTolerantSampler(len(dataset))

    def state_dict(self):
        return self.sampler.state_dict()

    def load_state_dict(self, state):
        self.sampler.load_state_dict(state)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            idx = self.sampler.next_indices(self.batch_size)
            chunk = self.dataset.batch(idx).astype(np.int32)
            yield chunk[:, :-1], chunk[:, 1:]

