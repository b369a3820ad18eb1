"""LM data pipeline: mmap token cache + fault-tolerant resumable sampling.

Port of flash_attn_tpu/training/data.py ``TokenDataset`` (:27),
``FaultTolerantSampler`` (:57), ``LMDataLoader`` (:98), ``ImageDataset``
(:120) and ``ImageDataLoader`` (:159), which are numpy and carry over as
they are: the same files, seed and state give the same batches as the JAX
package. The sampler's state_dict is (seed, epoch, counter), so a resumed
run continues exactly where it stopped, its image flips included.

The batch gather uses the native C++ loader (csrc/dataloader.cpp, threaded
mmap gather) when it builds, falling back to numpy. Token files are flat
binaries of uint16/uint32 token ids.
"""

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from flash_attn_tpu_torch.csrc import native_loader

__all__ = ["TokenDataset", "FaultTolerantSampler", "LMDataLoader",
           "ImageDataset", "ImageDataLoader"]


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


class ImageDataset:
    """Memory-mapped image classification data: a (N, H, W, C) uint8 image
    file and an (N,) int32 label file, batch-gathered, normalised with the
    ImageNet mean and standard deviation."""

    MEAN = np.array([0.485, 0.456, 0.406], np.float32)
    STD = np.array([0.229, 0.224, 0.225], np.float32)

    def __init__(self, images_path: str, labels_path: str,
                 image_shape: Tuple[int, int, int], normalize: bool = True):
        self.image_shape = tuple(image_shape)
        per = int(np.prod(image_shape))
        size = os.path.getsize(images_path)
        if size % per:
            raise ValueError(f"{images_path}: {size} bytes is not a whole "
                             f"number of {self.image_shape} images")
        n = size // per
        self.images = np.memmap(images_path, dtype=np.uint8, mode="r",
                                shape=(n,) + self.image_shape)
        self.labels = np.memmap(labels_path, dtype=np.int32, mode="r",
                                shape=(n,))
        self.normalize = normalize
        self.num_samples = n

    def __len__(self):
        return self.num_samples

    def batch(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        imgs = self.images[indices].astype(np.float32) / 255.0
        if self.normalize:
            imgs = (imgs - self.MEAN) / self.STD
        return imgs, self.labels[indices].astype(np.int32)


class ImageDataLoader:
    """Batches of (images (b, H, W, C) fp32, labels (b,) int32) with the LM
    loader's resumable sampler; the optional horizontal flip of each image
    is a hash of (seed, epoch, sample index), so a resumed run flips the
    same images."""

    def __init__(self, dataset: ImageDataset, batch_size: int,
                 sampler: Optional[FaultTolerantSampler] = None,
                 random_flip: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or FaultTolerantSampler(len(dataset))
        self.random_flip = random_flip

    def state_dict(self):
        return self.sampler.state_dict()

    def load_state_dict(self, state):
        self.sampler.load_state_dict(state)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            epoch = self.sampler.epoch
            idx = self.sampler.next_indices(self.batch_size)
            imgs, labels = self.dataset.batch(idx)
            if self.random_flip:
                h = (idx.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
                     + np.uint64(self.sampler.seed * 2654435761
                                 + epoch * 40503))
                flip = ((h >> np.uint64(17)) & np.uint64(1)).astype(bool)
                imgs = np.where(flip[:, None, None, None],
                                imgs[:, :, ::-1], imgs)
            yield imgs, labels
