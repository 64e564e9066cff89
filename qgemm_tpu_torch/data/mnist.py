"""MNIST idx-format dataset: parser, writer, batching (port of
``qgemm_tpu/data/mnist.py``).

The whole dataset stays host numpy (float32 images in [0, 1], int32
labels); a batch goes to the device with one ``torch.as_tensor`` copy.
Images are normalized /255; with ``use_native`` (the default) the parsers
route through the native loader (``data/native.py``) when its library is
built, which gives the same bits. ``MNIST.synthetic`` draws from numpy
exactly as the JAX package does, so both packages make the same bytes.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

IMAGE_MAGIC = 2051
LABEL_MAGIC = 2049


def _read_header(path: str, magic: int, n_dims: int) -> tuple:
    with open(path, "rb") as f:
        head = f.read(4 * (1 + n_dims))
        if len(head) < 4 * (1 + n_dims):
            raise ValueError(f"{path}: truncated idx header")
        words = struct.unpack(f">{1 + n_dims}i", head)
        if words[0] != magic:
            raise ValueError(f"{path}: bad idx magic {words[0]} (expected {magic})")
        return words[1:], f.read()


def load_idx_images(path: str, use_native: bool = True) -> np.ndarray:
    """Parse an idx3-ubyte image file -> float32 [N, rows * cols] in [0, 1]."""
    if use_native:
        from qgemm_tpu_torch.data import native
        if native.available():
            return native.load_idx_images(path)
    (n, rows, cols), payload = _read_header(path, IMAGE_MAGIC, 3)
    total = n * rows * cols
    if len(payload) < total:
        raise ValueError(f"{path}: truncated idx payload")
    buf = np.frombuffer(payload, dtype=np.uint8, count=total)
    return (buf.astype(np.float32) / 255.0).reshape(n, rows * cols)


def load_idx_labels(path: str, use_native: bool = True) -> np.ndarray:
    """Parse an idx1-ubyte label file -> int32 [N]."""
    if use_native:
        from qgemm_tpu_torch.data import native
        if native.available():
            return native.load_idx_labels(path)
    (n,), payload = _read_header(path, LABEL_MAGIC, 1)
    if len(payload) < n:
        raise ValueError(f"{path}: truncated idx payload")
    return np.frombuffer(payload, dtype=np.uint8, count=n).astype(np.int32)


def write_idx_images(path: str, images: np.ndarray) -> None:
    """Write float [N, 784] images in [0, 1] as idx3-ubyte (28 x 28)."""
    n, d = images.shape
    rows = cols = int(round(d ** 0.5))
    if rows * cols != d:
        raise ValueError(f"non-square image dim {d}")
    data = np.clip(np.rint(images * 255.0), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">iiii", IMAGE_MAGIC, n, rows, cols))
        f.write(data.tobytes())


def write_idx_labels(path: str, labels: np.ndarray) -> None:
    """Write int labels [N] as idx1-ubyte."""
    with open(path, "wb") as f:
        f.write(struct.pack(">ii", LABEL_MAGIC, len(labels)))
        f.write(labels.astype(np.uint8).tobytes())


_SPLIT_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


@dataclass
class MNIST:
    """In-memory dataset: ``images`` float32 [N, 784], ``targets`` int32 [N]."""

    images: np.ndarray
    targets: np.ndarray

    @classmethod
    def load(cls, data_dir: str, split: str = "train") -> "MNIST":
        img_name, lbl_name = _SPLIT_FILES[split]
        img_path = os.path.join(data_dir, img_name)
        lbl_path = os.path.join(data_dir, lbl_name)
        if not os.path.exists(img_path):
            raise FileNotFoundError(img_path)
        images = load_idx_images(img_path)
        targets = load_idx_labels(lbl_path)
        if len(images) != len(targets):
            raise ValueError(f"{data_dir}: {len(images)} images, {len(targets)} labels")
        return cls(images=images, targets=targets)

    @classmethod
    def synthetic(cls, n: int, seed: int = 0, n_classes: int = 10,
                  noise: float = 0.3) -> "MNIST":
        """A learnable stand-in for MNIST: each class a fixed random template
        (drawn from a constant seed, so train and test splits of different
        seeds share the classes) plus Gaussian ``noise``. 0.3 is nearly
        separable; the oracle protocol (scripts/mnist_oracle.py) uses 2.0,
        which puts the 784-16-10 MLP near 90 % test accuracy."""
        templates = np.random.default_rng(2051).uniform(
            0, 1, size=(n_classes, 784)).astype(np.float32)
        rng = np.random.default_rng(seed)
        targets = rng.integers(0, n_classes, size=(n,)).astype(np.int32)
        eps = rng.normal(0, noise, size=(n, 784)).astype(np.float32)
        images = np.clip(templates[targets] + eps, 0, 1)
        return cls(images=images, targets=targets)

    def __len__(self) -> int:
        return len(self.images)

    def order(self, seed: Optional[int] = None) -> np.ndarray:
        """The sample order of ``batches``: in order without ``seed``; with
        it, the native splitmix64 shuffle when its library is built, else
        ``np.random.default_rng(seed).permutation`` (the JAX package's
        rule)."""
        n = len(self)
        if seed is None:
            return np.arange(n)
        from qgemm_tpu_torch.data import native
        if native.available():
            return native.shuffle_indices(n, seed=seed)
        return np.random.default_rng(seed).permutation(n)

    def batches(self, batch_size: int,
                seed: Optional[int] = None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(images, labels) batches of ``batch_size`` in ``order(seed)``,
        the ragged tail dropped."""
        n = len(self)
        order = self.order(seed)
        for lo in range(0, n - batch_size + 1, batch_size):
            idx = order[lo:lo + batch_size]
            yield self.images[idx], self.targets[idx]
