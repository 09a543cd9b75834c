"""THINGS data pipeline (counterpart of the JAX package's data/things.py).

Reference contract (ThingsDataset / ThingsInferenceDataset,
new_cvpr_train_behavior_things_pipeline.py:180-248): the CSV carries a
leading index column (read with pandas' index_col=0 by the reference and the
JAX package); after it, column 0 is the image filename and the remaining 66
columns are the SPoSE target embedding. Images are resized to 224x224 and
normalized with THINGS statistics.

The port reads the CSV with the standard library's ``csv`` module under the
same meaning (first field of each row is the index and is dropped; an empty
field is NaN). The whole dataset is decoded once into a uint8 host array,
uploaded to the device once, and batches are gathered there by index and
normalized on the device. PIL is imported only inside the decode.
"""
from __future__ import annotations

import csv
import hashlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.configs import THINGS_MEAN, THINGS_STD


def _load_one(img_dir: str, name: str, size: int) -> np.ndarray:
    from PIL import Image
    img = Image.open(os.path.join(img_dir, name)).convert("RGB")
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def decode_images(img_dir: str, names: list[str], size: int = 224,
                  workers: int = 16) -> np.ndarray:
    with ThreadPoolExecutor(workers) as ex:
        arrs = list(ex.map(lambda n: _load_one(img_dir, n, size), names))
    return np.stack(arrs)


def _float(field: str) -> float:
    return float(field) if field.strip() else float("nan")


def read_annotations(csv_file: str) -> tuple[list[str], np.ndarray]:
    """(names, values [N, C-2] float32) of a THINGS CSV with a leading index
    column: pandas.read_csv(csv_file, index_col=0) then iloc[:, 0] and
    iloc[:, 1:]."""
    with open(csv_file, newline="") as f:
        rows = list(csv.reader(f))
    body = [r for r in rows[1:] if r]
    names = [r[1] for r in body]
    values = np.array([[_float(x) for x in r[2:]] for r in body],
                      dtype=np.float64).reshape(len(body), -1)
    return names, values.astype(np.float32)


class ThingsDataset:
    """Train dataset: (names, images_u8 [N,224,224,3], targets [N,66]).

    `cache_file` keeps the decoded images in an ``.npz`` (the suffix is
    added when missing, where np.savez writes) with ``images`` and
    ``names_sha256``, a digest of the exact name sequence: the JAX package's
    format, so a cache written by either package loads in the other. A cache
    made for another image list, order or size is decoded again and
    rewritten."""

    def __init__(self, csv_file: str, img_dir: str, size: int = 224,
                 cache_file: str | None = None):
        self.names, self.targets = read_annotations(csv_file)
        if cache_file and not cache_file.endswith(".npz"):
            cache_file += ".npz"
        digest = hashlib.sha256(
            "\n".join(map(str, self.names)).encode()).hexdigest()
        cached = None
        if cache_file and os.path.exists(cache_file):
            with np.load(cache_file, allow_pickle=False) as z:
                arr = z["images"]
                if ("names_sha256" in z.files
                        and str(z["names_sha256"]) == digest
                        and arr.shape[0] == len(self.names)
                        and arr.shape[1] == size):
                    cached = arr
        if cached is not None:
            self.images_u8 = cached
        else:
            self.images_u8 = decode_images(img_dir, self.names, size)
            if cache_file:
                os.makedirs(os.path.dirname(cache_file) or ".", exist_ok=True)
                np.savez(cache_file, images=self.images_u8,
                         names_sha256=digest)

    def __len__(self):
        return len(self.names)


class ThingsInferenceDataset:
    """The 48 held-out images + path to the human RDM .mat file."""

    def __init__(self, inference_csv_file: str, img_dir: str,
                 RDM48_triplet_dir: str, size: int = 224):
        self.names, _ = read_annotations(inference_csv_file)
        self.images_u8 = decode_images(img_dir, self.names, size)
        self.RDM48_triplet_dir = RDM48_triplet_dir

    def load_reference_rdm(self) -> np.ndarray:
        import scipy.io
        d = scipy.io.loadmat(self.RDM48_triplet_dir)
        return np.asarray(d["RDM48_triplet"], dtype=np.float32)

    def __len__(self):
        return len(self.names)


def normalize_uint8(images_u8: torch.Tensor, mean=THINGS_MEAN,
                    std=THINGS_STD, dtype=None) -> torch.Tensor:
    """uint8 [B,H,W,3] -> normalized float32 (or `dtype`), on the images'
    device."""
    x = images_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    x = (x - m) / s
    return x if dtype is None else x.to(dtype)


# -- split persistence (reference dataset_split_indices.pth contract) --------

def random_split_indices(n: int, train_portion: float, seed: int):
    """Deterministic train/test split (reference uses torch random_split 80/20
    seeded by random_seed, cvpr...baseline.py:731-733)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    perm = rng.permutation(n)
    n_train = int(train_portion * n)
    return perm[:n_train].tolist(), perm[n_train:].tolist()


def save_split_indices(path: str, train_indices, test_indices, seed: int):
    from ..ckpt import serialization as ser
    ser.save(path, {
        "train_indices": list(map(int, train_indices)),
        "test_indices": list(map(int, test_indices)),
        "random_seed": seed,
        "train_size": len(train_indices),
        "test_size": len(test_indices),
    })


def load_split_indices(path: str, logger=None):
    """Load the persisted split (reference load_dataset_split_indices,
    new_cvpr...pipeline.py:137-161). Returns None if missing."""
    from ..ckpt import serialization as ser
    log = logger.info if logger else print
    if not os.path.exists(path):
        log(f"Split indices file not found: {path}")
        return None
    info = ser.load(path)
    log(f"Loaded dataset split indices from: {path}")
    log(f"  Train samples: {len(info['train_indices'])}")
    log(f"  Test samples: {len(info['test_indices'])}")
    log(f"  Random seed used: {info['random_seed']}")
    return info


class EpochShuffler:
    """Replayable per-epoch shuffling: the order is a pure function of
    (data_seed, epoch), permutation = PCG64([data_seed, epoch]), the JAX
    package's exact stream. Saving `data_seed` once reproduces every
    epoch's order (the reference checkpoints its DataLoader generator
    instead, ref :696-728). `drop_last` leaves out the last, partial
    batch."""

    def __init__(self, n: int, batch_size: int, data_seed: int,
                 drop_last: bool = False):
        self.n = n
        self.batch_size = batch_size
        self.data_seed = int(data_seed)
        self.drop_last = drop_last

    def epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.Generator(
            np.random.PCG64([self.data_seed, int(epoch)]))
        return rng.permutation(self.n)

    def batches(self, epoch: int):
        order = self.epoch_order(epoch)
        end = (self.n - self.n % self.batch_size) if self.drop_last else self.n
        for s in range(0, end, self.batch_size):
            yield order[s:s + self.batch_size]

    def num_batches(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size
