"""Packed record dataset: ImageFolder contents in a few large shard files
(counterpart of the JAX package's data/packed.py: the reader side; packing
waits for the port of cli/pack.py).

Production ImageNet-scale training pays a real IO tax for the ImageFolder
layout the reference uses (train_vit_sgd.py:48-56): ~1.3M tiny files mean
one open()+read()+close() per image per epoch, plus directory metadata
pressure — the reason its SLURM launcher rsyncs the whole tree onto local
SSD first (run_vit_sgd_training.slurm). The packed format keeps the SAME
encoded JPEG/PNG bytes but concatenates them into a handful of large shards
with a sidecar index:

    out_dir/
      meta.json      {"format": "fipack", "version": 1, "num_samples": N,
                      "classes": [...], "shards": ["pack-00000.bin", ...]}
      index.npz      shard uint32[N], offset uint64[N], length uint64[N],
                     labels int32[N]   (record i = shards[shard[i]]
                                        [offset[i] : offset[i]+length[i]])
      pack-*.bin     concatenated encoded images, `shard_mb` each

Shards are mmapped once; a record read is a pointer offset (the page cache
does the rest). Sample order, labels, shuffle permutation, and the
per-(seed, epoch, index) augmentation seeds are IDENTICAL to
ImageFolderLoader's, so a packed run reproduces an ImageFolder run
bit-exactly (PIL decodes the same bytes). The native decode path is not
ported yet and is refused by name.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .imagenet import ImageFolderLoader, _load_train_bytes, _load_val_bytes

META_NAME = "meta.json"
INDEX_NAME = "index.npz"


def is_packed(root: str) -> bool:
    """True when `root` is a packed-dataset directory (cheap probe used by
    make_loader to route ImageFolder paths vs packed paths)."""
    p = os.path.join(root, META_NAME)
    if not os.path.isfile(p):
        return False
    try:
        with open(p) as f:
            return json.load(f).get("format") == "fipack"
    except (OSError, ValueError):
        return False


class PackedDataset:
    """mmapped random access to a packed directory's encoded records."""

    def __init__(self, root: str):
        with open(os.path.join(root, META_NAME)) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != "fipack":
            raise ValueError(f"{root} is not a packed (fipack) dataset")
        idx = np.load(os.path.join(root, INDEX_NAME))
        self.shard = idx["shard"]
        self.offset = idx["offset"]
        self.length = idx["length"]
        self.labels = idx["labels"].astype(np.int32)
        self.classes = list(self.meta["classes"])
        self._maps = [np.memmap(os.path.join(root, s), np.uint8, mode="r")
                      for s in self.meta["shards"]]
        if len(self.labels) != self.meta["num_samples"]:
            raise ValueError("index/meta disagree on num_samples")

    def __len__(self):
        return len(self.labels)

    def record(self, i: int) -> np.ndarray:
        """Encoded bytes of sample i as a zero-copy uint8 view."""
        o = int(self.offset[i])
        return self._maps[int(self.shard[i])][o:o + int(self.length[i])]


class PackedLoader(ImageFolderLoader):
    """ImageFolderLoader over a packed directory: identical batching,
    sharding, shuffle, seeds, labels and echo semantics — only the byte
    source changes (mmapped records instead of per-image file opens).

    PIL decodes the same encoded bytes it would read from disk, so batches
    are BIT-IDENTICAL to ImageFolderLoader's over the original tree."""

    def __init__(self, root: str, batch_size: int, *, train: bool,
                 seed: int = 0, size: int = 224, workers: int = 16,
                 prefetch: int = 4, drop_last: bool = False,
                 label_table: np.ndarray | None = None,
                 use_native: bool = False,
                 num_shards: int = 1, shard_id: int = 0, echo: int = 1):
        self.ds = PackedDataset(root)
        # self.paths exists only for the base class's len()/order math; the
        # packed byte source never touches the filesystem per image
        self.paths = list(range(len(self.ds)))
        self.labels = self.ds.labels
        self.classes = self.ds.classes
        self._init_common(batch_size, train=train, seed=seed, size=size,
                          workers=workers, prefetch=prefetch,
                          drop_last=drop_last, label_table=label_table,
                          use_native=use_native, num_shards=num_shards,
                          shard_id=shard_id, echo=echo)

    def _batch_iter(self, order, end: int, epoch: int):
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(self.workers) as ex:
            for s in range(0, end, self.batch_size):
                idx = order[s:s + self.batch_size]
                if self.train:
                    futs = [ex.submit(_load_train_bytes,
                                      self.ds.record(int(i)),
                                      (self.seed, epoch, int(i)), self.size)
                            for i in idx]
                else:
                    futs = [ex.submit(_load_val_bytes, self.ds.record(int(i)),
                                      self.size) for i in idx]
                yield np.stack([f.result() for f in futs]), \
                    self._label_batch(idx)

    def _label_batch(self, idx) -> np.ndarray:
        return np.asarray([self._label(int(i)) for i in idx], np.int32)


def make_loader(root: str, batch_size: int, **kw):
    """Route to PackedLoader when `root` is a packed directory, else the
    plain ImageFolderLoader — training code stays source-agnostic (the
    vit_train CLI accepts either layout for --data_path)."""
    cls = PackedLoader if is_packed(root) else ImageFolderLoader
    return cls(root, batch_size, **kw)
