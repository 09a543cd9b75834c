"""Packed record dataset: ImageFolder contents in a few large shard files
(counterpart of the JAX package's data/packed.py; ``cli/pack.py`` writes it).

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
does the rest), and the native decode path consumes the bytes in place
(fastimage.transform_mem_batch -> fi_transform_mem_batch) with no
per-image syscall. Sample order, labels, shuffle permutation, and the
per-(seed, epoch, index) augmentation seeds are IDENTICAL to
ImageFolderLoader's, so a packed run reproduces an ImageFolder run
bit-exactly on the PIL path (PIL decodes the same bytes) and decoder-exactly
on the native path.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .imagenet import (ImageFolderLoader, _load_train_bytes, _load_val_bytes,
                       scan_image_folder)

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


def pack_image_folder(root: str, out_dir: str, *,
                      shard_mb: int = 512, logger=None) -> dict:
    """Pack an ImageFolder tree into shards + index under `out_dir`.

    Keeps scan_image_folder's deterministic sample order (sorted classes ->
    contiguous ids, sorted files), so loaders over the packed copy see the
    SAME (index -> image, label) mapping as over the original tree."""
    log = logger.info if logger else print
    paths, labels, classes = scan_image_folder(root)
    os.makedirs(out_dir, exist_ok=True)
    shard_bytes = shard_mb * (1 << 20)
    shards: list[str] = []
    shard_ids = np.empty(len(paths), np.uint32)
    offsets = np.empty(len(paths), np.uint64)
    lengths = np.empty(len(paths), np.uint64)
    cur = None
    cur_off = 0
    try:
        for i, p in enumerate(paths):
            with open(p, "rb") as f:
                blob = f.read()
            if cur is None or (cur_off and cur_off + len(blob) > shard_bytes):
                if cur is not None:
                    cur.close()
                name = f"pack-{len(shards):05d}.bin"
                # plain open (not atomic temps): the writer is an offline
                # one-shot tool; a partial pack fails loudly at meta.json
                # load (written LAST, below) rather than half-working
                cur = open(os.path.join(out_dir, name), "wb")
                shards.append(name)
                cur_off = 0
            shard_ids[i] = len(shards) - 1
            offsets[i] = cur_off
            lengths[i] = len(blob)
            cur.write(blob)
            cur_off += len(blob)
    finally:
        if cur is not None:
            cur.close()
    np.savez(os.path.join(out_dir, INDEX_NAME), shard=shard_ids,
             offset=offsets, length=lengths, labels=labels)
    meta = {"format": "fipack", "version": 1, "num_samples": len(paths),
            "classes": classes, "shards": shards}
    tmp = os.path.join(out_dir, f"{META_NAME}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(out_dir, META_NAME))
    total = int(lengths.sum())
    log(f"packed {len(paths)} images ({total / 1e6:.1f} MB) into "
        f"{len(shards)} shard(s) under {out_dir}")
    return meta


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

    The PIL path decodes the same encoded bytes PIL would read from disk,
    so batches are BIT-IDENTICAL to ImageFolderLoader's over the original
    tree; use_native=True routes through fi_transform_mem_batch (the native
    file path's pixels, no per-image syscall)."""

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

    def _check_native(self):
        # the packed path needs the memory-decode API (fi_version >= 2): a
        # stale v1 library fails here, not at the first batch after the
        # model is built
        from . import fastimage
        if not fastimage.mem_available():
            raise RuntimeError(
                "use_native=True over a packed dataset needs the memory-"
                "decode API; rebuild the library (make -C native)")

    def _batch_iter(self, order, end: int, epoch: int):
        from concurrent.futures import ThreadPoolExecutor
        if self.use_native:
            from . import fastimage as fim
            for s in range(0, end, self.batch_size):
                idx = order[s:s + self.batch_size]
                mode, resize_to, seeds = self._native_args(epoch, idx)
                bufs = [self.ds.record(int(i)) for i in idx]
                try:
                    imgs = fim.transform_mem_batch(
                        bufs, mode, self.size, self.size, seeds,
                        resize_to=resize_to, threads=self.workers)
                except IOError:
                    # encodings the core does not read (CMYK JPEG) decode
                    # with PIL for this batch, like the ImageFolder path
                    imgs = self._pil_batch(idx, epoch)
                yield imgs, self._label_batch(idx)
            return
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

    def _pil_batch(self, idx, epoch: int) -> np.ndarray:
        if self.train:
            return np.stack([_load_train_bytes(
                self.ds.record(int(i)), (self.seed, epoch, int(i)),
                self.size) for i in idx])
        return np.stack([_load_val_bytes(self.ds.record(int(i)), self.size)
                         for i in idx])

    def _label_batch(self, idx) -> np.ndarray:
        return np.asarray([self._label(int(i)) for i in idx], np.int32)


def make_loader(root: str, batch_size: int, **kw):
    """Route to PackedLoader when `root` is a packed directory, else the
    plain ImageFolderLoader — training code stays source-agnostic (the
    vit_train / vit_measure CLIs accept either layout for --data_path)."""
    cls = PackedLoader if is_packed(root) else ImageFolderLoader
    return cls(root, batch_size, **kw)
