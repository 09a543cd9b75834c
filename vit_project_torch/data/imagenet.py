"""ImageNet-style ImageFolder pipeline (counterpart of the JAX package's
data/imagenet.py).

Reference contract (get_dataloaders, train_vit_sgd.py:29-90): ImageFolder train/val
with RandomResizedCrop(224)+HFlip train augs, Resize(256)+CenterCrop(224) val,
ImageNet normalization.

A thread-pool loader decodes + augments into uint8 host batches while the card
trains (the normalization is folded into the patch embedding of the step).
Augmentations are derived from numpy Generators seeded per (seed, epoch, index), so
the stream is exactly replayable from a checkpointed seed, and the batches equal
the JAX package's byte for byte. ``use_native=True`` decodes through the C++
core instead (``data/fastimage.py``).
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core.configs import IMAGENET_MEAN, IMAGENET_STD


IMG_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp")


def scan_image_folder(root: str):
    """torchvision ImageFolder semantics: classes = sorted dir names ->
    contiguous ids; returns (paths, labels, class_names)."""
    classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
    class_to_idx = {c: i for i, c in enumerate(classes)}
    paths, labels = [], []
    for c in classes:
        cdir = os.path.join(root, c)
        for dirpath, _, filenames in sorted(os.walk(cdir)):
            for fn in sorted(filenames):
                if fn.lower().endswith(IMG_EXTS):
                    paths.append(os.path.join(dirpath, fn))
                    labels.append(class_to_idx[c])
    return paths, np.asarray(labels, np.int32), classes


def random_resized_crop_flip(img, rng: np.random.Generator, size: int = 224,
                             scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """PIL RandomResizedCrop + RandomHorizontalFlip with torchvision's sampling
    procedure (10 area/ratio attempts then center-crop fallback)."""
    from PIL import Image
    W, H = img.size
    area = W * H
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            i = int(rng.integers(0, H - h + 1))
            j = int(rng.integers(0, W - w + 1))
            img = img.crop((j, i, j + w, i + h))
            break
    else:
        in_ratio = W / H
        if in_ratio < ratio[0]:
            w, h = W, int(round(W / ratio[0]))
        elif in_ratio > ratio[1]:
            w, h = int(round(H * ratio[1])), H
        else:
            w, h = W, H
        i, j = (H - h) // 2, (W - w) // 2
        img = img.crop((j, i, j + w, i + h))
    img = img.resize((size, size), Image.BILINEAR)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def resize_center_crop(img, size: int = 224, resize_to: int = 256):
    from PIL import Image
    if size > resize_to:
        # PIL zero-pads out-of-bounds crops, so a crop bigger than the
        # resized short side would silently produce black borders — scale
        # the resize with the crop (torchvision's 256/224 ratio)
        resize_to = int(round(size * 256 / 224))
    W, H = img.size
    if W < H:
        nw, nh = resize_to, int(resize_to * H / W)
    else:
        nw, nh = int(resize_to * W / H), resize_to
    img = img.resize((nw, nh), Image.BILINEAR)
    left, top = (nw - size) // 2, (nh - size) // 2
    return img.crop((left, top, left + size, top + size))


def _load_train(path: str, seed_tuple, size: int) -> np.ndarray:
    from PIL import Image
    rng = np.random.Generator(np.random.PCG64(list(seed_tuple)))
    img = Image.open(path).convert("RGB")
    img = random_resized_crop_flip(img, rng, size)
    return np.asarray(img, np.uint8)


def _load_val(path: str, size: int) -> np.ndarray:
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(resize_center_crop(img, size), np.uint8)


def _load_train_bytes(data, seed_tuple, size: int) -> np.ndarray:
    """_load_train over in-memory encoded bytes (the packed-dataset PIL
    path, data/packed.py) — same PIL calls, so pixels are bit-identical to
    decoding the original file."""
    import io
    from PIL import Image
    rng = np.random.Generator(np.random.PCG64(list(seed_tuple)))
    img = Image.open(io.BytesIO(bytes(data))).convert("RGB")
    img = random_resized_crop_flip(img, rng, size)
    return np.asarray(img, np.uint8)


def _load_val_bytes(data, size: int) -> np.ndarray:
    import io
    from PIL import Image
    img = Image.open(io.BytesIO(bytes(data))).convert("RGB")
    return np.asarray(resize_center_crop(img, size), np.uint8)


class ImageFolderLoader:
    """Deterministic, prefetching ImageFolder loader.

    train=True: per-epoch shuffle from PCG64([seed, epoch]) + per-sample augs from
    PCG64([seed, epoch, dataset_index]); train=False: dataset order, center crop.
    Yields (images_u8 [B,H,W,3], labels [B]) host batches, `prefetch` batches
    ahead, decoding with `workers` threads.
    """

    def __init__(self, root: str, batch_size: int, *, train: bool,
                 seed: int = 0, size: int = 224, workers: int = 16,
                 prefetch: int = 4, drop_last: bool = False,
                 label_table: np.ndarray | None = None,
                 use_native: bool = False,
                 num_shards: int = 1, shard_id: int = 0,
                 echo: int = 1):
        self.paths, self.labels, self.classes = scan_image_folder(root)
        self._init_common(batch_size, train=train, seed=seed, size=size,
                          workers=workers, prefetch=prefetch,
                          drop_last=drop_last, label_table=label_table,
                          use_native=use_native, num_shards=num_shards,
                          shard_id=shard_id, echo=echo)

    def _init_common(self, batch_size: int, *, train: bool, seed: int,
                     size: int, workers: int, prefetch: int,
                     drop_last: bool, label_table, use_native: bool,
                     num_shards: int, shard_id: int, echo: int):
        """Construction shared with the packed-dataset loader
        (data/packed.py PackedLoader) — ONE home for the batching/sharding
        invariants so the 'identical semantics' contract cannot drift."""
        self.batch_size = batch_size
        # Multi-host sharding with reference DistributedSampler semantics
        # (train_vit_sgd.py:58-66): every shard sees the same seeded global
        # permutation, takes indices shard_id::num_shards after wrap-padding
        # the order to a multiple of num_shards, so shards are disjoint (up
        # to the <num_shards wrapped samples) and equally sized.
        # batch_size is the PER-SHARD (per-host) batch.
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} outside [0, {num_shards})")
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.train = train
        self.seed = seed
        self.size = size
        self.workers = workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        # label_table: index-table label perturbation (ShuffledLabelsDataset /
        # TargetNoiseDataset semantics — measure...effect.py:57-93)
        self.label_table = label_table
        # use_native: decode+augment through the C++ core (native/fastimage.cpp)
        # instead of PIL. Same (seed, epoch, index) determinism contract, but a
        # different filter implementation: a run must not mix decoders.
        if use_native:
            self._check_native()
        self.use_native = use_native
        # data echo: yield each decoded batch `echo` times, the standard
        # mitigation when host decode cannot feed the device step rate
        # (the step consumes echo x the decode throughput; gradient noise
        # increases but convergence is robust at small factors)
        if echo < 1:
            raise ValueError(f"data echo must be >= 1, got {echo}")
        self.echo = echo

    def _check_native(self):
        """Fail at construction, not at the first batch after the model is
        built. Subclasses with extra native requirements override."""
        from . import fastimage
        if not fastimage.available():
            raise RuntimeError("use_native=True but libfastimage.so does not "
                               "load (build it: make -C native)")

    def _native_args(self, epoch: int, idx):
        """(mode, resize_to, per-image seeds) of a native batch."""
        from . import fastimage as fim
        mode = fim.MODE_RRC_FLIP if self.train else fim.MODE_CENTER_CROP
        # val center crop: scale the shorter-side resize with the crop like
        # resize_center_crop (256 would black-pad a crop above 256)
        resize_to = (256 if self.size <= 256
                     else int(round(self.size * 256 / 224)))
        seeds = [hash((self.seed, epoch, int(i))) & 0xFFFFFFFFFFFFFFFF
                 for i in idx]
        return mode, resize_to, seeds

    def _shard_len(self):
        n = len(self.paths)
        if self.num_shards == 1:
            return n
        return (n + self.num_shards - 1) // self.num_shards

    def __len__(self):
        n = self._shard_len()
        nb = n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size
        return nb * self.echo

    def num_samples(self):
        return len(self.paths)

    def _label(self, i: int):
        if self.label_table is not None:
            return self.label_table[i]
        return self.labels[i]

    def epoch(self, epoch: int = 0):
        n = len(self.paths)
        if self.train:
            rng = np.random.Generator(np.random.PCG64([self.seed, epoch]))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.num_shards > 1:
            total = self._shard_len() * self.num_shards
            if total > n:  # wrap-pad like torch DistributedSampler
                order = np.concatenate([order, order[:total - n]])
            order = order[self.shard_id::self.num_shards]
            n = len(order)
        end = n - n % self.batch_size if self.drop_last else n
        # decode runs on a feeder thread so it overlaps training; failures
        # re-raise here and an abandoned epoch cannot leak the thread
        # (core/feeder.py holds the shared discipline)
        from ..core.feeder import feed
        for item in feed(self._batch_iter(order, end, epoch), self.prefetch):
            for _ in range(self.echo):
                yield item

    def _batch_iter(self, order, end: int, epoch: int):
        """Decode one epoch's batches in order (runs on the feeder thread)."""
        if self.use_native:
            from . import fastimage as fim
            for s in range(0, end, self.batch_size):
                idx = order[s:s + self.batch_size]
                mode, resize_to, seeds = self._native_args(epoch, idx)
                try:
                    imgs = fim.transform_batch(
                        [self.paths[i] for i in idx], mode, self.size,
                        self.size, seeds, resize_to=resize_to,
                        threads=self.workers)
                except IOError:
                    # the C++ core decodes baseline JPEG/PNG only; ImageNet
                    # holds a few CMYK JPEGs that PIL reads: this batch
                    # decodes with PIL (the pixels the PIL path gives)
                    if self.train:
                        imgs = np.stack([
                            _load_train(self.paths[i],
                                        (self.seed, epoch, int(i)),
                                        self.size) for i in idx])
                    else:
                        imgs = np.stack([_load_val(self.paths[i], self.size)
                                         for i in idx])
                lbls = np.asarray([self._label(int(i)) for i in idx],
                                  np.int32)
                yield imgs, lbls
            return
        with ThreadPoolExecutor(self.workers) as ex:
            for s in range(0, end, self.batch_size):
                idx = order[s:s + self.batch_size]
                if self.train:
                    futs = [ex.submit(_load_train, self.paths[i],
                                      (self.seed, epoch, int(i)), self.size)
                            for i in idx]
                else:
                    futs = [ex.submit(_load_val, self.paths[i], self.size)
                            for i in idx]
                imgs = np.stack([f.result() for f in futs])
                lbls = np.asarray([self._label(int(i)) for i in idx],
                                  np.int32)
                yield imgs, lbls


def normalize_imagenet(images_u8, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                       dtype=None):
    """(x / 255 - mean) / std over the last axis of a uint8 [..., 3] tensor,
    in float32 (or `dtype`)."""
    import torch
    x = torch.as_tensor(images_u8).to(torch.float32) / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    x = (x - m) / s
    return x if dtype is None else x.to(dtype)
