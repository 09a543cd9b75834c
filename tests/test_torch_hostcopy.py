"""core/hostcopy.py, the asynchronous copy-out of the checkpoint trees: it
changes no value, no dtype and no tree structure, passes leaves that are not
tensors through, and the CLIP-HBA and ViT-B/16 loops write the same
checkpoint bytes with `host_prefetch` on as with it off. The pinned
path on the card is tested in tests/test_torch_cuda.py."""
import collections
import dataclasses
import os

import numpy as np
import pytest
import torch

from vit_project_torch.ckpt import clip_ckpt as tckpt
from vit_project_torch.ckpt import serialization as tser
from vit_project_torch.core import hostcopy
from vit_project_torch.core.configs import ViTTrainConfig
from vit_project_torch.models import vit as tvit
from vit_project_torch.train import clip_loop as tloop
from vit_project_torch.train import vit_loop as tvloop


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.float16, torch.int64, torch.int32,
                                   torch.uint8, torch.bool])
def test_values_and_dtypes_are_unchanged(dtype):
    x = (torch.arange(24).reshape(2, 3, 4) % 5).to(dtype)
    (got,) = hostcopy.prefetch_to_host(x)
    arr = got.get()
    assert isinstance(arr, np.ndarray) and arr.shape == (2, 3, 4)
    assert arr.dtype == x.numpy().dtype
    np.testing.assert_array_equal(arr, x.numpy())
    x.zero_()   # the host array is a copy, not a view of the tensor
    assert np.array_equal(arr, (np.arange(24).reshape(2, 3, 4) % 5)
                          .astype(arr.dtype))


def test_mixed_leaves_keep_their_tree():
    """Dicts, lists, tuples and named tuples keep their types; numpy
    arrays, numbers, strings and None pass through as they are; a tensor
    that requires grad comes out detached."""
    Pair = collections.namedtuple("Pair", "a b")
    np_leaf = np.ones(3, np.float32)
    w = torch.randn(4, 2, requires_grad=True)
    tree = {"w": w, "np": np_leaf, "n": 1.5, "s": "x", "none": None,
            "list": [torch.tensor([1, 2]), 3],
            "pair": Pair(torch.zeros(2, dtype=torch.float16), ())}
    a, b = hostcopy.prefetch_to_host(tree, [w * 2])
    got = a.get()
    assert got.keys() == tree.keys()
    np.testing.assert_array_equal(got["w"], w.detach().numpy())
    assert got["np"] is np_leaf and got["n"] == 1.5 and got["s"] == "x"
    assert got["none"] is None
    assert isinstance(got["list"], list) and got["list"][1] == 3
    np.testing.assert_array_equal(got["list"][0], [1, 2])
    assert type(got["pair"]) is Pair and got["pair"].b == ()
    assert got["pair"].a.dtype == np.float16
    np.testing.assert_array_equal(b.get()[0], (w * 2).detach().numpy())


def test_moments_give_the_optax_state_of_the_solo_writer():
    """The AdamW moments copied out and rebuilt equal
    optax_state_from_adamw's state, leaf for leaf and in count."""
    tr = {"visual": {1: {"m": torch.randn(4), "delta_D_A": torch.randn(2, 4),
                         "delta_D_B": torch.randn(3, 2)}}, "text": {}}
    tr = {t: {i: {k: v.requires_grad_(True) for k, v in d.items()}
              for i, d in b.items()} for t, b in tr.items()}
    opt = tloop.make_optimizer(
        [leaf for *_, leaf in tloop.adora.trainable_leaves(tr)], 1e-2)
    for _ in range(2):
        sum((leaf ** 2).sum() for *_, leaf in
            tloop.adora.trainable_leaves(tr)).backward()
        opt.step()
    (copy,) = hostcopy.prefetch_to_host(tckpt.adamw_moments(opt, tr))
    got = tckpt.optax_state_from_moments(*copy.get())
    want = tckpt.optax_state_from_adamw(opt, tr)
    assert int(got[0].count) == int(want[0].count) == 2
    for part in ("mu", "nu"):
        g, w = getattr(got[0], part), getattr(want[0], part)
        assert g.keys() == w.keys() and g["text"] == w["text"] == {}
        for k in w["visual"][1]:
            np.testing.assert_array_equal(g["visual"][1][k],
                                          w["visual"][1][k])


# -- the loops, with and without the copy-out ---------------------------------

@pytest.fixture(scope="module")
def things(tmp_path_factory):
    """Synthetic THINGS (40 train images, 48 inference, an RDM .mat)."""
    from PIL import Image
    import pandas as pd
    import scipy.io
    root = tmp_path_factory.mktemp("things")
    os.makedirs(root / "images")
    rs = np.random.RandomState(0)
    names = [f"t{i:03d}.png" for i in range(48)]
    for n in names:
        Image.fromarray(rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)) \
            .save(root / "images" / n)
    for path, rows in ((root / "train.csv", names[:40]),
                       (root / "val.csv", names)):
        df = pd.DataFrame({"image_name": rows})
        for j in range(66):
            df[f"d{j}"] = (rs.rand(len(rows)) * 2).astype(np.float32)
        df.to_csv(path)
    rdm = rs.rand(48, 48)
    scipy.io.savemat(root / "rdm.mat",
                     {"RDM48_triplet": (rdm + rdm.T) / 2})
    return root


def _files(out):
    return {os.path.relpath(os.path.join(d, n), out):
            open(os.path.join(d, n), "rb").read()
            for d, _, names in os.walk(out) for n in names
            if n.endswith(".pth") or n.endswith(".csv")}


def test_clip_loop_writes_the_same_bytes_with_the_copy_out(things, tmp_path):
    """A 2-epoch test-tiny run, dropout on: every checkpoint and the CSV
    are the same bytes with host_prefetch on and off."""
    trees = {}
    for prefetch in (False, True):
        out = str(tmp_path / str(prefetch))
        tloop.run_behavioral_training({
            "csv_file": str(things / "train.csv"),
            "img_dir": str(things / "images"),
            "inference_csv_file": str(things / "val.csv"),
            "RDM48_triplet_dir": str(things / "rdm.mat"),
            "backbone": "test-tiny", "epochs": 2, "batch_size": 16,
            "train_portion": 0.8, "lr": 3e-4, "logger": None,
            "checkpoint_path": os.path.join(out, "m.ckpt"),
            "training_res_path": os.path.join(out, "res.csv"),
            "dora_parameters_path": os.path.join(out, "dora_params"),
            "random_state_path": os.path.join(out, "random_states"),
            "random_seed": 1, "rank": 4, "perturb_type": "baseline",
            "perturb_length": 0, "training_run": 0,
            "compute_dtype": "float32", "host_prefetch": prefetch},
            device="cpu")
        trees[prefetch] = _files(out)
    assert len(trees[True]) == 6   # 2 x DoRA, 2 x states, split, CSV
    assert trees[True] == trees[False]
    state = tser.load(os.path.join(tmp_path, "True", "random_states",
                                   "epoch2_random_states.pth"))
    assert int(state["optimizer_state"][0].count) == 4


def test_vit_loop_writes_the_same_bytes_with_the_copy_out(tmp_path):
    """Two ViT epochs on a tiny ImageFolder: the epoch checkpoints are the
    same bytes with host_prefetch on and off (the flag was refused before
    the copy-out was ported)."""
    from PIL import Image
    data = tmp_path / "data"
    rs = np.random.RandomState(0)
    for split, n in (("train", 8), ("val", 4)):
        for cls in ("a", "b"):
            os.makedirs(data / split / cls)
            for i in range(n):
                Image.fromarray(rs.randint(0, 255, (40, 40, 3),
                                           dtype=np.uint8)).save(
                    data / split / cls / f"{i}.png")
    cfg = tvit.ViTConfig(patch=8, width=32, layers=2, heads=2, image_size=32,
                         num_classes=2)
    files = {}
    for prefetch in (False, True):
        out = str(tmp_path / str(prefetch))
        tvloop.run_vit_training(dataclasses.replace(ViTTrainConfig(
            data_path=str(data), output_dir=out, batch_size=4, epochs=2,
            lr=0.01, warmup_epochs=1, num_workers=1, num_classes=2,
            image_size=32, compute_dtype="float32", random_seed=0),
            host_prefetch=prefetch), vit_cfg=cfg, device="cpu")
        files[prefetch] = _files(out)
    assert "checkpoint_epoch_001.pth" in files[True]
    assert files[True] == files[False]
