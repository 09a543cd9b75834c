"""The port's native image decoder (``data/fastimage.py``), its loaders with
``use_native=True`` and the packer (``data/packed.pack_image_folder``,
``cli.pack``) against the JAX package's: equal bytes on the same files.

Both bind the committed ``native/libfastimage.so``; the tests skip only if
it does not load here. The images are made with numpy from fixed seeds
(PNG and JPEG, ragged sizes, as the JAX package's tests/test_packed.py)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from vit_project_tpu.data import fastimage as jfi
from vit_project_tpu.data import imagenet as jimg
from vit_project_tpu.data import packed as jpacked
from vit_project_torch.cli import pack as tpack_cli
from vit_project_torch.data import fastimage as tfi
from vit_project_torch.data import imagenet as timg
from vit_project_torch.data import packed as tpacked

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native():
    if not jfi.available():
        pytest.skip("the committed native/libfastimage.so does not load on "
                    "this host")
    assert tfi.available() and tfi.mem_available()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """ImageFolder with mixed encodings (PNG and JPEG) and ragged sizes:
    2 classes x 10 train + 6 val."""
    from PIL import Image
    root = tmp_path_factory.mktemp("imgfolder")
    rs = np.random.RandomState(0)
    for split, n in (("train", 10), ("val", 6)):
        for ci, cls in enumerate(("ant", "bee")):
            d = root / split / cls
            os.makedirs(d)
            for i in range(n):
                h, w = 40 + 3 * i, 44 + 2 * ci
                img = Image.fromarray(rs.randint(0, 255, (h, w, 3), np.uint8))
                if i % 2:
                    img.save(d / f"{i}.jpg", quality=95)
                else:
                    img.save(d / f"{i}.png")
    return str(root)


def _files(folder):
    return timg.scan_image_folder(os.path.join(folder, "train"))[0]


# -- the decoder ----------------------------------------------------------------

@pytest.mark.parametrize("mode,out_hw,resize_to", [
    (tfi.MODE_RESIZE, (24, 32), 256), (tfi.MODE_RRC_FLIP, (32, 32), 256),
    (tfi.MODE_CENTER_CROP, (32, 32), 36)])
def test_decoder_matches_jax(native, folder, mode, out_hw, resize_to):
    """transform, transform_batch and transform_mem_batch give JAX's bytes
    for every file (PNG and JPEG), in one mode each."""
    paths = _files(folder)
    seeds = np.arange(len(paths), dtype=np.uint64) * 7919 + 3
    for p, seed in zip(paths[:4], seeds):
        np.testing.assert_array_equal(
            tfi.transform(p, mode, *out_hw, resize_to=resize_to,
                          seed=int(seed)),
            jfi.transform(p, mode, *out_hw, resize_to=resize_to,
                          seed=int(seed)))
    want = jfi.transform_batch(paths, mode, *out_hw, seeds,
                               resize_to=resize_to, threads=3)
    np.testing.assert_array_equal(
        tfi.transform_batch(paths, mode, *out_hw, seeds, resize_to=resize_to,
                            threads=3), want)
    bufs = []
    for p in paths:
        with open(p, "rb") as f:
            bufs.append(f.read())
    np.testing.assert_array_equal(
        tfi.transform_mem_batch(bufs, mode, *out_hw, seeds,
                                resize_to=resize_to, threads=2), want)


def test_decoder_checks_its_arguments(native, folder):
    paths = _files(folder)[:3]
    with pytest.raises(ValueError, match="seeds"):
        tfi.transform_batch(paths, tfi.MODE_RESIZE, 8, 8, [1, 2])
    with pytest.raises(ValueError, match="exceeds resize_to"):
        tfi.transform_mem_batch([b"x"], tfi.MODE_CENTER_CROP, 64, 64, [0],
                                resize_to=32)
    with pytest.raises(IOError):
        tfi.transform_mem_batch([b"not an image"], tfi.MODE_RESIZE, 8, 8, [0])


def test_decoder_through_pillows_libraries(native, folder, tmp_path):
    """The route a host without libjpeg / libpng takes: in a fresh process,
    libjpeg and libpng from Pillow's bundle under their standard sonames,
    then the committed library, bound to them (no system copy mapped). The
    decoded bytes are the system libraries'."""
    paths = _files(folder)
    seeds = np.arange(len(paths), dtype=np.uint64)
    want = jfi.transform_batch(paths, jfi.MODE_RRC_FLIP, 32, 32, seeds)
    code = (
        "import json, sys, numpy as np\n"
        "from vit_project_torch.data import fastimage as f\n"
        "assert f._pillow_deps()\n"
        "paths = json.loads(sys.argv[1])\n"
        "np.save(sys.argv[2], f.transform_batch(paths, f.MODE_RRC_FLIP, 32, "
        "32, np.arange(len(paths), dtype=np.uint64)))\n"
        "maps = open('/proc/self/maps').read()\n"
        "libs = {l.split()[-1] for l in maps.splitlines() "
        "if 'libjpeg' in l or 'libpng' in l}\n"
        "print(json.dumps(sorted(libs)))\n")
    out = str(tmp_path / "got.npy")
    res = subprocess.run([sys.executable, "-c", code, json.dumps(paths), out],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    libs = json.loads(res.stdout.splitlines()[-1])
    assert len(libs) == 2 and all("fastimage-deps" in p for p in libs), libs
    np.testing.assert_array_equal(np.load(out), want)


def test_set_soname_rewrites_only_the_name(tmp_path):
    """The ELF rewrite (on a copy of Pillow's libjpeg) keeps the file's size
    and every byte but the soname's, and refuses a longer name."""
    import PIL
    import glob
    bundle = os.path.join(os.path.dirname(PIL.__path__[0]), "pillow.libs")
    found = glob.glob(os.path.join(bundle, "libjpeg-*.so.62*"))
    if len(found) != 1:
        pytest.skip("Pillow bundles no libjpeg on this host")
    src = found[0]
    dst = str(tmp_path / "libjpeg.so.62")
    with open(src, "rb") as f:
        before = f.read()
    with open(dst, "wb") as f:
        f.write(before)
    tfi._set_soname(dst, "libjpeg.so.62")
    with open(dst, "rb") as f:
        after = f.read()
    old = os.path.basename(src).encode()
    assert len(after) == len(before)
    at = before.index(old + b"\0")
    assert after[at:at + len(old) + 1] == \
        b"libjpeg.so.62" + b"\0" * (len(old) - 13 + 1)
    assert after[:at] == before[:at]
    assert after[at + len(old):] == before[at + len(old):]
    with pytest.raises(ValueError, match="shorter"):
        tfi._set_soname(dst, "x" * 64)


# -- the loaders ------------------------------------------------------------------

@pytest.fixture(scope="module")
def packs(folder, tmp_path_factory):
    """The fixture's splits packed by each package."""
    root = tmp_path_factory.mktemp("packs")
    out = {}
    for name, mod in (("jax", jpacked), ("port", tpacked)):
        for split in ("train", "val"):
            mod.pack_image_folder(os.path.join(folder, split),
                                  str(root / name / split), shard_mb=1)
        out[name] = str(root / name)
    return out


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("split", ["train", "val"])
def test_native_loaders_match_jax(native, folder, packs, split, packed):
    """ImageFolderLoader and PackedLoader with use_native=True give JAX's
    batches byte for byte (two epochs of train, the val pass)."""
    train = split == "train"
    kw = dict(train=train, seed=5, size=32, workers=3, drop_last=train,
              use_native=True)
    if packed:
        got = tpacked.make_loader(os.path.join(packs["port"], split), 4, **kw)
        want = jpacked.make_loader(os.path.join(packs["jax"], split), 4, **kw)
        assert isinstance(got, tpacked.PackedLoader)
    else:
        got = timg.ImageFolderLoader(os.path.join(folder, split), 4, **kw)
        want = jimg.ImageFolderLoader(os.path.join(folder, split), 4, **kw)
    assert len(got) == len(want)
    for e in ((0, 1) if train else (0,)):
        pairs = list(zip(got.epoch(e), want.epoch(e)))
        assert len(pairs) == len(want)
        for (gi, gl), (wi, wl) in pairs:
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


def test_check_native_raises_at_construction(folder, packs, monkeypatch,
                                             tmp_path):
    """FASTIMAGE_SO naming a missing file: both loaders, make_loader and a
    training run with use_native_loader raise before any batch."""
    from vit_project_torch.core.configs import ViTTrainConfig
    from vit_project_torch.models import vit as tvit
    from vit_project_torch.train import vit_loop
    monkeypatch.setenv("FASTIMAGE_SO", str(tmp_path / "missing.so"))
    assert not tfi.available()
    for make in (
            lambda: timg.ImageFolderLoader(os.path.join(folder, "val"), 4,
                                           train=False, use_native=True),
            lambda: tpacked.make_loader(os.path.join(packs["port"], "val"), 4,
                                        train=False, use_native=True)):
        with pytest.raises(RuntimeError, match="use_native=True"):
            make()
    cfg = ViTTrainConfig(data_path=folder, output_dir=str(tmp_path / "run"),
                         batch_size=4, epochs=1, num_classes=2, image_size=32,
                         compute_dtype="float32", use_native_loader=True)
    tiny = tvit.ViTConfig(patch=8, width=32, layers=1, heads=2,
                          image_size=32, num_classes=2)
    with pytest.raises(RuntimeError, match="use_native=True"):
        vit_loop.run_vit_training(cfg, vit_cfg=tiny, device="cpu")
    assert not os.path.exists(tmp_path / "run" / "training_metrics.csv")
    monkeypatch.delenv("FASTIMAGE_SO")
    assert tfi.available() == jfi.available()


# -- the packer ---------------------------------------------------------------------

@pytest.mark.parametrize("shard_mb", [0, 1])
def test_pack_image_folder_matches_jax(folder, tmp_path, shard_mb):
    """Shards and meta.json byte for byte, and equal index arrays (shard_mb
    0 puts every record in its own shard)."""
    outs = {}
    for name, mod in (("jax", jpacked), ("port", tpacked)):
        outs[name] = str(tmp_path / name)
        meta = mod.pack_image_folder(os.path.join(folder, "train"),
                                     outs[name], shard_mb=shard_mb)
    n = len(_files(folder))
    assert len(meta["shards"]) == (n if shard_mb == 0 else 1)
    names = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["port"])) == names
    for f in names:
        a, b = (os.path.join(outs[k], f) for k in ("port", "jax"))
        if f == tpacked.INDEX_NAME:
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype
                    np.testing.assert_array_equal(za[k], zb[k])
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f


def test_pack_cli_checks_every_split_before_packing(folder, tmp_path):
    src = tmp_path / "src"
    os.makedirs(src)
    os.symlink(os.path.join(folder, "train"), src / "train")
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="not a directory"):
        tpack_cli.main(["--src", str(src), "--out", str(out)])
    assert not os.path.exists(out)
    assert tpack_cli.main(["--src", folder, "--out", str(out),
                           "--shard_mb", "1"]) == 0
    for split in ("train", "val"):
        assert tpacked.is_packed(str(out / split))
