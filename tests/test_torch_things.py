"""The port's THINGS decode cache and EpochShuffler(drop_last=) against the
JAX package's data/things.py: one cache format read by both packages, a
cache keyed by the exact name sequence, and the same batches with and
without the last partial one."""
import numpy as np
import pandas as pd
import pytest

from vit_project_tpu.data import things as jthings
from vit_project_torch.data import things as tthings


def _fixture(root, n=6, seed=5):
    from PIL import Image
    rs = np.random.RandomState(seed)
    names = []
    for i in range(n):
        Image.fromarray(rs.randint(0, 255, (40, 50, 3), dtype=np.uint8)) \
            .save(root / f"im{i}.png")
        names.append(f"im{i}.png")
    df = pd.DataFrame({"image_name": names})
    for j in range(66):
        df[f"d{j}"] = rs.rand(n).astype(np.float32)
    df.to_csv(root / "a.csv")
    return df


@pytest.mark.parametrize("writer,reader", [(jthings, tthings),
                                           (tthings, jthings)])
def test_cache_written_by_one_package_loads_in_the_other(tmp_path, writer,
                                                         reader, monkeypatch):
    _fixture(tmp_path)
    csv, cache = str(tmp_path / "a.csv"), str(tmp_path / "c" / "things")
    first = writer.ThingsDataset(csv, str(tmp_path), size=32,
                                 cache_file=cache)
    assert (tmp_path / "c" / "things.npz").is_file()   # the suffix is added
    # the reader must take the images from the cache: decoding would raise
    monkeypatch.setattr(reader, "decode_images", _no_decode)
    second = reader.ThingsDataset(csv, str(tmp_path), size=32,
                                  cache_file=cache + ".npz")
    assert second.images_u8.dtype == np.uint8
    assert second.images_u8.tobytes() == first.images_u8.tobytes()
    assert second.names == first.names


def _no_decode(*a, **k):
    raise AssertionError("decoded although the cache matches")


def test_cache_bytes_equal_the_jax_cache(tmp_path):
    _fixture(tmp_path)
    csv = str(tmp_path / "a.csv")
    jthings.ThingsDataset(csv, str(tmp_path), size=32,
                          cache_file=str(tmp_path / "j.npz"))
    tthings.ThingsDataset(csv, str(tmp_path), size=32,
                          cache_file=str(tmp_path / "t.npz"))
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(j.files) == sorted(t.files) == ["images", "names_sha256"]
    for k in j.files:
        assert j[k].dtype == t[k].dtype and j[k].tobytes() == t[k].tobytes()


@pytest.mark.parametrize("change", ["reorder", "size"])
def test_a_stale_cache_decodes_again(tmp_path, change):
    """A reordered CSV (same names, same count) or another image size must
    not pair the cached pixels with the wrong rows: it decodes again, equal
    to a fresh JAX decode, and rewrites the cache."""
    df = _fixture(tmp_path)
    cache = str(tmp_path / "cache.npz")
    tthings.ThingsDataset(str(tmp_path / "a.csv"), str(tmp_path), size=32,
                          cache_file=cache)
    csv, size = str(tmp_path / "a.csv"), 32
    if change == "reorder":
        df.iloc[::-1].reset_index(drop=True).to_csv(tmp_path / "b.csv")
        csv = str(tmp_path / "b.csv")
    else:
        size = 24
    got = tthings.ThingsDataset(csv, str(tmp_path), size=size,
                                cache_file=cache)
    want = jthings.ThingsDataset(csv, str(tmp_path), size=size)
    assert got.names == want.names
    np.testing.assert_array_equal(got.images_u8, want.images_u8)
    # the rewritten cache is the new one, and JAX reads it
    again = jthings.ThingsDataset(csv, str(tmp_path), size=size,
                                  cache_file=cache)
    np.testing.assert_array_equal(again.images_u8, want.images_u8)


@pytest.mark.parametrize("drop_last", [False, True])
def test_epoch_shuffler_drop_last_equals_jax(drop_last):
    """n = 1,444 (the THINGS training split) at batch 64: 22 full batches
    and one of 36, which drop_last leaves out."""
    a = tthings.EpochShuffler(1444, 64, 7, drop_last=drop_last)
    b = jthings.EpochShuffler(1444, 64, 7, drop_last=drop_last)
    for epoch in (0, 1, 5):
        got = [x.tolist() for x in a.batches(epoch)]
        assert got == [x.tolist() for x in b.batches(epoch)]
        assert len(got) == a.num_batches()
    assert a.num_batches() == b.num_batches() == (22 if drop_last else 23)
    assert tthings.EpochShuffler(1444, 64, 7).num_batches() == 23
