"""The port's training-side building blocks against the JAX package: DoRA
dropout and dora_linear, behavioral RSA (also against scipy), the THINGS
CSV reader, split and epoch order, the CSV writer, and the checkpoint
containers read across packages. Inputs come from numpy seeds (or, for the
dropout mask, from JAX's own draw) and go to both packages."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.io
import scipy.stats
import torch

from vit_project_tpu.ckpt import clip_ckpt as jckpt
from vit_project_tpu.ckpt import serialization as jser
from vit_project_tpu.core import csvio as jcsvio
from vit_project_tpu.data import things as jthings
from vit_project_tpu.ops import dora as jdora
from vit_project_tpu.ops import rsa as jrsa
from vit_project_torch.adapters import dora as tadora
from vit_project_torch.ckpt import clip_ckpt as tckpt
from vit_project_torch.ckpt import serialization as tser
from vit_project_torch.core import csvio as tcsvio
from vit_project_torch.data import things as tthings
from vit_project_torch.ops import dora as tdora
from vit_project_torch.ops import rsa as trsa
from vit_project_torch.train import clip_loop as tloop


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# -- DoRA ---------------------------------------------------------------------

def _dora_inputs(seed=0, d_in=16, d_out=8, r=4):
    tr, buf = jdora.dora_init(jax.random.PRNGKey(seed),
                              jnp.asarray(np.random.RandomState(seed)
                                          .randn(d_in, d_out), jnp.float32),
                              r=r)
    return tr, buf


def test_dora_weight_dropout_with_jax_mask():
    """Dropout on ΔD with the keep-mask JAX draws for the same key, fed to
    the port: f32, 1e-6 (the same arithmetic)."""
    tr, buf = _dora_inputs()
    key = jax.random.PRNGKey(7)
    want = jdora.dora_weight(tr, buf["D"], alpha=16, r=4, dropout_p=0.3,
                             dropout_key=key, deterministic=False)
    keep = np.array(jax.random.bernoulli(key, 0.7, (16, 8)))
    got = tdora.dora_weight({k: _t(v) for k, v in tr.items()}, _t(buf["D"]),
                            alpha=16, r=4, dropout_p=0.3, deterministic=False,
                            keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    assert not np.allclose(want, jdora.dora_weight(tr, buf["D"], alpha=16,
                                                   r=4))


def test_dora_linear_matches_jax():
    """x @ W_adapted + bias, f32, 1e-5; the gradient reaches all three
    adapter tensors."""
    tr, buf = _dora_inputs(seed=1)
    bias = np.random.RandomState(2).randn(8).astype(np.float32)
    x = np.random.RandomState(3).randn(3, 5, 16).astype(np.float32)
    want = jdora.dora_linear(jnp.asarray(x), tr, {**buf, "bias": bias},
                             alpha=16, r=4)
    ttr = tadora.make_trainable({"v": {0: tr}})["v"][0]
    got = tdora.dora_linear(_t(x), ttr, {"D": _t(buf["D"]), "bias": _t(bias)},
                            alpha=16, r=4)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    got.sum().backward()
    assert all(float(v.grad.abs().sum()) > 0 for v in ttr.values())


def test_dropout_streams_are_pure_functions_of_their_path():
    k = tdora.DropoutKey.root(1).fold_in(0).fold_in(3)
    a = tdora.dropout_keep_mask((32, 32), 0.1, k, "cpu")
    b = tdora.dropout_keep_mask((32, 32), 0.1,
                                tdora.DropoutKey((1, 0, 3)), "cpu")
    assert torch.equal(a, b)
    v, t = k.split()
    c = tdora.dropout_keep_mask((32, 32), 0.1, v, "cpu")
    assert not torch.equal(a, c)
    assert not torch.equal(c, tdora.dropout_keep_mask((32, 32), 0.1, t,
                                                      "cpu"))
    assert 0.8 < float(a.float().mean()) < 0.97


def test_dropout_needs_a_key():
    tr, buf = _dora_inputs()
    with pytest.raises(ValueError, match="dropout_key"):
        tdora.dora_weight({k: _t(v) for k, v in tr.items()}, _t(buf["D"]),
                          alpha=16, r=4, dropout_p=0.1, deterministic=False)


# -- RSA ----------------------------------------------------------------------

def test_behavioral_rsa_matches_jax():
    """The model RDM within 2e-6 and rho within 1e-6 of the JAX package
    (f32 in both). The p-value: the port's (scipy's betainc in f64) equals
    scipy.stats.spearmanr's within 1e-6; JAX evaluates betainc in f32 at
    a = df/2 = 563, which is 1.7e-3 relative off here, so the port is held
    to JAX's p at 3e-3 relative."""
    rs = np.random.RandomState(0)
    emb = rs.randn(48, 66).astype(np.float32)
    ref = rs.rand(48, 48).astype(np.float32)
    ref = (ref + ref.T) / 2
    np.fill_diagonal(ref, 0)
    jrho, jp, jrdm = jrsa.behavioral_rsa(jnp.asarray(emb), jnp.asarray(ref))
    rho, p, rdm = trsa.behavioral_rsa(torch.from_numpy(emb), ref)
    assert isinstance(rho, float) and isinstance(p, float)
    np.testing.assert_allclose(rdm.numpy(), jrdm, atol=2e-6)
    assert abs(rho - float(jrho)) < 1e-6
    iu = np.triu_indices(48, k=1)
    want = scipy.stats.spearmanr(ref[iu], rdm.numpy()[iu])
    assert abs(rho - want.statistic) < 1e-6
    assert abs(p - want.pvalue) < 1e-6
    assert abs(p - float(jp)) < 3e-3 * float(jp)


def test_spearman_with_ties_matches_scipy():
    """Ties get average ranks (scipy.stats.rankdata); rho and p match
    scipy.stats.spearmanr within 1e-6 / 1e-6."""
    rs = np.random.RandomState(1)
    x = rs.randint(0, 20, 300).astype(np.float32)   # many ties
    y = (x + rs.randint(0, 15, 300)).astype(np.float32)
    np.testing.assert_array_equal(
        trsa.rankdata_average(torch.from_numpy(x)).numpy(),
        scipy.stats.rankdata(x).astype(np.float32))
    rho, p = trsa.spearman(torch.from_numpy(x), torch.from_numpy(y))
    want = scipy.stats.spearmanr(x, y)
    assert abs(rho - want.statistic) < 1e-6
    assert abs(p - want.pvalue) < 1e-6
    assert trsa.spearman(torch.from_numpy(x), torch.from_numpy(x))[1] == 0.0


def test_upper_tri_order_is_numpy_order():
    a = np.arange(25, dtype=np.float32).reshape(5, 5)
    np.testing.assert_array_equal(
        trsa.upper_tri(torch.from_numpy(a)).numpy(),
        a[np.triu_indices_from(a, k=1)])


# -- THINGS data --------------------------------------------------------------

@pytest.fixture(scope="module")
def things_csv(tmp_path_factory):
    import pandas as pd
    root = tmp_path_factory.mktemp("things_csv")
    rs = np.random.RandomState(0)
    names = [f"thing_{i:03d}.png" for i in range(30)]
    df = pd.DataFrame({"image_name": names})
    for j in range(66):
        df[f"d{j}"] = (rs.rand(30) * 2).astype(np.float32)
    df.loc[df.index[4], "d3"] = np.nan
    path = root / "spose.csv"
    df.to_csv(path)
    return str(path)


def test_things_csv_reads_like_pandas_index_col_0(things_csv):
    import pandas as pd
    ann = pd.read_csv(things_csv, index_col=0)
    names, values = tthings.read_annotations(things_csv)
    assert names == ann.iloc[:, 0].tolist()
    np.testing.assert_array_equal(values,
                                  ann.iloc[:, 1:].values.astype(np.float32))
    assert np.isnan(values[4, 3])


def test_things_dataset_matches_jax(tmp_path):
    from PIL import Image
    import pandas as pd
    rs = np.random.RandomState(5)
    names = []
    for i in range(6):
        Image.fromarray(rs.randint(0, 255, (40, 50, 3), dtype=np.uint8)) \
            .save(tmp_path / f"im{i}.png")
        names.append(f"im{i}.png")
    df = pd.DataFrame({"image_name": names})
    for j in range(66):
        df[f"d{j}"] = rs.rand(6).astype(np.float32)
    df.to_csv(tmp_path / "a.csv")
    want = jthings.ThingsDataset(str(tmp_path / "a.csv"), str(tmp_path),
                                 size=32)
    got = tthings.ThingsDataset(str(tmp_path / "a.csv"), str(tmp_path),
                                size=32)
    assert got.names == want.names and len(got) == 6
    np.testing.assert_array_equal(got.targets, want.targets)
    np.testing.assert_array_equal(got.images_u8, want.images_u8)
    np.testing.assert_allclose(
        tthings.normalize_uint8(torch.from_numpy(got.images_u8)).numpy(),
        jthings.normalize_uint8(jnp.asarray(want.images_u8)), atol=1e-6)


def test_split_and_epoch_order_equal_jax(tmp_path):
    assert (tthings.random_split_indices(1806, 0.8, 1)
            == jthings.random_split_indices(1806, 0.8, 1))
    tr, te = tthings.random_split_indices(1806, 0.8, 1)
    assert (len(tr), len(te)) == (1444, 362)
    a = tthings.EpochShuffler(1444, 64, 7)
    b = jthings.EpochShuffler(1444, 64, 7)
    for epoch in (0, 1, 5):
        assert [x.tolist() for x in a.batches(epoch)] == \
            [x.tolist() for x in b.batches(epoch)]
    assert a.num_batches() == b.num_batches() == 23
    # a split written by either package is read by the other
    tthings.save_split_indices(str(tmp_path / "t.pth"), tr, te, 1)
    assert jthings.load_split_indices(str(tmp_path / "t.pth"))[
        "train_indices"] == tr
    jthings.save_split_indices(str(tmp_path / "j.pth"), tr, te, 1)
    assert tthings.load_split_indices(str(tmp_path / "j.pth"))[
        "test_indices"] == te


def test_clip_csv_bytes_equal_jax(tmp_path):
    rows = [(1, 0.5, 0.25, -0.125, 0.75, False, False, False, False),
            (2, 0.4, 0.2, 0.1, 0.5, True, False, False, False)]
    for mod, name in ((jcsvio, "j.csv"), (tcsvio, "t.csv")):
        path = str(tmp_path / name)
        mod.init_clip_csv(path)
        for r in rows:
            mod.append_clip_row(path, *r)
    assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "t.csv") \
        .read_bytes()
    assert tcsvio.last_completed_epoch0(str(tmp_path / "t.csv")) == 1


# -- checkpoint containers across packages -----------------------------------

def _trees(seed=0):
    rs = np.random.RandomState(seed)
    return {"visual": {1: {"m": rs.rand(8).astype(np.float32),
                           "delta_D_A": rs.rand(4, 8).astype(np.float32),
                           "delta_D_B": rs.rand(8, 4).astype(np.float32)}},
            "text": {0: {"m": rs.rand(8).astype(np.float32),
                         "delta_D_A": rs.rand(4, 8).astype(np.float32),
                         "delta_D_B": rs.rand(8, 4).astype(np.float32)}}}


def test_random_states_cross_packages(tmp_path):
    """The JAX package's optax state loads into torch AdamW and back; a
    file the port writes is read by the JAX package as optax's classes,
    with optax.adamw's tree structure."""
    params = jax.tree_util.tree_map(jnp.asarray, _trees())
    opt = optax.adamw(1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    state = opt.init(params)
    grads = jax.tree_util.tree_map(lambda x: x * 0.5 - 0.2, params)
    for _ in range(2):
        _, state = opt.update(grads, state, params)
    jckpt.save_random_states(state, 1, str(tmp_path / "j"), 9,
                             {"dropout_seed": 1})
    loaded = tckpt.load_random_states(str(tmp_path / "j"), 2)
    assert isinstance(loaded["optimizer_state"][0], tser.ScaleByAdamState)
    trainable = tadora.make_trainable(_trees())
    optimizer = tloop.make_optimizer(
        [p for *_, p in tadora.trainable_leaves(trainable)], 1e-3)
    assert tckpt.adamw_state_matches(loaded["optimizer_state"], trainable)
    tckpt.adamw_state_from_optax(optimizer, loaded["optimizer_state"],
                                 trainable)
    leaf = trainable["visual"][1]["m"]
    assert float(optimizer.state[leaf]["step"]) == 2
    np.testing.assert_array_equal(optimizer.state[leaf]["exp_avg"].numpy(),
                                  np.asarray(state[0].mu["visual"][1]["m"]))
    back = tckpt.optax_state_from_adamw(optimizer, trainable)
    tckpt.save_random_states(back, 1, str(tmp_path / "t"), 9,
                             {"dropout_seed": 1})
    again = jckpt.load_random_states(str(tmp_path / "t"), 2)
    restored = jax.tree_util.tree_map(jnp.asarray, again["optimizer_state"])
    assert isinstance(restored[0], optax.ScaleByAdamState)
    assert (jax.tree_util.tree_structure(restored)
            == jax.tree_util.tree_structure(state))
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert again["data_seed"] == 9 and again["epoch"] == 1


def test_dora_params_cross_packages(tmp_path):
    spec = {"visual": [1], "text": [0]}
    tr = tadora.make_trainable(_trees(3))
    path = tckpt.save_dora_parameters(tr, str(tmp_path), 0)
    assert os.path.basename(path) == "epoch1_dora_params.pth"
    flat = jser.load_flat(path)
    assert tadora.checkpoint_module_paths(flat) == \
        tadora.spec_module_paths(spec)
    got = jckpt.load_dora_parameters(path, _trees(4), spec)
    np.testing.assert_array_equal(got["text"][0]["delta_D_B"],
                                  _trees(3)["text"][0]["delta_D_B"])
    # torch.load(weights_only=True) reads it: a plain torch archive
    assert set(torch.load(path, weights_only=True)) == set(flat)
