"""The port's copies of the JAX package's numpy data and metric functions
give the same bytes and values."""

import dataclasses

import numpy as np
import pytest

from herald_tpu.data import datasets as jds
from herald_tpu.utils import metrics as jm
from herald_tpu_torch.data import datasets as tds
from herald_tpu_torch.utils import metrics as tm


def test_dataset_specs_equal():
    assert {k: dataclasses.asdict(v) for k, v in tds.DATASETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jds.DATASETS.items()}
    for name in ("wdl_criteo", "dfm_avazu", "ncf_movie"):
        assert dataclasses.asdict(tds.dataset_for_model(name)) == \
            dataclasses.asdict(jds.dataset_for_model(name))
    with pytest.raises(ValueError):
        tds.dataset_for_model("wdl_nowhere")


@pytest.mark.parametrize("kw", [
    dict(spec="criteo", n=500, seed=0, num_rows=1200),
    dict(spec="criteo", n=300, seed=7, num_rows=60, session_len=4),
    dict(spec="avazu", n=200, seed=3, num_rows=5000, learnable=False),
    dict(spec="movie", n=100, seed=1, num_rows=900, zipf_a=1.5),
], ids=["criteo", "criteo_session", "avazu_unlearnable", "movie_nodense"])
def test_synthetic_data_byte_identical(kw):
    kw = dict(kw)
    spec, n = kw.pop("spec"), kw.pop("n")
    a = jds.synthetic_ctr_data(jds.DATASETS[spec], n, **kw)
    b = tds.synthetic_ctr_data(tds.DATASETS[spec], n, **kw)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 400).astype(np.float32)
    # rounded scores: many ties exercise the tie-averaged ranks
    s = np.round(rng.random(400), 2).astype(np.float32)
    assert tm.auc_score(y, s) == jm.auc_score(y, s)
    assert tm.accuracy(y, s) == jm.accuracy(y, s)
    assert tm.accuracy(y, s, 0.3) == jm.accuracy(y, s, 0.3)
    assert tm.auc_score(np.ones(5), s[:5]) == 0.5


@pytest.mark.parametrize("layout", ["npy", "movie_npz", "synthetic"])
def test_load_dataset_matches_jax(layout, tmp_path):
    rng = np.random.default_rng(9)
    if layout == "npy":
        spec = "criteo"
        np.save(tmp_path / "train_dense_feats.npy",
                rng.standard_normal((40, 13)).astype(np.float32))
        np.save(tmp_path / "train_sparse_feats.npy",
                rng.integers(0, 500, (40, 26)))
        np.save(tmp_path / "train_labels.npy",
                rng.integers(0, 2, 40).astype(np.float32))
    elif layout == "movie_npz":
        spec = "movie"
        np.savez(tmp_path / "train.npz",
                 user_input=rng.integers(0, 50, 30),
                 item_input=rng.integers(50, 90, 30),
                 labels=rng.integers(0, 2, 30))
    else:
        spec = "avazu"               # a path without files falls back
    got = tds.load_dataset(tds.DATASETS[spec], str(tmp_path),
                           num_samples=64, seed=4, num_rows=700)
    want = jds.load_dataset(jds.DATASETS[spec], str(tmp_path),
                            num_samples=64, seed=4, num_rows=700)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
