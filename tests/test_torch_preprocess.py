"""The port's raw-dataset preprocessing (`herald_tpu_torch/data/
preprocess.py`) against herald_tpu's, on the CPU: the six tests of
tests/test_preprocess.py, each running both packages' function on the
same raw file and requiring the six `.npy` files to be byte-equal.

The native parser (`csrc/herald_preproc.cc`) is built by the port's own
loader (`herald_tpu_torch/sched/build.py`) into `herald_tpu_torch/_build/`.
JAX's fast path is run with its library from that same build of the same
source: herald_tpu's loader writes every build to one shared temporary
path (ROADMAP queue 1's `sched/build.py:66` fault), so a second build
beside its own tests could race them.
"""

import ctypes

import numpy as np
import pytest

from herald_tpu.data import DATASETS as JAX_DATASETS
from herald_tpu.data import load_dataset as jax_load_dataset
from herald_tpu.data import preprocess as jax_pp
from herald_tpu_torch.data import DATASETS, load_dataset
from herald_tpu_torch.data import preprocess as pp
from herald_tpu_torch.sched import build

FILES = ("train_dense_feats.npy", "train_sparse_feats.npy",
         "train_labels.npy", "test_dense_feats.npy",
         "test_sparse_feats.npy", "test_labels.npy")


def _write(path, rows, delim):
    with open(path, "w") as f:
        for r in rows:
            f.write(delim.join(str(x) for x in r) + "\n")


def _same_files(a, b):
    for name in FILES:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _both(tmp_path, fn_name, *args, **kw):
    """Each package's `fn_name`(*args, out_dir, **kw); the files compared
    byte for byte, and the returned train arrays equal."""
    got = getattr(pp, fn_name)(*args, str(tmp_path / "port"), **kw)
    want = getattr(jax_pp, fn_name)(*args, str(tmp_path / "jax"), **kw)
    _same_files(tmp_path / "port", tmp_path / "jax")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    return got


def _criteo_rows(seed, n):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        label = int(rng.integers(0, 2))
        dense = [("" if rng.random() < 0.2
                  else round(float(rng.integers(-2, 100)), 1))
                 for _ in range(13)]
        sparse = [("" if rng.random() < 0.2 else f"v{rng.integers(0, 5)}")
                  for _ in range(26)]
        rows.append([label] + dense + sparse)
    return rows


def test_criteo_preprocess_semantics(tmp_path):
    n = 50
    raw = tmp_path / "train.txt"
    _write(raw, _criteo_rows(0, n), "\t")
    dense, sparse, labels = _both(tmp_path, "preprocess_criteo", str(raw),
                                  seed=0)
    assert len(labels) == n - n // 10
    assert dense.shape[1] == 13 and sparse.shape[1] == 26
    # per-column disjoint contiguous id ranges, cumulative offsets
    all_sparse = np.concatenate(
        [sparse, np.load(tmp_path / "port" / "test_sparse_feats.npy")])
    offset = 0
    for f in range(26):
        uniq = np.unique(all_sparse[:, f])
        np.testing.assert_array_equal(uniq,
                                      np.arange(offset, offset + len(uniq)))
        offset += len(uniq)
    # the port's loader reads the layout as JAX's does
    got = load_dataset(DATASETS["criteo"], str(tmp_path / "port"))
    want = jax_load_dataset(JAX_DATASETS["criteo"], str(tmp_path / "jax"))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_avazu_and_criteosearch_layouts(tmp_path):
    rng = np.random.default_rng(1)
    n = 40
    header = (["id", "click", "I1", "C1", "I2"]
              + [f"C{i}" for i in range(2, 11)] + ["I3", "I4"]
              + [f"C{i}" for i in range(11, 19)])
    rows = [header]
    for i in range(n):
        r = [i, int(rng.integers(0, 2)), rng.integers(0, 9),
             f"a{rng.integers(0, 4)}", rng.integers(0, 9)]
        r += [f"b{rng.integers(0, 4)}" for _ in range(9)]
        r += [rng.integers(0, 9), rng.integers(0, 9)]
        r += [f"c{rng.integers(0, 4)}" for _ in range(8)]
        rows.append(r)
    raw = tmp_path / "train.csv"
    _write(raw, rows, ",")
    dense, sparse, labels = _both(tmp_path / "av", "preprocess_avazu",
                                  str(raw), seed=0)
    assert (dense.shape[1], sparse.shape[1]) == (4, 18)
    assert set(np.unique(labels)) <= {0.0, 1.0}

    rows = []
    for i in range(n):
        r = [int(rng.integers(0, 2)), round(float(rng.random()), 3),
             rng.integers(0, 99)]
        r += [rng.integers(-2, 99) for _ in range(3)]
        r += [f"h{rng.integers(0, 6)}" for _ in range(17)]
        rows.append(r)
    raw2 = tmp_path / "CriteoSearchData"
    _write(raw2, rows, "\t")
    dense, sparse, _ = _both(tmp_path / "cs", "preprocess_criteo_search",
                             str(raw2), seed=0)
    assert (dense.shape[1], sparse.shape[1]) == (3, 17)
    assert dense.min() > -1          # the search variant maps x <= -1 to 0


def test_movie_npz_layout(tmp_path):
    """MovieLens ingestion through each package's `load_dataset`."""
    rng = np.random.default_rng(3)
    n = 64
    np.savez(tmp_path / "train.npz", user_input=rng.integers(0, 100, n),
             item_input=100 + rng.integers(0, 50, n),
             labels=rng.integers(0, 2, n).astype(np.float32))
    got = load_dataset(DATASETS["movie"], str(tmp_path))
    want = jax_load_dataset(JAX_DATASETS["movie"], str(tmp_path))
    assert got[1].shape == (n, 2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _hex_rows(seed, n):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        r = [str(int(rng.integers(0, 2)))]
        r += ["" if rng.random() < 0.2
              else str(round(float(rng.normal()) * 10, 3))
              for _ in range(13)]
        r += ["" if rng.random() < 0.15
              else f"{int(rng.integers(0, 40)):08x}" for _ in range(26)]
        rows.append(r)
    return rows


def test_fast_preprocessor_bit_identical(tmp_path, monkeypatch):
    """The port's native path equals its Python path and JAX's native path
    byte for byte; and `preprocess_criteo` routes a file at the size
    threshold through it."""
    raw = tmp_path / "train.txt"
    raw.write_text("\n".join("\t".join(r) for r in _hex_rows(11, 400))
                   + "\n")
    cols = (0, list(range(1, 14)), list(range(14, 40)))
    pp.preprocess_table(pp._read_delim(str(raw), "\t", False),
                        label_col=0, dense_cols=cols[1], sparse_cols=cols[2],
                        out_dir=str(tmp_path / "slow"), seed=9)
    pp.fast_preprocess_table(str(raw), "\t", False, *cols,
                             str(tmp_path / "fast"), seed=9)
    _same_files(tmp_path / "slow", tmp_path / "fast")
    # JAX's fast path over the same source's library
    import herald_tpu.sched.build as jax_build
    monkeypatch.setattr(jax_build, "preproc_lib_path",
                        build.preproc_lib_path)
    jax_pp.fast_preprocess_table(str(raw), "\t", False, *cols,
                                 str(tmp_path / "jax_fast"), seed=9)
    _same_files(tmp_path / "fast", tmp_path / "jax_fast")
    # the route: a file at the threshold takes the native parser
    calls = []
    fast = pp.fast_preprocess_table
    monkeypatch.setattr(pp, "fast_preprocess_table",
                        lambda *a, **k: calls.append(a) or fast(*a, **k))
    monkeypatch.setattr(pp, "_FAST_THRESHOLD_BYTES", raw.stat().st_size)
    pp.preprocess_criteo(str(raw), str(tmp_path / "routed"), seed=9)
    assert len(calls) == 1
    _same_files(tmp_path / "fast", tmp_path / "routed")
    assert pp._FAST_THRESHOLD_BYTES != jax_pp._FAST_THRESHOLD_BYTES
    monkeypatch.undo()
    assert pp._FAST_THRESHOLD_BYTES == jax_pp._FAST_THRESHOLD_BYTES \
        == 64 * 1024 * 1024


def test_native_parser_is_the_ports_own_build(tmp_path, monkeypatch):
    """The library the port loads is its own `_build/` file, never the one
    beside the JAX package; a failed build raises."""
    raw = tmp_path / "train.txt"
    raw.write_text("\n".join("\t".join(r) for r in _hex_rows(2, 30)) + "\n")
    loaded = []
    real = ctypes.CDLL

    def spy(name, *a, **k):
        loaded.append(str(name))
        return real(name, *a, **k)
    monkeypatch.setattr(ctypes, "CDLL", spy)
    pp.fast_preprocess_table(str(raw), "\t", False, 0, list(range(1, 14)),
                             list(range(14, 40)), str(tmp_path / "o"),
                             seed=1)
    monkeypatch.undo()
    libs = [p for p in loaded if "preproc" in p]
    tag, _ = build.abi_hash(build.PREPROC_SOURCE)
    assert libs and set(libs) == {
        str(build.BUILD_DIR / f"libherald_preproc.{tag}.so")}
    # no fallback to the Python path: a build that fails raises
    monkeypatch.setattr(build, "CXXFLAGS", build.CXXFLAGS + ("-fno-such-option",))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="preproc build failed"):
        pp.fast_preprocess_table(str(raw), "\t", False, 0,
                                 list(range(1, 14)), list(range(14, 40)),
                                 str(tmp_path / "o2"), seed=1)


def test_preprocess_adult_semantics(tmp_path):
    rng = np.random.default_rng(3)
    n = 120
    cols = {k: rng.choice(v, n) for k, v in {
        "wc": ["Private", "Self-emp", "Gov"],
        "edu": ["HS", "College", "PhD"], "mar": ["Married", "Single"],
        "occ": ["Tech", "Sales", "Farm"], "rel": ["Husband", "Wife"],
        "race": ["White", "Black"], "gen": ["Male", "Female"],
        "nc": ["US", "MX"], "inc": ["<=50K", ">50K", ">50K."]}.items()}
    age = rng.integers(18, 80, n)
    extra = rng.integers(0, 5000, (n, 3))

    def write(path, idx):
        with open(path, "w") as f:
            for i in idx:
                c = {k: v[i] for k, v in cols.items()}
                f.write(f"{age[i]}, {c['wc']}, {extra[i, 0]}, {c['edu']},"
                        f" 9, {c['mar']}, {c['occ']}, {c['rel']},"
                        f" {c['race']}, {c['gen']}, {extra[i, 1]}, 0,"
                        f" {20 + extra[i, 2] % 40}, {c['nc']}, {c['inc']}\n")

    write(tmp_path / "tr.csv", range(100))
    write(tmp_path / "te.csv", range(100, n))
    dense, sparse, labels = _both(tmp_path, "preprocess_adult",
                                  str(tmp_path / "tr.csv"),
                                  test_csv=str(tmp_path / "te.csv"))
    assert len(labels) == 100 and sparse.shape == (100, 8)
    np.testing.assert_array_equal(dense[:, 4:].sum(axis=1),
                                  np.full(100, 11, np.float32))


def test_preprocess_movielens_npz(tmp_path):
    rng = np.random.default_rng(5)
    n = 200
    npz = tmp_path / "train.npz"
    np.savez(npz, user_input=rng.integers(0, 50, n),
             item_input=rng.integers(0, 30, n),
             labels=rng.integers(0, 2, n).astype(np.float32))
    dense, sparse, _ = _both(tmp_path, "preprocess_movielens", str(npz),
                             num_users=50, seed=0)
    assert dense.shape == (180, 0) and sparse.shape == (180, 2)
    assert sparse[:, 1].min() >= 50
