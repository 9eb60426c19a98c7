"""Raw-dataset preprocessing (the port's own copy of
`herald_tpu/data/preprocess.py`): reference `load_data.py` semantics, no
pandas.

Converts the raw Criteo / Avazu / CriteoSearch files into the processed
`.npy` layout consumed by `load_dataset` (the same six files the reference
writes: train/test x dense/sparse/labels — `examples/ctr/models/
load_data.py:151-175`):

- dense features: missing -> 0.0, then `log(x+1) if x > -1 else -1`
  (Criteo/Avazu, `load_data.py:179-184`) or `... else 0.0` (CriteoSearch,
  `load_data.py:186-191`);
- sparse features: missing -> "-1", per-column label encoding in sorted
  class order (sklearn LabelEncoder semantics, `load_data.py:193-206`),
  then cumulative per-column offsets so every column owns a disjoint
  global ID range;
- 90/10 random-permutation train/test split (`load_data.py:160-170`).

Files of 64 MB or more go through the native parser
(`csrc/herald_preproc.cc`, built by the port's own loader,
`sched/build.py` `preproc_lib_path`); a failed build raises. Smaller files
take the pure-Python path. Both write the same bytes.

Downloading is the user's job (the reference's download URLs are dead,
`load_data.py:131-140`); these functions take the already-downloaded raw
file. numpy, ctypes and the standard library only.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["preprocess_criteo", "preprocess_avazu",
           "preprocess_criteo_search", "preprocess_adult",
           "preprocess_movielens", "preprocess_table",
           "fast_preprocess_table"]


def _encode_sparse(columns: List[np.ndarray]) -> np.ndarray:
    """Per-column sorted-order label encoding + cumulative offsets."""
    out = []
    offset = 0
    for col in columns:
        uniq, codes = np.unique(col, return_inverse=True)
        out.append(codes.astype(np.int64) + offset)
        offset += len(uniq)
    return np.stack(out, axis=1)


def _dense_transform(columns: List[np.ndarray], *, search: bool
                     ) -> np.ndarray:
    out = []
    for col in columns:
        x = col.astype(np.float64)
        fallback = 0.0 if search else -1.0
        y = np.where(x > -1, np.log(np.maximum(x, -1) + 1 + 1e-300),
                     fallback)
        out.append(y.astype(np.float32))
    return np.stack(out, axis=1)


def preprocess_table(rows: Sequence[Sequence[str]], label_col: int,
                     dense_cols: Sequence[int], sparse_cols: Sequence[int],
                     out_dir: str, *, search_dense: bool = False,
                     seed: Optional[int] = None,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shared core: encode + transform + split + save the six .npy files.

    Returns the TRAIN (dense, sparse, labels) arrays."""
    ncols = max([label_col, *dense_cols, *sparse_cols]) + 1
    table = [[""] * ncols for _ in range(len(rows))]
    for i, r in enumerate(rows):
        for j in range(min(len(r), ncols)):
            table[i][j] = r[j]
    col = lambda j: np.array([t[j] for t in table])

    def numeric(j):
        c = col(j)
        c = np.where(c == "", "0.0", c)     # fillna(0.0)
        return c.astype(np.float64)

    labels = numeric(label_col).astype(np.float32)
    dense = _dense_transform([numeric(j) for j in dense_cols],
                             search=search_dense)
    sparse_raw = []
    for j in sparse_cols:
        c = col(j)
        sparse_raw.append(np.where(c == "", "-1", c))   # fillna("-1")
    sparse = _encode_sparse(sparse_raw)

    return _save_split(dense, sparse, labels, out_dir, seed=seed)


def _read_delim(path: str, delim: str, skip_header: bool):
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter=delim)
        rows = list(reader)
    return rows[1:] if skip_header else rows


# files above this size route through the native parser (the Python path
# materializes every cell as a str — hours at Criteo's 11 GB / 45M rows)
_FAST_THRESHOLD_BYTES = 64 * 1024 * 1024


def fast_preprocess_table(raw_path: str, delim: str, skip_header: bool,
                          label_col: int, dense_cols: Sequence[int],
                          sparse_cols: Sequence[int], out_dir: str, *,
                          search_dense: bool = False,
                          seed: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native-parser twin of the csv.reader + preprocess_table path,
    producing BIT-IDENTICAL outputs (tests/test_torch_preprocess.py pins
    it):
    the C++ side (csrc/herald_preproc.cc) streams the file once and
    emits raw numeric columns + per-column categorical codes in
    np.unique's sorted order; the numpy side applies the dense log
    transform, cumulative ID offsets, and the seeded 90/10 split.

    The only intentional difference from the slow path: quoted CSV
    fields are not un-quoted (the reference datasets never quote)."""
    import ctypes
    import tempfile

    from herald_tpu_torch.sched.build import preproc_lib_path
    lib = ctypes.CDLL(preproc_lib_path())
    lib.hprep_table.restype = ctypes.c_int64
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.hprep_table.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int, ctypes.c_int,
        i32p, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64)]

    dc = np.ascontiguousarray(dense_cols, np.int32)
    sc = np.ascontiguousarray(sparse_cols, np.int32)
    uniq = np.zeros(len(sparse_cols), np.int64)
    with tempfile.TemporaryDirectory(dir=out_dir
                                     if os.path.isdir(out_dir) else None
                                     ) as tmp:
        os.makedirs(out_dir, exist_ok=True)
        paths = [os.path.join(tmp, x)
                 for x in ("dense.f64", "sparse.i64", "labels.f32")]
        n = lib.hprep_table(
            raw_path.encode(), delim.encode(), int(skip_header),
            label_col, dc.ctypes.data_as(i32p), len(dense_cols),
            sc.ctypes.data_as(i32p), len(sparse_cols),
            paths[0].encode(), paths[1].encode(), paths[2].encode(),
            uniq.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if n < 0:
            raise RuntimeError(f"native preprocess failed on {raw_path}")
        n = int(n)
        dense_raw = np.fromfile(paths[0], np.float64).reshape(
            n, len(dense_cols))
        sparse = np.fromfile(paths[1], np.int64).reshape(
            n, len(sparse_cols))
        labels = np.fromfile(paths[2], np.float32)

    # cumulative per-column offsets (same as _encode_sparse)
    offsets = np.concatenate([[0], np.cumsum(uniq[:-1])])
    sparse += offsets[None, :]
    # dense transform (same formula as _dense_transform, vectorized)
    fallback = 0.0 if search_dense else -1.0
    dense = np.where(dense_raw > -1,
                     np.log(np.maximum(dense_raw, -1) + 1 + 1e-300),
                     fallback).astype(np.float32)

    return _save_split(dense, sparse, labels, out_dir, seed=seed)


def _route(raw_path: str, delim: str, skip_header: bool, label_col: int,
           dense_cols, sparse_cols, out_dir: str, *,
           search_dense: bool = False, seed: Optional[int] = None):
    """Pick the native parser for production-size files (bit-identical
    outputs; see fast_preprocess_table), the pure-Python path for small
    ones (no compile dependency in tiny/test runs)."""
    if os.path.getsize(raw_path) >= _FAST_THRESHOLD_BYTES:
        return fast_preprocess_table(
            raw_path, delim, skip_header, label_col, dense_cols,
            sparse_cols, out_dir, search_dense=search_dense, seed=seed)
    rows = _read_delim(raw_path, delim, skip_header)
    return preprocess_table(rows, label_col=label_col,
                            dense_cols=list(dense_cols),
                            sparse_cols=list(sparse_cols),
                            out_dir=out_dir, search_dense=search_dense,
                            seed=seed)


def preprocess_criteo(raw_path: str, out_dir: str,
                      seed: Optional[int] = None):
    """Criteo Kaggle `train.txt`: TSV, no header; label + I1..I13 + C14..C39
    (reference `download_criteo`, `load_data.py:124-175`)."""
    return _route(raw_path, "\t", False, 0,
                  list(range(1, 14)), list(range(14, 40)),
                  out_dir, seed=seed)


def preprocess_avazu(raw_path: str, out_dir: str,
                     seed: Optional[int] = None):
    """Avazu `train.csv`: CSV with header; columns id,click,I1,C1,I2,
    C2..C10,I3,I4,C11..C18 (reference `download_avazu`,
    `load_data.py:7-60`). 4 dense + 18 sparse; label = click."""
    dense_cols = [2, 4, 14, 15]                      # I1, I2, I3, I4
    sparse_cols = [3] + list(range(5, 14)) + list(range(16, 24))
    return _route(raw_path, ",", True, 1, dense_cols, sparse_cols,
                  out_dir, seed=seed)


def preprocess_criteo_search(raw_path: str, out_dir: str,
                             seed: Optional[int] = None):
    """CriteoSearchData: TSV, no header; sale, salesamount, timedelay,
    I1..I3, C4..C20 (reference `download_criteo_search`,
    `load_data.py:65-117`). label = sale; dense transform uses the
    `process_dense_feats_search` variant (missing -> 0.0)."""
    return _route(raw_path, "\t", False, 0, [3, 4, 5],
                  list(range(6, 23)), out_dir, search_dense=True,
                  seed=seed)


def _split_indices(n: int, seed=None):
    """The standard seeded 90/10 permutation split (reference
    `load_data.py:160-170`)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    test_num = max(n // 10, 1)
    return perm[:-test_num], perm[-test_num:]


def _save_split(dense, sparse, labels, out_dir, *, split=None, seed=None):
    """Write the standard six .npy files; split 90/10 unless explicit
    (train_idx, test_idx) arrays pick the rows (adult ships separate
    train/test CSVs)."""
    tr, te = split if split is not None else _split_indices(len(labels),
                                                            seed)
    os.makedirs(out_dir, exist_ok=True)
    names = ["train_dense_feats.npy", "train_sparse_feats.npy",
             "train_labels.npy", "test_dense_feats.npy",
             "test_sparse_feats.npy", "test_labels.npy"]
    arrays = [dense[tr], sparse[tr], labels[tr],
              dense[te], sparse[te], labels[te]]
    for name, arr in zip(names, arrays):
        np.save(os.path.join(out_dir, name), arr)
    return dense[tr], sparse[tr], labels[tr]


_ADULT_COLUMNS = ["age", "workclass", "fnlwgt", "education",
                  "education_num", "marital_status", "occupation",
                  "relationship", "race", "gender", "capital_gain",
                  "capital_loss", "hours_per_week", "native_country",
                  "income_bracket"]
_ADULT_EMBED = ["workclass", "education", "marital_status", "occupation",
                "relationship", "race", "gender", "native_country"]
_ADULT_CONT = ["age", "capital_gain", "capital_loss", "hours_per_week"]
_ADULT_WIDE = _ADULT_EMBED[:1] + ["education", "marital_status",
                                  "occupation", "relationship", "race",
                                  "gender", "native_country", "age_group"]
_ADULT_CROSS = (("education", "occupation"),
                ("native_country", "occupation"))


def preprocess_adult(train_csv: str, out_dir: str,
                     test_csv: Optional[str] = None,
                     seed: Optional[int] = None):
    """Census-income (wdl_adult): no-header CSV in the UCI `adult.data`
    column order (reference `maybe_download`/`load_adult_data`,
    `load_data.py:355-517`). Rebuilt without pandas/sklearn:

    - label = 1 iff ">50K" in income_bracket;
    - sparse = the 8 embedding columns, per-column sorted label encoding
      with cumulative offsets (one shared table; the reference keeps 8
      separate 50-row tables — same id space, different layout);
    - dense = 4 continuous columns standardized with TRAIN mean/std,
      then the wide one-hot block: 9 wide columns (incl. the (0,25],
      (25,65], (65,90] age_group) + 2 crossed columns, vocabularies over
      train+test (the reference one-hots the concatenated frame). Width
      is data-derived (809 on the real dataset -> 4 + 809 = the model
      spec's 813).

    With `test_csv` the reference's file split is kept; otherwise 90/10.
    """
    def read(path):
        rows = [r for r in _read_delim(path, ",", False) if len(r) >= 15]
        cols = {}
        for j, name in enumerate(_ADULT_COLUMNS):
            cols[name] = np.array([r[j].strip() for r in rows])
        return cols

    cols = read(train_csv)
    n_train = len(cols["age"])
    if test_csv:
        tcols = read(test_csv)
        cols = {k: np.concatenate([cols[k], tcols[k]]) for k in cols}
    n = len(cols["age"])
    if test_csv:
        split = (np.arange(n_train), np.arange(n_train, n))
    else:
        split = _split_indices(n, seed)    # decided NOW: the scaler must
        # fit on the train rows only (reference fits on df_train)

    labels = np.array([">50K" in v for v in
                       cols["income_bracket"]], np.float32)

    age = cols["age"].astype(np.float64)
    cols["age_group"] = np.digitize(age, [25, 65, 90],
                                    right=True).astype(str)

    sparse = _encode_sparse([cols[c] for c in _ADULT_EMBED])

    cont = np.stack([cols[c].astype(np.float64) for c in _ADULT_CONT],
                    axis=1)
    fit = cont[split[0]]
    mu, sd = fit.mean(axis=0), fit.std(axis=0)
    cont = ((cont - mu) / np.where(sd > 0, sd, 1.0)).astype(np.float32)

    wide_cols = [cols[c] for c in _ADULT_WIDE]
    for a, b in _ADULT_CROSS:
        wide_cols.append(np.char.add(np.char.add(
            cols[a].astype(str), "_"), cols[b].astype(str)))
    blocks = []
    for col in wide_cols:
        uniq, codes = np.unique(col, return_inverse=True)
        oh = np.zeros((n, len(uniq)), np.float32)
        oh[np.arange(n), codes] = 1.0
        blocks.append(oh)
    dense = np.concatenate([cont] + blocks, axis=1)
    return _save_split(dense, sparse, labels, out_dir, split=split)


def preprocess_movielens(npz_path: str, out_dir: str,
                         num_users: Optional[int] = None,
                         seed: Optional[int] = None):
    """MovieLens NCF stream: an `.npz` with `user_input`, `item_input`,
    `labels` (the reference reads exactly this from its offline
    negative-sampling prep, `process_all_movie_data`,
    `load_data.py:321-341`). Items shift by `num_users` (default: max
    user id + 1; ml-25m: 162,541 users + 59,047 items = the `movie`
    spec's 221,588-row shared table); dense is empty (NCF is
    embeddings-only)."""
    z = np.load(npz_path)
    users = np.asarray(z["user_input"]).reshape(-1).astype(np.int64)
    items = np.asarray(z["item_input"]).reshape(-1).astype(np.int64)
    labels = np.asarray(z["labels"]).reshape(-1).astype(np.float32)
    assert len(users) == len(items) == len(labels)
    nu = int(num_users if num_users is not None else users.max() + 1)
    assert users.max() < nu, (users.max(), nu)
    sparse = np.stack([users, items + nu], axis=1)
    dense = np.zeros((len(users), 0), np.float32)
    return _save_split(dense, sparse, labels, out_dir, seed=seed)
