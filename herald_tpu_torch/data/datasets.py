"""Dataset specs, synthetic CTR data and the preprocessed-dataset loader.

The port's own copy of the numpy functions it needs from
`herald_tpu/data/datasets.py` (the port imports nothing of the JAX
package). The same seed gives byte-identical arrays in both packages;
`tests/test_torch_data.py` pins it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_sparse: int              # number of sparse (categorical) fields
    num_dense: int               # number of dense (numeric) fields
    num_embed_rows: int          # embedding table height
    # table indices ordered by descending ID-reuse frequency
    table_frequency_order: Tuple[int, ...]
    default_top_k: int


DATASETS: Dict[str, DatasetSpec] = {
    "criteo": DatasetSpec(
        "criteo", 26, 13, 33_762_577,
        (9, 13, 22, 20, 12, 21, 17, 14, 24, 3, 5, 10, 16,
         15, 19, 2, 4, 11, 7, 25, 23, 18, 8, 1, 0, 6), 20),
    "avazu": DatasetSpec(
        "avazu", 18, 4, 9_449_445,
        (1, 2, 4, 5, 15, 7, 6, 16, 12, 0, 17, 8, 14, 10, 9, 11, 13, 3), 17),
    "criteosearch": DatasetSpec(
        "criteosearch", 17, 3, 14_859_910,
        (0, 11, 3, 4, 5, 14, 1, 6, 2, 13, 16, 9, 8, 10, 12, 7, 15), 16),
    "movie": DatasetSpec(
        "movie", 2, 0, 221_588,
        (0, 1), 2),
    "adult": DatasetSpec(
        "adult", 8, 813, 400,
        (0, 1, 2, 3, 4, 5, 6, 7), 8),
}


@dataclasses.dataclass(frozen=True)
class MultiHotSpec(DatasetSpec):
    """A dataset whose samples read a bag of ids from each of its tables
    (multi-hot). `num_sparse` counts the positions of a sample; the bags lie
    contiguous in table order, table t's holding `bag_sizes[t]` ids of its
    `table_sizes[t]` rows, each offset by the rows of the tables before it
    in one global id space of `num_embed_rows` rows."""
    table_sizes: Tuple[int, ...] = ()
    bag_sizes: Tuple[int, ...] = ()


# MLPerf Training's DLRM-DCNv2 on Criteo 1TB (the MLCommons reference,
# recommendation_v2/torchrec_dlrm: --num_embeddings_per_feature and
# --multi_hot_sizes): 26 tables, 204,184,588 rows, 214 ids a sample
CRITEO1TB_TABLE_SIZES = (
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000, 40000000,
    40000000, 590152, 12973, 108, 36)
CRITEO1TB_BAG_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1,
                       1, 12, 100, 27, 10, 3, 1, 1)

# the port's datasets that the JAX package has not: multi-hot ones
PORT_DATASETS: Dict[str, MultiHotSpec] = {
    "criteo1tb": MultiHotSpec(
        "criteo1tb", sum(CRITEO1TB_BAG_SIZES), 13,
        sum(CRITEO1TB_TABLE_SIZES), tuple(range(sum(CRITEO1TB_BAG_SIZES))),
        len(CRITEO1TB_BAG_SIZES), table_sizes=CRITEO1TB_TABLE_SIZES,
        bag_sizes=CRITEO1TB_BAG_SIZES),
}


def dataset_for_model(model_name: str) -> DatasetSpec:
    """Model names follow the reference convention `<arch>_<dataset>`."""
    ds = model_name.rsplit("_", 1)[-1]
    spec = DATASETS.get(ds) or PORT_DATASETS.get(ds)
    if spec is None:
        raise ValueError(f"unknown dataset suffix in model name {model_name!r}")
    return spec


def table_sizes_within(spec: MultiHotSpec, num_rows: Optional[int] = None
                       ) -> np.ndarray:
    """The rows of each of `spec`'s tables, or with `num_rows` below the
    spec's total, each table's rows capped at one hash cap, the largest
    that fits them all in `num_rows` (tables below the cap keep their
    rows): at 124,184,588 rows criteo1tb's five 40,000,000-row tables
    hold 24,000,000 each and the other 21 keep their published rows."""
    sizes = np.asarray(spec.table_sizes, np.int64)
    if num_rows is None or num_rows >= sizes.sum():
        return sizes
    if num_rows < sizes.size:
        raise ValueError(f"{num_rows} rows cannot hold {sizes.size} tables")
    lo, hi = 1, int(sizes.max())
    while lo < hi:
        cap = (lo + hi + 1) // 2
        if int(np.minimum(sizes, cap).sum()) <= num_rows:
            lo = cap
        else:
            hi = cap - 1
    return np.minimum(sizes, lo)


def synthetic_multihot_data(spec: MultiHotSpec, num_samples: int,
                            seed: int = 0, zipf_a: float = 1.2,
                            num_rows: Optional[int] = None):
    """Multi-hot CTR data: each table's bag draws Zipf ids over the
    table's rows (`table_sizes_within(spec, num_rows)`), offset into one
    global id space; dense features are standard normals and labels come
    from a hidden linear model over them and hashed id signs, as
    `synthetic_ctr_data` makes them.

    Returns (dense float32 [N, num_dense], sparse int64 [N, num_sparse],
    the bags contiguous in table order, labels float32 [N, 1])."""
    rng = np.random.default_rng(seed)
    sizes = table_sizes_within(spec, num_rows)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    sparse = np.empty((num_samples, spec.num_sparse), dtype=np.int64)
    p = 0
    for t, bag in enumerate(spec.bag_sizes):
        raw = rng.zipf(zipf_a, size=(num_samples, bag))
        sparse[:, p:p + bag] = offsets[t] + (raw - 1) % sizes[t]
        p += bag
    dense = rng.standard_normal((num_samples, spec.num_dense)).astype(
        np.float32)
    w = rng.standard_normal(spec.num_dense).astype(np.float32)
    id_sign = ((sparse * 2654435761 % 97) / 48.0 - 1.0).mean(axis=1)
    logits = dense @ w + 2.0 * id_sign \
        + 0.1 * rng.standard_normal(num_samples)
    labels = (logits > np.median(logits)).astype(np.float32)
    return dense, sparse, labels.reshape(-1, 1)


def synthetic_ctr_data(
    spec: DatasetSpec,
    num_samples: int,
    seed: int = 0,
    zipf_a: float = 1.2,
    num_rows: Optional[int] = None,
    learnable: bool = True,
    session_len: int = 1,
):
    """CTR-shaped data with a skewed (Zipf) ID distribution; each field
    owns a disjoint slice of one global ID space.

    Returns (dense, sparse, labels):
        dense  float32 [N, num_dense]
        sparse int64   [N, num_sparse] global row IDs
        labels float32 [N, 1]
    """
    if num_rows is None:
        num_rows = spec.num_embed_rows
    rng = np.random.default_rng(seed)
    n_fields = spec.num_sparse
    # per-field ID ranges from a Dirichlet split of the table height
    props = rng.dirichlet(np.ones(n_fields) * 2.0)
    sizes = np.maximum((props * num_rows).astype(np.int64), 2)
    # the min-clamp can push the total past num_rows; shave the excess off
    # the largest fields
    excess = int(sizes.sum()) - num_rows
    while excess > 0:
        i = int(np.argmax(sizes))
        take = min(excess, int(sizes[i]) - 2)
        if take <= 0:
            break
        sizes[i] -= take
        excess -= take
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    assert sizes.sum() <= num_rows, (sizes.sum(), num_rows)

    sparse = np.empty((num_samples, n_fields), dtype=np.int64)
    for f in range(n_fields):
        raw = rng.zipf(zipf_a, size=num_samples)
        local = (raw - 1) % sizes[f]
        sparse[:, f] = offsets[f] + local

    if session_len > 1:
        # sessionized streams: the first half of the fields repeat the
        # session head's values
        n_user = max(n_fields // 2, 1)
        heads = (np.arange(num_samples) // session_len) * session_len
        sparse[:, :n_user] = sparse[heads][:, :n_user]

    dense = rng.standard_normal((num_samples, max(spec.num_dense, 0))).astype(
        np.float32)

    if learnable:
        # labels from a hidden linear model over dense feats + hashed ID
        # signs, so training has signal and AUC is meaningful
        w = rng.standard_normal(max(spec.num_dense, 1)).astype(np.float32)
        id_sign = ((sparse * 2654435761 % 97) / 48.0 - 1.0).mean(axis=1)
        logits = (dense @ w[: dense.shape[1]] if dense.shape[1] else 0.0)
        logits = logits + 2.0 * id_sign + 0.1 * rng.standard_normal(num_samples)
        labels = (logits > np.median(logits)).astype(np.float32)
    else:
        labels = rng.integers(0, 2, size=num_samples).astype(np.float32)
    return dense, sparse.astype(np.int64), labels.reshape(-1, 1)


# ----------------------------------------------------------------------
# Real preprocessed data (the reference pipeline's .npy layout)
# ----------------------------------------------------------------------

_NPY_LAYOUT = {
    # dataset -> (dense, sparse, label) file basenames of the reference's
    # processed cache (load_data.py process_* functions)
    "criteo": ("train_dense_feats.npy", "train_sparse_feats.npy",
               "train_labels.npy"),
    "avazu": ("train_dense_feats.npy", "train_sparse_feats.npy",
              "train_labels.npy"),
    "criteosearch": ("train_dense_feats.npy", "train_sparse_feats.npy",
                     "train_labels.npy"),
}


def load_dataset(
    spec: DatasetSpec,
    path: Optional[str] = None,
    num_samples: int = 100_000,
    seed: int = 0,
    num_rows: Optional[int] = None,
):
    """Load the preprocessed dataset from `path`, falling back to
    synthetic data when `path` is None or holds no such files.

    `path` holds the reference pipeline's processed `.npy` files (read
    memory-mapped), or for "movie" its `train.npz` (user_input,
    item_input, labels). A multi-hot spec has no file layout here: its
    data is always `synthetic_multihot_data`."""
    if isinstance(spec, MultiHotSpec):
        return synthetic_multihot_data(spec, num_samples, seed=seed,
                                       num_rows=num_rows)
    if path and spec.name in _NPY_LAYOUT:
        files = [os.path.join(path, f) for f in _NPY_LAYOUT[spec.name]]
        if all(os.path.exists(f) for f in files):
            dense = np.load(files[0], mmap_mode="r")
            sparse = np.load(files[1], mmap_mode="r")
            labels = np.load(files[2], mmap_mode="r").reshape(-1, 1)
            return np.asarray(dense, np.float32), \
                np.asarray(sparse, np.int64), np.asarray(labels, np.float32)
    if path and spec.name == "movie":
        npz_path = os.path.join(path, "train.npz")
        if os.path.exists(npz_path):
            with np.load(npz_path) as train:
                users = np.asarray(train["user_input"],
                                   np.int64).reshape(-1, 1)
                items = np.asarray(train["item_input"],
                                   np.int64).reshape(-1, 1)
                labels = np.asarray(train["labels"],
                                    np.float32).reshape(-1, 1)
            sparse = np.concatenate([users, items], axis=1)
            dense = np.zeros((len(labels), max(spec.num_dense, 0)),
                             np.float32)
            return dense, sparse, labels
    return synthetic_ctr_data(spec, num_samples, seed=seed,
                              num_rows=num_rows)


def frequency_remap(sparse_ids: np.ndarray, num_rows: int):
    """Permute the ID space so the most frequent IDs are [0, 1, 2, ...].

    Returns (remapped_ids, perm) with perm[old_id] = new_id; unseen IDs
    fill the tail in old order. Used by the pinned hot tier
    (HeraldConfig.pinned_rows: rows [0, P) are the hot block). Apply the
    same perm to ALL splits (train + eval) of a run.
    """
    ids, counts = np.unique(sparse_ids.reshape(-1), return_counts=True)
    order = np.argsort(-counts, kind="stable")
    perm = np.full(num_rows, -1, np.int64)
    perm[ids[order]] = np.arange(len(ids), dtype=np.int64)
    unseen = np.flatnonzero(perm < 0)
    perm[unseen] = np.arange(len(ids), num_rows, dtype=np.int64)
    return perm[sparse_ids], perm
