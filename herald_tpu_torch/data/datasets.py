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


def dataset_for_model(model_name: str) -> DatasetSpec:
    """Model names follow the reference convention `<arch>_<dataset>`."""
    ds = model_name.rsplit("_", 1)[-1]
    if ds not in DATASETS:
        raise ValueError(f"unknown dataset suffix in model name {model_name!r}")
    return DATASETS[ds]


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
    item_input, labels)."""
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
