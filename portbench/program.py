"""The system under test, `herald_tpu_torch`, as the drivers call it: its
run configuration from a configuration file, and its state built from the
benchmark's own weights (`gen`), which the reference makes again by
itself. Nothing here is measured."""

from __future__ import annotations

import torch

from portbench import gen

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def herald_config(cfg: dict, batch_size=None):
    from herald_tpu_torch.config import HeraldConfig
    return HeraldConfig(
        model=cfg["model"], batch_size=batch_size or cfg["batch_size"],
        embedding_dim=cfg["embedding_dim"],
        table_dtype=DTYPES[cfg["table_dtype"]], optimizer=cfg["optimizer"],
        learning_rate=cfg["learning_rate"],
        cache_limit_ratio=cfg["cache_limit_ratio"])


def check_shapes(eng, cfg: dict, ref) -> None:
    """The engine's table is the configuration's."""
    if eng.num_rows != cfg["table_rows"] or eng.width != ref.width(cfg):
        raise RuntimeError(
            f"the program's table is [{eng.num_rows}, {eng.width}], the "
            f"configuration's [{cfg['table_rows']}, {ref.width(cfg)}]")


def base_state(eng, cfg: dict, ref, seed: int):
    """A `TrainState` of the benchmark's weights: the table drawn by
    `gen.fill_table`, the tower by `gen.tower`, zero slots, step 0."""
    from herald_tpu_torch.train.engine import TrainState
    check_shapes(eng, cfg, ref)
    dev = eng.device
    table = torch.empty((eng.padded_rows, eng.width),
                        dtype=DTYPES[cfg["table_dtype"]], device=dev)
    gen.fill_table(table, eng.num_rows, seed)
    dense = gen.tower(ref.shapes(cfg), cfg["tower"]["init_std"], seed, dev)
    return TrainState(
        table=table,
        table_slots={k: torch.zeros_like(table)
                     for k in eng.embed_opt.slot_names},
        dense=dense,
        dense_slots={k: eng.dense_opt.init_slots(v)
                     for k, v in dense.items()},
        step=torch.zeros((), dtype=torch.int32, device=dev))


def cached_state(eng, cfg: dict, ref, seed: int):
    """A `CachedTrainState` of the same weights, an empty cache and no
    pinned tier."""
    from herald_tpu_torch.train.cached import CachedTrainState
    base = base_state(eng, cfg, ref, seed)
    W, dev = eng.width, eng.device
    return CachedTrainState(
        *base,
        cache=torch.zeros((eng.cache_rows, 2 * W), dtype=torch.float32,
                          device=dev),
        hot_table=torch.zeros((1, W), dtype=base.table.dtype, device=dev),
        hot_slots={k: torch.zeros((1, W), dtype=torch.float32, device=dev)
                   for k in eng.embed_opt.slot_names})


def captures(eng) -> int:
    """Step graphs the engine has captured so far (0 off the card)."""
    return eng.graphs.captures if eng.graphs is not None else 0
