"""Embedding lookup and dedup (port of `herald_tpu/ops/embedding.py`).

`embedding_lookup` reads rows through K1 (`ops/kernels/gather.py`),
`segment_sum_grads` sums duplicate-id gradients through K3
(`ops/kernels/segment.py`) and `scatter_add_rows` adds rows through K3 and
K2 (`ops/kernels/scatter.py`): the CUDA kernels on the card, their plain
versions on the CPU. `unique_static` is the training steps' dedup, at a
static size and with no wait for the card; `unique_fill`, under it, is
JAX's `jnp.unique` at a static size with any fill, which may cut ids off
(the GCN's pull mode), through `ops/kernels/unique.py`'s kernel where it
takes the ids.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from herald_tpu_torch.ops.kernels import (embedding_gather, hot_onehot_push,
                                          rows_scatter_add, unique)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows: table [R, D], ids [...] -> [..., D]; ids outside
    [0, R) give zero rows."""
    out = embedding_gather(table, ids.reshape(-1).contiguous())
    return out.reshape(*ids.shape, table.shape[1])


def dedup_ids(ids: torch.Tensor, size: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-size dedup.

    Returns (unique_ids [size], inverse [ids.numel()], num_unique []).
    The unique ids are sorted; padding slots repeat the largest id and
    `num_unique` counts the real slots. `torch.unique` has a dynamic size,
    so on the card this waits once for the device to learn it.
    """
    uniq, inv = torch.unique(ids.reshape(-1), sorted=True,
                             return_inverse=True)
    num = uniq.numel()
    if num > size:
        raise ValueError(f"{num} unique ids exceed the static size {size}")
    if num < size:
        uniq = torch.cat([uniq, uniq[-1:].expand(size - num)])
    return uniq, inv.reshape(-1), torch.tensor(num, dtype=torch.int32,
                                               device=ids.device)


def unique_fill(ids: torch.Tensor, size: int, fill: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's `jnp.unique(ids, size=size, fill_value=fill,
    return_inverse=True)`: (uniq [size], the sorted distinct ids, cut to
    `size` or padded with `fill`; inv [N] int64, each id's rank among the
    distinct ids, `size` or more for an id cut off). Every shape is fixed,
    so nothing waits for the card. Ids the kernel takes (int32 on a card,
    at most `unique.CAPACITY`) go through its one launch; any others (the
    CPU, int64, more ids) through the library chain `unique_fill_ref`.
    The two give the same bits."""
    flat = ids.reshape(-1)
    if unique.fits(flat):
        return unique.unique_fill(flat, size, fill)
    return unique.unique_fill_ref(flat, size, fill)


def unique_static(ids: torch.Tensor, size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's `jnp.unique(ids, size=size, return_inverse=True,
    fill_value=-1)` (`herald_tpu/train/engine.py:301-302`) at a size that
    holds every id: (uniq [size], the sorted distinct ids then -1 in every
    other slot; inv [N] int64, each id's slot)."""
    n = ids.numel()
    if size < n:
        raise ValueError(f"unique_static: size {size} < {n} ids")
    return unique_fill(ids, size, -1)


def segment_sum_grads(grad: torch.Tensor, inverse: torch.Tensor,
                      num_segments: int, rows: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Reduce duplicate-id gradients: grad [N, D] by inverse [N] ->
    [num_segments, D] in grad's dtype, as `jax.ops.segment_sum` returns.
    The sum runs through K3 in f32 and is rounded once; JAX adds in the
    grad dtype (for bf16, one rounding per duplicate). With `rows` (int32
    [N]) position i's gradient is grad's row rows[i] (a pooled bag's), read
    through K3's map."""
    flat = grad.reshape(-1, grad.shape[-1])
    return hot_onehot_push(inverse.reshape(-1), flat, num_segments,
                           rows).to(grad.dtype)


def scatter_add_rows(table: torch.Tensor, rows: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """table [R, D] += values [U, D] at rows [U], duplicate rows allowed,
    in place (JAX: `table.at[rows].add(values)`, a new table). Duplicates
    are summed through K3 in f32, then each distinct row is written once
    through K2: one rounding per row where JAX rounds per duplicate. Rows
    outside [0, R) are dropped."""
    uniq, inv = torch.unique(rows.reshape(-1), return_inverse=True)
    summed = hot_onehot_push(inv, values.reshape(-1, values.shape[-1]),
                             uniq.numel())
    return rows_scatter_add(table, uniq, summed)
