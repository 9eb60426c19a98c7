"""Embedding lookup and dedup (port of `herald_tpu/ops/embedding.py`).

`embedding_lookup` reads rows through K1 (`ops/kernels/gather.py`): the
CUDA kernel on the card, its plain version on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from herald_tpu_torch.ops.kernels import embedding_gather


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
