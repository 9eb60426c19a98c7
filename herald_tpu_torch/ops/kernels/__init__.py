"""Hand-written Hopper kernels of the port, one per TPU kernel of the JAX
package (`herald_tpu/ops/pallas/kernels.py`), K1's pooled form
`gather_pool_rows` for multi-hot bags and the dedup's `unique_fill`,
each with its plain PyTorch version and a launch counter. Built at first
use (`build.py`)."""

from herald_tpu_torch.ops.kernels.fm import (
    FMSecondOrder,
    fm_second_order,
    fm_second_order_backward,
    fm_second_order_bwd_ref,
    fm_second_order_ref,
)
from herald_tpu_torch.ops.kernels.gather import (
    embedding_gather,
    embedding_gather_ref,
    gather_pool_rows,
    gather_pool_rows_ref,
)
from herald_tpu_torch.ops.kernels.hot_gather import (
    hot_onehot_gather,
    hot_onehot_gather_add_,
    hot_onehot_gather_add_ref,
    hot_onehot_gather_ref,
)
from herald_tpu_torch.ops.kernels.scatter import (
    rows_scatter_add,
    rows_scatter_add_ref,
)
from herald_tpu_torch.ops.kernels.segment import (
    hot_onehot_push,
    hot_onehot_push_ref,
)
from herald_tpu_torch.ops.kernels.unique import unique_fill, unique_fill_ref

# every wrapper with a launch counter, for callers that reset and read them
KERNELS = {"embedding_gather": embedding_gather,
           "gather_pool_rows": gather_pool_rows,
           "hot_onehot_gather": hot_onehot_gather,
           "hot_onehot_gather_add_": hot_onehot_gather_add_,
           "hot_onehot_push": hot_onehot_push,
           "rows_scatter_add": rows_scatter_add,
           "fm_second_order": fm_second_order,
           "fm_second_order_backward": fm_second_order_backward,
           "unique_fill": unique_fill}
