from herald_tpu_torch.models.base import (
    ModelDef,
    available_models,
    bce_with_logits,
    get_model,
    register,
)

# model modules self-register on import
from herald_tpu_torch.models import wdl as _wdl  # noqa: F401
