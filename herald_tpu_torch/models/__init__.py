import dataclasses as _dc

from herald_tpu_torch.models.base import (
    ModelDef,
    available_models,
    bce_with_logits,
    get_model,
    register,
)

# model modules self-register on import
from herald_tpu_torch.models import dcn as _dcn  # noqa: F401
from herald_tpu_torch.models import dfm as _dfm  # noqa: F401
from herald_tpu_torch.models import dlrm as _dlrm  # noqa: F401
from herald_tpu_torch.models import linear as _linear  # noqa: F401
from herald_tpu_torch.models import misc as _misc  # noqa: F401
from herald_tpu_torch.models import wdl as _wdl  # noqa: F401

# the FAE variants: the same towers tagged for the hot/cold FAE engine
# (train/fae.py), as in herald_tpu/models/__init__.py:29-34
for _base, _fae in [("wdl_criteo", "fae_wdl_criteo"),
                    ("dfm_avazu", "fae_dfm_avazu"),
                    ("dcn_criteosearch", "fae_dcn_criteosearch"),
                    ("ncf_movie", "fae_ncf_movie")]:
    register(_dc.replace(get_model(_base), name=_fae, train_engine="fae"))
del _base, _fae
