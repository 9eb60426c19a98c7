from herald_tpu_torch.data.datasets import (
    DATASETS,
    PORT_DATASETS,
    DatasetSpec,
    MultiHotSpec,
    dataset_for_model,
    frequency_remap,
    load_dataset,
    synthetic_ctr_data,
    synthetic_multihot_data,
)
from herald_tpu_torch.data.loaders import Dataloader, LookaheadDataloader
from herald_tpu_torch.data.prefetch import DevicePrefetcher
from herald_tpu_torch.data.preprocess import (
    preprocess_avazu,
    preprocess_criteo,
    preprocess_criteo_search,
)
