from herald_tpu_torch.data.datasets import (
    DATASETS,
    DatasetSpec,
    dataset_for_model,
    frequency_remap,
    load_dataset,
    synthetic_ctr_data,
)
from herald_tpu_torch.data.loaders import Dataloader, LookaheadDataloader
