from herald_tpu_torch.utils import metrics
