from herald_tpu_torch.train.engine import Engine, TrainState
