from herald_tpu_torch.optim.optimizers import (OPTIMIZERS, Optimizer,
                                               get_optimizer)
