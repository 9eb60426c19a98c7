from herald_tpu_torch.launch.cli import main, run_training
