"""The step's share of the card's f32 peak over the window: the tower's
operations a step of the window (the driver's `step_flops`, from
`reference/<model>.py` `flops`: forward and backward a training step, the
forward a scored request) times the steps, over the window's seconds and
67 TFLOP/s (TF32 is off)."""

from portbench import roofline


def read(r):
    if not r.steps:
        return None
    return 100.0 * r.step_flops * r.steps / r.window_s \
        / roofline.F32_FLOPS_PER_S
