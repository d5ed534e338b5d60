"""Mean host time per step of the batches' copies to the device: the
`step/to_device` spans (`train/modules.train_step`, the four
`*_batch_to_device` calls from the loaders' NumPy arrays) of the window,
summed, over the window's steps."""

from benchmark import spans


def read(inp):
    return spans.ms_per_step(inp, "step/to_device")
