"""Mean time per step the program waited on its loaders' queues: the
`loader/get` spans (`data/loader._prefetched`, on the thread that takes the
batches) of the window, summed, over the window's steps."""

from benchmark import spans


def read(inp):
    return spans.ms_per_step(inp, "loader/get")
