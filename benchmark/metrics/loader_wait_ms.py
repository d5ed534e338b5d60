"""Mean time a step waited on the loaders: the harness's clock around each
`next` on the labeled and the unlabeled iterator, summed per step."""


def read(inp):
    waits = inp["loader_wait_s"]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
