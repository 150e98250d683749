"""``torch.cuda.max_memory_allocated()`` over the whole run, set-up
included, in GiB (read from the CUDA allocator by the harness)."""

UNIT = "GiB"
BETTER = "lower"
SOURCE = "device_trace"


def read(run):
    return run.peak / 2 ** 30
