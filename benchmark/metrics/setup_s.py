"""setup_s: process start to the first measured call (imports, CUDA
context, the kernels' library, the inputs made on the card, warm-up; the
first run in a checkout also builds the kernels) (s)."""


def read(run):
    return run.setup_s
