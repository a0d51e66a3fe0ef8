"""setup_s: process start to the first timed call: imports, the kernels'
library (built on a checkout's first run, loaded after), drawing the inputs
on the device, the warm-up calls and, on a trajectory, its cold step."""


def read(run):
    return run.setup_s
