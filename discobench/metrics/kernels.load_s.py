"""kernels.load_s: seconds spent building and loading the program's
compiled libraries (kernels: the spans kernels.build and kernels.load)
before the window's first job, in the set-up."""
from discobench.lib.spans import setup_seconds


def read(run):
    return setup_seconds(run, ("kernels.build", "kernels.load"))
