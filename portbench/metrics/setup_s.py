"""Seconds from the process's start to the window's: the torch import,
the kernel library's load (a build in a checkout's first run), the
inputs made from the seed, the program's state and the warm-up."""


def read(run):
    return run.setup_s
