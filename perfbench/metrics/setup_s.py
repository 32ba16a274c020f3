"""Seconds from the process's start to the window: imports, the program's
set-up, the inputs made from the seed, warm-up and the first steps."""


def read(run):
    return run.setup_s
