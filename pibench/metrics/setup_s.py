"""Seconds from the process's start to the window's start: imports,
the card's start-up, the kernel library (built on a checkout's first
run), the table made on the card, the warm-up."""


def read(run):
    return run.setup_s
