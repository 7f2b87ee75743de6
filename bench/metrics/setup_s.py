"""setup_s: process start to the window's start (host clock), s."""


def read(run):
    return run.setup_s
