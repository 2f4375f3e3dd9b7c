"""setup_s: process start to the window's first step (imports, the
network's draw, the session's build, the graphs' capture, the presim and
one warm unit)."""


def read(record):
    return record["setup_s"]
