"""setup_s: seconds from the process's start to the window's first
query: imports, the graph from the seed, compile, the cell's warm-up."""


def read(run):
    return run.setup_s
