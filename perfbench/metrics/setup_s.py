"""From the command's start to the window's start on rank 0: imports,
init, build and compile, weights, broadcast, checked and warm-up steps."""


def read(art):
    return art.lead["setup_s"]
