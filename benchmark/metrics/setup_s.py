"""setup_s: seconds from the start of the harness's module to the first
timed pass: imports, CUDA initialisation, loading (and in a fresh
checkout building) the program's libraries, writing and loading the
scene, the flatten and the warm-up pass."""


def read(run):
    return run.setup_s
