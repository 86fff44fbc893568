"""Finding a part of the benchmark by its name.

A configuration's scene kind, a writer and a metric each live in a file
of their own, `benchmark/<folder>/<name>.py`, which the harness loads by
the name that `BENCHMARK.json` or a configuration gives. Names may hold
`.` and `-`, so the file is loaded by its path, as a module of this
package.
"""

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def path(folder, name, ext=".py"):
    p = os.path.join(HERE, folder, name + ext)
    if not os.path.isfile(p):
        raise FileNotFoundError(f"no {folder} named {name!r}: {p}")
    return p


def load(folder, name):
    """The module of `benchmark/<folder>/<name>.py`."""
    mod_name = f"{__package__}.{folder}._named_{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name,
                                                  path(folder, name))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
