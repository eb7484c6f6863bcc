"""Files of the benchmark found by the names that ``BENCHMARK.json`` and
the data files give: a traffic mode's loop (``traffic/<mode>.py``), a
circuit kind on the port (``circuits/<kind>.py``) and in the plain
reference (``reference/circuits/<kind>.py``), and a metric's reader
(``metrics/<name>.py``).  A later cell adds such files and entries; no
file that is there needs an edit."""

from __future__ import annotations

import importlib.util
import os
import re
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
_loaded: dict = {}
_lock = threading.Lock()


def load(folder: str, name: str):
    """``benchmark/<folder>/<name>.py`` as a module, loaded once."""
    path = os.path.join(HERE, *folder.split("/"), name + ".py")
    with _lock:
        if path not in _loaded:
            if not os.path.isfile(path):
                raise FileNotFoundError(f"no {folder} named {name!r}: {path}")
            tag = re.sub(r"\W", "_", f"benchmark_{folder}_{name}")
            spec = importlib.util.spec_from_file_location(tag, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _loaded[path] = mod
        return _loaded[path]
