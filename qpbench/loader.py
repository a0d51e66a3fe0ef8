"""The harness's pieces found by name: ``qpbench/<kind>/<name>.py``.

A configuration names its ``family``, a traffic mix its ``pattern``, a
cell's own file its ``entry``, and ``BENCHMARK.json`` each metric; each is
a module of its own under ``families/``, ``patterns/``, ``entries/`` or
``metrics/``, so that a later one is a new file. A metric split by the
end-to-end metric it moves (``<quantity>.<split>``, such as
``device_idle_pct.track``) reads with ``metrics/<quantity>.py`` where it
has no file of its own.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
_LOADED = {}


def module_path(kind: str, name: str, root: Path = HERE) -> Path:
    """The file of ``name`` under ``root/<kind>/``."""
    path = root / kind / f"{name}.py"
    if not path.is_file() and "." in name:
        path = root / kind / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"qpbench: no {kind[:-1]} {name!r} "
                                f"({root / kind / (name + '.py')})")
    return path


def load_module(kind: str, name: str, root: Path = HERE):
    """The module of ``name`` under ``root/<kind>/``, loaded once."""
    path = module_path(kind, name, root)
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"qpbench_{kind}_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
