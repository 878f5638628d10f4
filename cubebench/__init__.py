"""The benchmark of spectral_cube_tpu_torch on one NVIDIA card: cells of a
configuration (``configs/``) under a traffic mix (``mixes/``), end-to-end
metrics from the host clock and the device, per-layer metrics
(``metrics/``) from spans and the profiler's trace, and a plain reference
(``reference/``) that decides whether the timed path was correct.  Run
``python cubebench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout."""

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent
_LOADED = {}


def found(folder, name):
    """The module of ``cubebench/<folder>/<name>.py`` (a name may hold
    dots), loaded once from its file, or None where there is no such
    file.  Everything that belongs to one mix operation, metric or stage
    is found this way, by the name the data gives it."""
    path = HERE / folder / f"{name}.py"
    key = str(path)
    if key not in _LOADED:
        if not path.is_file():
            return None
        spec = importlib.util.spec_from_file_location(
            f"cubebench.{folder.replace('/', '.')}.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]
