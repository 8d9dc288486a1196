"""Console logging with indentation levels.

API-compatible with the reference logger (``pymes/log.py:4,20``): solvers emit
banner titles and per-iteration scalar telemetry (energy, dE, norms) through
``print_title`` / ``print_logging_info`` with an indent ``level`` and a
``debug_level`` threshold.  A module-level ``set_verbosity`` lets callers mute
everything (e.g. inside benchmark loops).

A copy of ``pymes_tpu/log.py``: the port carries its own so that it never
imports the JAX package.
"""

_VERBOSITY = 3


def set_verbosity(level: int) -> None:
    """Set the global debug level; messages with level > verbosity are muted."""
    global _VERBOSITY
    _VERBOSITY = level


def get_verbosity() -> int:
    return _VERBOSITY


def print_title(title_name, sep_symbol="=", level=1, debug_level=None):
    if debug_level is None:
        debug_level = _VERBOSITY
    if level > debug_level:
        return
    if level == 0:
        level = 1
    width = max(int(80 / level), len(title_name) + 2)
    shift = int((80 - width) / 2)
    pad = int((width - len(title_name)) / 2)
    print(" " * shift + sep_symbol * width)
    print(" " * (shift + pad) + title_name + " " * pad)
    print(" " * shift + sep_symbol * width)


def print_logging_info(*args, **kwargs):
    level = kwargs.get("level", 0)
    debug_level = kwargs.get("debug_level", _VERBOSITY)
    if level > debug_level or level > _VERBOSITY:
        return
    print("    " * level + "".join(str(i) for i in args))
