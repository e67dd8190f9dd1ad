"""Environment overrides for the ``BQUERYD_TPU_*`` timing knobs.

An unset, empty or unparseable override falls back to the caller's
default: a mistyped value degrades to the shipped constant and never takes
a node down at construction time.  The names are the reference package's,
so one deployment configures both packages alike.
"""

import os


def env_num(name, default, cast=float):
    """The override ``name`` when set and parseable, ``default``
    otherwise."""
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    try:
        return cast(raw)
    except (ValueError, TypeError):
        return default
