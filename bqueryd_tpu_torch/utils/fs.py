"""Filesystem helpers (capability match for reference bqueryd/tool.py:1-27)."""

import os
import shutil


def mkdir_p(path):
    """Idempotent recursive mkdir."""
    os.makedirs(path, exist_ok=True)


def rm_file_or_dir(path):
    """Remove a file, directory tree, or symlink if it exists; no-op otherwise."""
    if path is None or not os.path.lexists(path):
        return
    if os.path.islink(path):
        os.unlink(path)
    elif os.path.isdir(path):
        shutil.rmtree(path)
    else:
        os.remove(path)
