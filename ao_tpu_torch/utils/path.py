"""Filesystem helpers (port of ao_tpu/utils/path.py; reference:
pointcept/utils/path.py)."""

from __future__ import annotations

import os
import os.path as osp
from pathlib import Path


def is_filepath(x) -> bool:
    return isinstance(x, (str, Path))


def fopen(filepath, *args, **kwargs):
    if is_filepath(filepath):
        return open(filepath, *args, **kwargs)
    raise ValueError("`filepath` should be a string or a Path")


def check_file_exist(filename, msg_tmpl='file "{}" does not exist'):
    if not osp.isfile(filename):
        raise FileNotFoundError(msg_tmpl.format(filename))


def mkdir_or_exist(dir_name, mode=0o777):
    if dir_name == "":
        return
    os.makedirs(osp.expanduser(dir_name), mode=mode, exist_ok=True)


def symlink(src, dst, overwrite=True, **kwargs):
    if os.path.lexists(dst) and overwrite:
        os.remove(dst)
    os.symlink(src, dst, **kwargs)


def scandir(dir_path, suffix=None, recursive=False):
    """Yield the paths, relative to ``dir_path``, of the files under it
    whose names end with ``suffix`` (a string or a sequence of them; any
    file when None), skipping hidden entries."""
    if isinstance(suffix, (list, tuple)):
        suffix = tuple(suffix)
    root = dir_path

    def _scan(path):
        for entry in os.scandir(path):
            if not entry.name.startswith(".") and entry.is_file():
                rel = osp.relpath(entry.path, root)
                if suffix is None or rel.endswith(suffix):
                    yield rel
            elif recursive and entry.is_dir():
                yield from _scan(entry.path)

    return _scan(dir_path)
