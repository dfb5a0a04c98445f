"""Filesystem browsing for the web API's file browser (counterpart of
``libertem_tpu/io/fs.py``): a listing of one directory, a stat, and
when a path cannot be used, the nearest accessible ancestor as the
:class:`FSError`'s ``alternative``, so the GUI can recover there.
"""
from __future__ import annotations

import os
from pathlib import Path


class FSError(Exception):
    """Filesystem access failure with a machine-readable ``code`` and
    a recovery ``alternative`` path.  All constructor values ride
    ``args``, so the exception pickles across process boundaries."""

    def __init__(self, msg, code, alternative=None):
        super().__init__(msg, code, alternative)
        self.code = code
        self.alternative = alternative


def _accessible(path: Path) -> bool:
    try:
        ok = os.path.isdir(path) and os.access(
            path, os.R_OK | os.X_OK
        )
        if ok:
            Path(path).resolve()
            os.listdir(path)
        return ok
    except (PermissionError, OSError):
        return False


def stat_path(path):
    """``os.stat`` of ``path`` (user-expanded, resolved), raising
    FSError with a recovery alternative."""
    try:
        return Path(path).expanduser().resolve().stat()
    except FileNotFoundError:
        raise FSError(
            code="NOT_FOUND",
            msg=f"path {path} could not be found",
            alternative=str(_get_alt_path(path)),
        )
    except PermissionError as e:
        raise FSError(
            code="PERMISSION_ERROR",
            msg=str(e),
            alternative=str(_get_alt_path(path)),
        )


def get_fs_listing(path):
    """Directory listing for the GUI file browser: stat'ed dirs and
    files (inaccessible entries skipped: broken symlinks, races,
    permission holes), mount points (psutil, where it imports) and
    bookmark places.  Raises FSError with a recovery alternative for
    an unusable path."""
    import stat as stat_mod

    from .utils import get_owner_name

    try:
        abspath = Path(path).expanduser().resolve()
    except PermissionError as e:
        raise FSError(
            code="PERMISSION_ERROR", msg=str(e),
            alternative=str(_get_alt_path(path)),
        )
    if not abspath.is_dir():
        raise FSError(
            code="NOT_FOUND",
            msg=f"path {path} could not be found",
            alternative=str(_get_alt_path(path)),
        )
    if not _accessible(abspath):
        raise FSError(
            code="ACCESS_DENIED",
            msg=f"access to {path} was denied",
            alternative=str(_get_alt_path(path)),
        )
    dirs, files = [], []
    for name in [".."] + sorted(os.listdir(abspath)):
        full = os.path.join(abspath, name)
        try:
            s = os.stat(full)
            owner = get_owner_name(full, s)
        except (FileNotFoundError, PermissionError):
            continue
        except OSError:
            owner = "<Unknown>"
            s = None
        if s is None:
            continue
        entry = {"name": name, "stat": s, "owner": owner}
        (dirs if stat_mod.S_ISDIR(s.st_mode) else files).append(entry)
    try:
        import psutil
        drives = [
            part.mountpoint
            for part in psutil.disk_partitions()
            if part.fstype != "squashfs"
        ]
    except Exception:
        drives = ["/"]
    places = [
        {"key": "home", "title": "Home", "path": str(Path.home())},
    ]
    return {
        "path": str(abspath),
        "files": files,
        "dirs": dirs,
        "drives": drives,
        "places": places,
    }


def _get_alt_path(path) -> Path:
    """Nearest accessible ancestor of ``path`` (home directory when
    the walk runs out of parents — e.g. a nonexistent drive root)."""
    cur = Path(path).expanduser()
    try:
        cur = cur.resolve()
    except PermissionError:
        pass
    while not _accessible(cur):
        try:
            cur = cur.parents[0].resolve()
        except IndexError:
            return Path.home()
        except PermissionError:
            continue
    return cur
