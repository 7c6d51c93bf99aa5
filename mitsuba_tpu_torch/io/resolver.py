"""Search-path file resolution (the port's copy of
mitsuba_tpu/io/resolver.py) — parity with the reference `FileResolver`
(include/mitsuba/core/fresolver.h:40, fresolver.cpp): an ordered list of
directories tried in turn for relative paths, with a process-wide default
instance (the reference hangs one off each Thread; one module-level
instance suffices here — scene loading is single-threaded host code).

Used by the XML loader for meshes/textures/includes: absolute paths pass
through, relative paths resolve against (scene dir, appended paths, cwd,
$MITSUBA_TPU_PATH entries).
"""
from __future__ import annotations

import os


class FileResolver:
    def __init__(self, paths=None):
        self._paths: list[str] = list(paths or [])

    def prepend(self, path: str) -> None:
        self._paths.insert(0, path)

    def append(self, path: str) -> None:
        if path not in self._paths:
            self._paths.append(path)

    @property
    def paths(self):
        return tuple(self._paths)

    def resolve(self, name: str) -> str:
        """First existing match; falls back to the name unchanged (same
        contract as the reference's resolve())."""
        if os.path.isabs(name):
            return name
        for d in self._paths:
            cand = os.path.join(d, name)
            if os.path.exists(cand):
                return cand
        return name

    def resolve_all(self, name: str):
        if os.path.isabs(name):
            return [name] if os.path.exists(name) else []
        return [os.path.join(d, name) for d in self._paths
                if os.path.exists(os.path.join(d, name))]

    def clone(self) -> "FileResolver":
        return FileResolver(self._paths)


_default = None


def default_resolver() -> FileResolver:
    """Process-wide resolver: cwd + $MITSUBA_TPU_PATH (':'-separated)."""
    global _default
    if _default is None:
        _default = FileResolver(["."])
        for d in os.environ.get("MITSUBA_TPU_PATH", "").split(os.pathsep):
            if d:
                _default.append(d)
    return _default
