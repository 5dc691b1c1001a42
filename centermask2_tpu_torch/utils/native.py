"""Build a host C++ library with ``g++`` at first use (the RLE mask ops
of ``evaluation/native/maskapi.cpp``, the s2d packer of
``data/native/s2d.cpp``).

The library goes to ``<build_root>/<name>-<hash>/lib<name>.so``, keyed by
the hash of the source and the flags, and with ``-march=native`` of the
CPU that g++ resolves it to (``.gitignore`` lists ``_build/``).
Processes that build it at once (pytest-xdist workers, several processes
sharing a checkout) serialize on an fcntl lock, and the compiler writes
a temporary file that is renamed into place, so no process loads half a
library. A failed build raises: there is no fallback. ``load_library``
builds and loads a library once a process, under one lock, and keeps
it: later calls take no lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

_LIBS: Dict[Tuple, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()

# where the port's host libraries are built (``.gitignore`` lists it)
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"


def _native_arch() -> str:
    """What ``-march=native`` means on this host, as g++ resolves it: a
    library built for one host's CPU must not load on another's."""
    res = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True)
    return " ".join(ln.split()[-1] for ln in res.stdout.splitlines()
                    if ln.strip().startswith("-march="))


def library_path(src: Path, flags: Sequence[str], build_root: Path,
                 name: str) -> Path:
    h = hashlib.sha256(Path(src).read_bytes())
    h.update(" ".join(flags).encode())
    if "-march=native" in flags:
        h.update(_native_arch().encode())
    return Path(build_root) / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_library(src: Path, flags: Sequence[str], build_root: Path,
                  name: str) -> Path:
    """Compile ``src`` with ``g++ flags`` unless the library exists;
    returns its path. Raises ``RuntimeError`` if g++ fails."""
    import fcntl

    so = library_path(src, flags, build_root, name)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "build.lock", "a+") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if so.exists():  # another process finished it meanwhile
                return so
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
            os.close(fd)
            try:
                res = subprocess.run(["g++", *flags, "-o", tmp, str(src)],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"g++ failed to build {src}:\n"
                                       f"{res.stderr}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return so


def load_library(src: Path, flags: Tuple[str, ...], build_root: Path,
                 name: str, declare: Callable[[ctypes.CDLL], None]
                 ) -> ctypes.CDLL:
    """The loaded library of ``build_library(src, flags, build_root,
    name)``, with ``declare(lib)`` (its functions' ``argtypes`` and
    ``restype``) run once; built and loaded at the first call of this
    process for those arguments, under a lock, then kept."""
    key = (src, flags, build_root, name)
    lib = _LIBS.get(key)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(key)
            if lib is None:
                lib = ctypes.CDLL(str(build_library(src, flags, build_root,
                                                    name)))
                declare(lib)
                _LIBS[key] = lib
    return lib
