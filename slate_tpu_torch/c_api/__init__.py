"""C API builder (counterpart of ``slate_tpu/c_api/__init__.py``;
reference include/slate/c_api + src/c_api).

``build_library()`` compiles ``slate_c.c`` into
``build/libslate_tpu_torch_c.so`` at the repository root (linking
libpython for embedding), so C/C++/Fortran programs can call the flat
``slate_*`` functions of ``slate_c.h``; the work runs in the embedded
interpreter through ``bridge.py``. The library is built from source at
first use, rebuilt when a source is newer, and never committed. A
failed build, or a missing compiler, raises.

The include and link flags come from ``python3-config --embed`` where
it is on the path, else from ``sysconfig`` (``INCLUDEPY``, ``LIBDIR``,
``LDLIBRARY``). The embedded interpreter boots that installation's
prefix, not a virtual environment: a C program must hand it the
module path of the calling environment, for example
``PYTHONPATH=$(python -c "import os, sys; print(os.pathsep.join(sys.path))")``
(``embed_env()`` returns such an environment).
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys
import sysconfig
from typing import Dict, List, Tuple

_HERE = pathlib.Path(__file__).parent
_ROOT = _HERE.parent.parent
_SRC = _HERE / "slate_c.c"

HEADER = _HERE / "slate_c.h"
#: where build_library() puts the shared library (gitignored)
SO = _ROOT / "build" / "libslate_tpu_torch_c.so"


def _embed_flags() -> Tuple[List[str], List[str]]:
    libdir = sysconfig.get_config_var("LIBDIR")
    rpath = [f"-Wl,-rpath,{libdir}"] if libdir else []
    if shutil.which("python3-config"):
        cflags = subprocess.run(
            ["python3-config", "--includes"], check=True,
            capture_output=True, text=True).stdout.split()
        ldflags = subprocess.run(
            ["python3-config", "--ldflags", "--embed"], check=True,
            capture_output=True, text=True).stdout.split()
        return cflags, ldflags + rpath
    lib = sysconfig.get_config_var("LDLIBRARY") or ""
    name = lib[3:].split(".so")[0].split(".a")[0] if lib.startswith(
        "lib") else "python" + sysconfig.get_config_var("VERSION")
    ldflags = [f"-L{libdir}", f"-l{name}"] + (
        sysconfig.get_config_var("LIBS") or "").split()
    return [f"-I{sysconfig.get_config_var('INCLUDEPY')}"], ldflags + rpath


def build_library(force: bool = False) -> pathlib.Path:
    """Build build/libslate_tpu_torch_c.so (if missing or stale);
    returns its path. Raises RuntimeError when the build fails."""
    newest_src = max(_SRC.stat().st_mtime, HEADER.stat().st_mtime)
    if SO.exists() and not force and SO.stat().st_mtime > newest_src:
        return SO
    SO.parent.mkdir(parents=True, exist_ok=True)
    cflags, ldflags = _embed_flags()
    tmp = SO.with_suffix(".so.%d" % os.getpid())
    try:
        subprocess.run(
            ["gcc", "-O2", "-shared", "-fPIC", str(_SRC), "-o", str(tmp),
             f"-I{_HERE}", *cflags, *ldflags],
            check=True, capture_output=True, timeout=180, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("slate_tpu_torch C API build: no gcc") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"slate_tpu_torch C API build failed:\n{e.stderr}") from e
    os.replace(tmp, SO)         # atomic: a concurrent build never sees half
    return SO


def embed_env(base: Dict[str, str] = None) -> Dict[str, str]:
    """`base` (default: this process's environment) with PYTHONPATH
    holding this interpreter's sys.path, for a C program whose embedded
    interpreter must import the port and torch."""
    env = dict(os.environ if base is None else base)
    path = [p for p in sys.path if p]
    old = env.get("PYTHONPATH")
    env["PYTHONPATH"] = os.pathsep.join(path + ([old] if old else []))
    return env
