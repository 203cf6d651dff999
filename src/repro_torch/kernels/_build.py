"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
into a shared library under ``build/kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of the flags, the source, the
headers beside it and every header under ``kernels/include/`` (the shared
tiles, on the ``-I`` path), so an edited source or header is rebuilt and an
unchanged one is reused.  The build runs on first use, never at import: the CPU
tests import every module of the port on a machine without ``nvcc``.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -I src/repro_torch/kernels/include \\
         -o build/kernels/<name>-<hash>.so <src>

``build`` starts one ``nvcc`` per source, all at once, and returns each
compiler log (``-Xptxas -v``: registers, shared memory and spills per
kernel).  ``load`` builds if needed and returns the ``ctypes.CDLL``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
INCLUDE_DIR = Path(__file__).resolve().parent / "include"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(INCLUDE_DIR),
)

_LIBS: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def target_of(source: Path) -> Path:
    """The library a source builds into (content-addressed: the flags, the
    source, the headers beside it and every header under ``INCLUDE_DIR``)."""
    source = Path(source).resolve()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.read_bytes())
    headers = sorted(source.parent.glob("*.cuh")) + sorted(INCLUDE_DIR.rglob("*.cuh"))
    for header in headers:
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[Path]) -> Dict[Path, str]:
    """Compile every source not built yet, all in parallel; return the
    compiler log of each source (read back from disk for one built
    earlier).  Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    running = {}
    for src in sources:
        src = Path(src).resolve()
        target = target_of(src)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        running[src] = (target, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for src, (target, tmp, proc) in running.items():
        log, _ = proc.communicate()
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    logs = {}
    for src in sources:
        log_file = target_of(Path(src)).with_suffix(".log")
        logs[Path(src).resolve()] = log_file.read_text() if log_file.exists() else ""
    return logs


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, building it first if needed."""
    source = Path(source).resolve()
    lib = _LIBS.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(target_of(source)))
        _LIBS[source] = lib
    return lib
