"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch header, so
``nvcc`` compiles it in seconds into ``lib<name>-<digest>.so`` under the build
directory (``build/repro_torch_kernels/`` at the repository root). The digest
covers the source text, every header under ``csrc/`` and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it is.
Nothing is built when this module is imported: :func:`load` builds at first
use, and :func:`build_all` starts one ``nvcc`` per source, all together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"

#: Hopper only: keep the ``a`` (``wgmma``/``setmaxnreg`` exist only there).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
#: seconds spent in nvcc per source in this process (0.0: found built)
build_seconds: Dict[str, float] = {}
#: what ``-Xptxas -v`` said per source built in this process
build_logs: Dict[str, str] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def sources() -> tuple:
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "are built from source at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: the file name
    carries a digest of the source, of every ``csrc/*.cuh`` header (a
    source may include any of them) and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[tuple]:
    """Start nvcc for one source unless its library is already built;
    returns (process, tmp path, target, t0) or None."""
    out = _target(name)
    if out.exists():
        build_seconds.setdefault(name, 0.0)
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started: tuple) -> None:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = log
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent build sees all or nothing


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every source (or ``names``), one ``nvcc`` each, all started
    together; returns the seconds each took."""
    names = tuple(names) if names is not None else sources()
    started = {n: _start(n) for n in names}
    for n, st in started.items():
        if st is not None:
            _finish(n, st)
    return {n: build_seconds[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib
