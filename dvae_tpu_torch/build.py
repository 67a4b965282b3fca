"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under the repo's
gitignored ``build/`` directory, named by a hash of its source and flags (so
an edited source rebuilds), and loaded with ctypes. The compiler writes to a
temporary file that is renamed into place, so a concurrent or interrupted
build never leaves a truncated library behind. Wrappers declare their own
``argtypes`` on the loaded library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "build"
# --split-compile=0 optimizes a source's kernels on all host cores at once:
# mh_chain.cu's 18 instantiations build in ~25 s instead of ~51 s, with the
# same registers, spills and times (tools/chain_ab.py, PERF.md)
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "--split-compile=0", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")
    return path


def _compile(source: str, so: pathlib.Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=so.parent, suffix=".so")
    os.close(fd)
    try:
        done = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_CSRC / source)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{done.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """The ctypes library built from ``csrc/<source>`` (compiled when its
    library is missing, loaded once per process)."""
    src = (_CSRC / source).read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"lib{pathlib.Path(source).stem}_{tag}.so"
    if not so.exists():
        _compile(source, so)
    return ctypes.CDLL(str(so))
