"""Build and load the port's CUDA kernels: nvcc into a shared library
with a plain C interface, loaded with ctypes.

Each `.cu` file under `csrc/` becomes one library, which may hold several
entry points. It is built at first use, from the sources in the checkout,
into `drt_tpu_torch/_build/<hash>/`. The hash covers every file under
`csrc/` and the flags, so an edit to a shared header builds every library
anew and unchanged sources load the earlier build. Nothing is built when
the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# -fmad=false: the exact tracer variant follows the plain PyTorch
# version's rounding, which a*b+c contracted into one FMA would not.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built on a machine with the "
                       "CUDA toolkit")


def sources() -> list[str]:
    """The `.cu` files under csrc/, one library each."""
    return sorted(p.name for p in CSRC_DIR.glob("*.cu"))


def build_key() -> str:
    """Hash of the flags and of every file under csrc/ (name and bytes)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.rglob("*")):
        if path.is_file():
            h.update(str(path.relative_to(CSRC_DIR)).encode() + b"\0")
            h.update(path.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    """Where the library of `source` (a file under csrc/) is built."""
    return BUILD_DIR / build_key() / (Path(source).stem + ".so")


def log_path(source: str) -> Path:
    """The compiler's report (registers, spills) of `source`'s build."""
    return library_path(source).with_suffix(".log")


def build(source: str) -> Path:
    """Compile csrc/<source> unless its build exists; returns the .so path.
    The compiler's report is kept beside it (`log_path`)."""
    out = library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def build_all() -> dict[str, Path]:
    """Build every library of csrc/, one nvcc each, all at once."""
    from concurrent.futures import ThreadPoolExecutor

    names = sources()
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source>, once per process."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib
