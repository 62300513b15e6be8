"""Build a kernel's CUDA sources into a shared library and load it.

Each kernel package keeps its sources under its own ``csrc/`` and describes
itself with a ``Kernel``: that directory, a library name and the C
signatures of its entry points.  ``nvcc`` compiles the package's
``csrc/*.cu`` for ``sm_90a`` into one shared library per kernel with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds), so an edit to one kernel never rebuilds another.  A package with
several sources compiles them in parallel, one ``nvcc`` each, then links
them.  Libraries land
in ``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.  Headers shared by
several kernels (``kernels/common/*.cuh``: the Hopper primitives) are on
every build's include path and in every library's hash, so an edit to
one rebuilds each kernel that includes it.  Nothing is built at import:
the first launch builds.  A failed build raises with the compiler's
output.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
COMMON = Path(__file__).resolve().parent / "common"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P, I, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One kernel's library: ``csrc`` holds its sources, ``name`` names the
    library file, ``signatures`` maps each C entry point to its
    (argtypes, restype)."""
    csrc: Path
    name: str
    signatures: Dict[str, Tuple[Sequence, object]]


_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources(kern: Kernel) -> list:
    """The kernel's own sources and headers, then the shared headers."""
    return (sorted(kern.csrc.glob("*.cu")) + sorted(kern.csrc.glob("*.cuh"))
            + sorted(COMMON.glob("*.cuh")))


def library_path(kern: Kernel) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(kern):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{kern.name}-{h.hexdigest()[:16]}.so"


def build(kern: Kernel) -> Path:
    """Compile the sources unless this exact build exists; return the
    library path.  The compiler's output (``-Xptxas -v``: registers, shared
    memory and spills per kernel) is kept beside it as ``.log``."""
    out = library_path(kern)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = [s for s in sources(kern) if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [os.path.join(tmpdir, f"{s.stem}.o") for s in cu]
        with concurrent.futures.ThreadPoolExecutor(len(cu)) as pool:
            logs = list(pool.map(lambda so: _nvcc(kern, ["-c", "-o", so[1], str(so[0])]),
                                 zip(cu, objs)))
        tmp = os.path.join(tmpdir, out.name)
        logs.append(_nvcc(kern, ["-shared", "-o", tmp, *objs]))
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def _nvcc(kern: Kernel, args: list) -> str:
    """Run nvcc with the shared flags; raise with its output on failure."""
    res = subprocess.run([nvcc(), *NVCC_FLAGS, f"-I{COMMON}", *args], capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {kern.name} ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    return res.stdout + res.stderr


def load(kern: Kernel) -> ctypes.CDLL:
    """Build if needed, load once, and declare the C signatures (without
    ``argtypes`` ctypes would pass each pointer as a 32-bit int)."""
    lib = _libs.get(kern.name)
    if lib is None:
        lib = ctypes.CDLL(str(build(kern)))
        for fn, (argtypes, restype) in kern.signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        _libs[kern.name] = lib
    return lib
