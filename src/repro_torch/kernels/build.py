"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface and is compiled
by ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Headers shared
by several sources live in ``kernels/csrc/``, which is on the include path.
Libraries go to ``build/kernels/`` at the repository root, named by a hash
of the source, the headers beside it, the shared headers and the flags, so
an edited source builds again and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["KernelLibrary", "build_all", "build_dir"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SHARED_INCLUDE = Path(__file__).resolve().parent / "csrc"


def build_dir() -> Path:
    """``build/kernels`` at the repository root (listed in .gitignore)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source with nvcc on first use")


class KernelLibrary:
    """One CUDA source, its shared library and the ctypes handle.
    ``include``: the shared headers' folder (another checkout's, to build
    that checkout's source as it was)."""

    def __init__(self, name: str, source: Path,
                 include: Path = SHARED_INCLUDE):
        self.name = name
        self.source = Path(source)
        self.include = Path(include)
        self._lib: ctypes.CDLL | None = None
        self.ptxas_log = ""

    def _digest(self) -> str:
        h = hashlib.sha256(self.source.read_bytes())
        for folder in (self.source.parent, self.include):
            for header in sorted(folder.glob("*.cuh")):
                h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    @property
    def path(self) -> Path:
        return build_dir() / f"{self.name}-{self._digest()}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start nvcc unless the library for this source already exists."""
        if self.path.exists():
            return None
        build_dir().mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(self.include), "-o", str(tmp),
               str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.ptxas_log = out
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(tmp, self.path)

    def load(self) -> ctypes.CDLL:
        """Build if needed, then dlopen (cached on this object)."""
        if self._lib is None:
            self.finish_build(self.start_build())
            self._lib = ctypes.CDLL(str(self.path))
        return self._lib


def _libraries() -> list[KernelLibrary]:
    from repro_torch.kernels.eplb_place import ops as eplb_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gating_topk import ops as gating_ops
    from repro_torch.kernels.grouped_gemm import ops as grouped_gemm_ops
    from repro_torch.kernels.plan_solve import ops as plan_solve_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_scan_ops

    return [grouped_gemm_ops.LIBRARY, grouped_gemm_ops.LIBRARY_Q8,
            grouped_gemm_ops.LIBRARY_BWD_F32,
            ssd_scan_ops.LIBRARY, ssd_scan_ops.LIBRARY_BWD,
            gating_ops.LIBRARY, flash_ops.LIBRARY, flash_ops.LIBRARY_BWD,
            flash_ops.LIBRARY_BWD_MMA, plan_solve_ops.LIBRARY, eplb_ops.LIBRARY]


def build_all() -> dict[str, str]:
    """Build every kernel library of the port in parallel; returns the
    ``ptxas -v`` report of each source that was compiled now."""
    libs = _libraries()
    procs = [lib.start_build() for lib in libs]
    for lib, proc in zip(libs, procs):
        lib.finish_build(proc)
    for lib in libs:
        lib.load()
    return {lib.name: lib.ptxas_log for lib in libs}
