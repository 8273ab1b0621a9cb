"""Build the CUDA sources under `repro_torch/csrc/` with nvcc and load them.

Each `csrc/<name>.cu` compiles on first use into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), and is
loaded with `ctypes`.  All missing libraries build in parallel: one nvcc
process per source, all started together.  Libraries are cached under
``<checkout>/build/repro_torch/`` (listed in `.gitignore`), keyed by a hash
of the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source or header rebuilds.  Set
``REPRO_TORCH_BUILD_DIR`` to build elsewhere.

Nothing here runs at import time: the CPU tests import every module.
Each library built or loaded counts one ``"build/<name>"`` event in
`repro_torch.core.tracing.TRACE_COUNTS`, which `no_retrace()` watches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "library"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("tree_sep_update", "lsh_bucket_accept", "pairwise_argmin",
           "d2_update", "flash_attention", "flash_attention_bwd")
# --split-compile=0: nvcc and ptxas optimise a source's kernels on all
# cores at once (flash_attention_bwd.cu's nine instances build in about
# half the time).
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
          "--split-compile=0", "-Xptxas", "--split-compile=0")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_report: dict[str, dict] = {}


def _build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch cannot be built on this machine")


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _build_dir() / f"{name}_{digest}.so"


def build_all() -> dict[str, dict]:
    """Compile every missing library (in parallel) and load all of them.

    Returns ``{name: {"path", "seconds", "ptxas"}}``: the library, the
    build's wall time (0.0 when it came from the cache) and nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills).  Raises
    RuntimeError with nvcc's output when a build fails.
    """
    with _lock:
        todo = {name: _lib_path(name) for name in SOURCES
                if name not in _libs}
        procs = {}
        t0 = time.perf_counter()
        for name, path in todo.items():
            if path.exists():
                continue
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, path)
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n{out}")
            path.with_suffix(".log").write_text(out)
            os.replace(tmp, path)
        seconds = time.perf_counter() - t0
        # Imported here: `repro_torch.core` imports this package.
        from repro_torch.core.tracing import count_trace

        for name, path in todo.items():
            _libs[name] = ctypes.CDLL(str(path))
            count_trace(f"build/{name}")
            log = path.with_suffix(".log")
            _report[name] = {
                "path": str(path),
                "seconds": seconds if name in procs else 0.0,
                "ptxas": log.read_text() if log.exists() else "",
            }
        return dict(_report)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it on first use."""
    if name not in _libs:
        build_all()
    return _libs[name]
