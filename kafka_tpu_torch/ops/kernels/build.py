"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with `nvcc` for `sm_90a` into its own shared library
with a plain C interface, loaded with ctypes.  The build runs at first use,
from the repository's sources only, into `csrc/build/` (listed in
.gitignore); a library's file name carries a hash of its source, of the
shared headers (`csrc/*.cuh`) and of the flags, so an edited source or
header rebuilds and a stale library is never loaded.
`build_all` starts one nvcc per source together and waits for all of them.

Nothing here runs at import: the CPU test suite imports every module, and
this machine class may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
    "-Xptxas=-v",
]

# The C entry points and their ctypes signatures.  P = pointer, I = int,
# F = float; every entry point returns the CUDA error code as an int.
SIGNATURES: Dict[str, Dict[str, str]] = {
    "paged_decode": {"kafka_paged_decode_bf16": "PPPPPPPPIIIIIIIFP"},
    "flash_prefill": {"kafka_flash_prefill_bf16": "PPPPPIIIIIIIIFP",
                      "kafka_flash_prefill_bf16_tiles": "PPPPPIIIIIIIIFPI"},
    "paged_verify": {"kafka_paged_verify_bf16": "PPPPPPPPPIIIIIIIIFP"},
    "paged_decode_int8": {"kafka_paged_decode_int8": "PPPPPPPPPPIIIIIIIFP"},
    "fused_mlp": {"kafka_fused_mlp": "PPPPPPPPPPPIIIIFP"},
}
_CTYPE = {"P": ctypes.c_void_p, "I": ctypes.c_int, "F": ctypes.c_float}

# process-wide: a shared library is loaded once per process
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc")
        if os.environ.get("CUDA_HOME") else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from csrc/ at first use"
    )


def _lib_path(name: str) -> Path:
    """The library of csrc/<name>.cu, named by a hash of the source, every
    shared header in csrc/ (any of them may be included) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> str:
    """Wait for one build; returns nvcc's output (ptxas register report)."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: Sequence[str] = tuple(SIGNATURES)
              ) -> Tuple[float, Dict[str, str]]:
    """Compile every named kernel that is not built yet, all nvcc processes
    at once; returns (wall seconds, {name: nvcc output} of what was built)."""
    t0 = time.monotonic()
    procs: List = [(n, _start(n)) for n in names]
    logs: Dict[str, str] = {}
    try:
        for n, p in procs:
            logs[n] = _finish(n, p)
    finally:
        for _, p in procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    return time.monotonic() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    for fn_name, sig in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = [_CTYPE[c] for c in sig]
        fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib
