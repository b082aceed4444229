"""Build the CUDA sources under `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` is compiled by nvcc into a shared library with a
plain C interface, at first use, into `_build/` beside this file (listed in
.gitignore). The library's file name carries a digest of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# sm_90a: Hopper with its architecture-specific instructions. -fmad=false keeps
# every product and sum separately rounded, as PyTorch's elementwise kernels
# round them, so a kernel and its plain version decide termination alike.
# -Xptxas -v: each kernel's registers, spills and static shared memory, in
# the log `build` returns.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> tuple[float, str] | None:
    """Compile `csrc/<name>.cu` unless its current library exists. Returns
    the build's seconds and nvcc's output, or None when nothing had to be
    built."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    log = proc.stdout.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, log


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def _kernel_name(mangled: str) -> str:
    """A mangled kernel name's readable part: the function and its template
    arguments (`_ZN<ns><name>IL...E...` of an anonymous namespace)."""
    pos, parts = 3 if mangled.startswith("_ZN") else 2, []
    while pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group(0)
        pos += len(digits)
        parts.append(mangled[pos : pos + int(digits)])
        pos += int(digits)
    name = next((p for p in reversed(parts) if "GLOBAL__N" not in p), mangled)
    if mangled[pos : pos + 1] == "I":
        name += "<" + ",".join(re.findall(r"L[bi](\d+)E", mangled[pos : mangled.find("EE", pos) + 2])) + ">"
    return name


def ptxas_report(log: str) -> list[str]:
    """One line per kernel of a `-Xptxas -v` log: its name, registers, spill
    bytes and static shared memory."""
    lines, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = _kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and fn:
            lines.append(f"{fn}: {m.group(1)} registers, {spill}, {m.group(2) or 0} B static smem")
            fn = None
    return lines
