"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
keyed by a hash of every source in `csrc/` and the flags, into
`ggrs_tpu_torch/_build/`, and loaded with `ctypes`. Nothing is built or
imported when this module is imported: the first `load` builds, and
`build` compiles several sources at once (one `nvcc` process each, all
started together). A missing `nvcc` or a failed compile raises
`KernelError`; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

from ..errors import KernelError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# every kernel source of the port, the order `chip_smoke.py` builds them in
KINDS = ("synctest_fused", "synctest_tiled", "resim_tick", "beam_rollout", "reduce_table")

# the kernel-library handles, one per source, loaded at first use
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise KernelError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        if path.suffix == ".cuh" or path.stem == name:
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all in parallel.
    Returns name -> library path; the compiler's report (registers, spills)
    is kept beside each library as `<lib>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, out in paths.items():
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise KernelError(f"no CUDA source {src}")
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failures = []
    for name, (tmp, proc) in procs.items():
        report, _ = proc.communicate()
        text = report.decode(errors="replace")
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu exited {proc.returncode}:\n{text}")
            continue
        paths[name].with_suffix(".so.log").write_text(text)
        os.replace(tmp, paths[name])
    if failures:
        raise KernelError("\n".join(failures))
    return paths


def build_report(name: str) -> str:
    """What ptxas said about a built library (registers, shared memory)."""
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


def ptxas_summary(report: str) -> List[str]:
    """One line per kernel of a ptxas report: its (mangled) name, registers
    and spill bytes."""
    lines, name, spills = [], "?", ""
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name, spills = entry.group(1), ""
        elif "spill stores" in line:
            spills = line.strip()
        else:
            used = re.search(r"Used (\d+) registers", line)
            if used:
                lines.append(f"{name}: {used.group(1)} registers; {spills}")
    return lines


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            raise KernelError(f"cannot load {path}: {exc}") from exc
        _LIBS[name] = lib
    return lib
