"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``.  Libraries are named by a hash of their source and of every
header in ``csrc/`` (``common.cuh``), built at first use into
``build/kernels/`` at the repository root (listed in ``.gitignore``), and
rebuilt whenever the source or a header changes.  Nothing here
runs at import time: the CPU tests import every module of the port.

Each kernel wrapper counts its launches in :data:`LAUNCHES` (one per
launch, nowhere else; a CUDA graph's replay adds the launches its capture
recorded, :func:`add_launches`), so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: SMs of an H100 SXM, the default of the kernels' host-side plans
H100_SXM_SMS = 132

#: the head_dims the attention kernels (flash, paged) take, as the
#: wrappers state it when they refuse one
HEAD_DIM_RULE = "16..256, a multiple of 8"

#: kernel launches per kernel name since the last reset
LAUNCHES: Dict[str, int] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def add_launches(counts: Dict[str, int]) -> None:
    """Add a CUDA graph's launches per replay (``serve/staged.py``: a
    replay runs the kernels its capture recorded without calling their
    wrappers), or, negated, take back the capture's, which ran none."""
    for name, n in counts.items():
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n


def reset_launch_counts() -> None:
    LAUNCHES.clear()


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SM count of a CUDA device (read once per device)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def head_dim_ok(hd: int) -> bool:
    """Whether the flash and paged kernels take ``hd``: a bf16 row of a
    multiple of 8 values is whole 16-byte chunks, the unit both kernels
    load, and 256 bounds their tiles and registers."""
    return hd % 8 == 0 and 16 <= hd <= 256


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str) -> Optional[tuple]:
    """Start ``nvcc`` for one source unless its library exists; returns
    ``(process, tmp_path, final_path)`` or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job: Optional[tuple]) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)           # atomic: concurrent builders agree
    return log


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources in parallel (one ``nvcc`` each, all
    started together); returns each build's compiler log ("" if the
    library was already built)."""
    names = list(names)
    with _lock:
        jobs = {n: _start_build(n) for n in names}
        return {n: _finish_build(n, job) for n, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _libs[name] = lib
    return lib
