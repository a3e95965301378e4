"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for Hopper into its own shared library under `build/repro_torch/`
at the root of the checkout, then loaded with `ctypes`.  The library's
file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  No PyTorch
headers are included, which keeps a build at a few seconds.

`LAUNCHES` counts kernel launches per public op; a wrapper adds one
where it launches its kernel and nowhere else.  ptxas reports each
kernel's registers and spills (`-Xptxas=-v`); the report is kept beside
the library and read back by `ptxas_report`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNELS = ("ralt_score", "decode_attention", "decode_attention_int8",
           "flash_attention", "ssd_scan")

LAUNCHES = {"ralt_update": 0, "ralt_record": 0, "decode_attention": 0,
            "decode_attention_int8": 0, "decode_attention_int8_f32": 0,
            "flash_attention": 0, "ssd_scan": 0}


# Analytic FLOPs (two a multiply-add) of the work a kernel would have done
# for calls on the meta device, where a wrapper returns only its outputs'
# shapes; a dry run (`launch/plan.py`) resets and reads them.
META_FLOPS = {"decode_attention": 0, "flash_attention": 0, "ssd_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cuda_home}/bin); the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> list[Path]:
    """Compile every missing library of `names`, one `nvcc` per source,
    all started together.  Raises with nvcc's stderr on failure."""
    todo = [(n, _lib_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errors = []
        for name, out, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu "
                              f"(rc {proc.returncode}):\n{err}")
            else:
                out.with_suffix(".ptxas.txt").write_text(err)
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
    return [_lib_path(n) for n in names]


def ptxas_report(name: str) -> dict:
    """{kernel (mangled name): {"registers": n, "stack_frame": bytes,
    "spill_stores": bytes, "spill_loads": bytes}} from ptxas's report on
    `csrc/<name>.cu`."""
    (path,) = build((name,))
    text = path.with_suffix(".ptxas.txt").read_text()
    report, kernel = {}, None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            kernel = m.group(1)
            report[kernel] = {}
        elif kernel and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", line)):
            report[kernel].update(stack_frame=int(m.group(1)),
                                  spill_stores=int(m.group(2)),
                                  spill_loads=int(m.group(3)))
        elif kernel and (m := re.search(r"Used (\d+) registers", line)):
            report[kernel]["registers"] = int(m.group(1))
    return report


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu` (built on first use)."""
    (path,) = build((name,))
    lib = ctypes.CDLL(str(path))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code (the value
    of `cudaGetLastError()` right after its launches)."""
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({rc})")
