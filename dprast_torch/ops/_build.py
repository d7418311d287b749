"""Build and load the port's CUDA kernels.

The sources in `dprast_torch/csrc/` are compiled at first use by `nvcc`
for Hopper (``sm_90a``), one `nvcc` per source in parallel, and linked
into one shared library with a plain C interface, loaded with `ctypes`.
The library lands in ``build/dprast_torch/`` at the root of the
checkout, named by a hash of the sources, so an edited source never
loads a stale library.  The compiler's output (register and
shared-memory use per kernel, from ``-Xptxas -v``) is kept beside it in a
``.log`` file.

Several processes may build at once (the workers of a process group that
start with nothing built): each compiles into files named by its own
process id and renames the finished library and log into place, so no
two of them ever write one file and a reader sees a whole library or
none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dprast_torch"
_SOURCES = ("fwd_splat.cu", "band_fold.cu", "band_unfold.cu",
            "bwd_gather.cu", "coords.cu", "frame_gather.cu",
            "slot_prep.cu", "epilogue.cu", "xla_path.cu")
# headers the sources include: not compiled on their own, but part of the
# library's name, so that an edited header rebuilds it
_HEADERS = ("poses.cuh", "slots.cuh", "twofloat.cuh")

# B1 and B4 keep one tile window of at most 128 x 128 entries in dynamic
# shared memory: B4's holds fp32 (64 KB), B1's 64-bit fixed point as two
# 32-bit planes (128 KB)
MAX_WINDOW_BYTES = 128 * 128 * 4
MAX_FIXED_WINDOW_BYTES = 2 * MAX_WINDOW_BYTES

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _library_path() -> Path:
    digest = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        digest.update(name.encode())
        digest.update((_CSRC / name).read_bytes())
    return _BUILD_DIR / f"libdprast_torch_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists.
    One `nvcc` per source, all started together, then one link."""
    so = _library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC"]
    objs = [_BUILD_DIR / f"{tag}.{name}.o" for name in _SOURCES]
    cmds = [[_nvcc(), *flags, "-Xptxas", "-v", "-c", str(_CSRC / name),
             "-o", str(obj)] for name, obj in zip(_SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    tmp = so.with_name(f"{tag}.so.tmp")
    link = [_nvcc(), *flags, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(cmd, out) for cmd, out, proc in zip(cmds, outs, procs)
              if proc.returncode != 0]
    if not failed:
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        cmds.append(link)
        outs.append(proc.stdout)
        if proc.returncode != 0:
            failed = [(link, proc.stdout)]
    log = so.with_name(f"{tag}.log.tmp")
    log.write_text("".join(
        " ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs)))
    os.replace(log, so.with_suffix(".log"))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            " ".join(cmd) + "\n" + out[-4000:] for cmd, out in failed))
    os.replace(tmp, so)
    return so


def load():
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f32 = ctypes.c_float
        lib.dprast_fwd_splat.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32,
                                         i64, i32, i32, i32, i32, i32, i32,
                                         i32, vp, vp]
        lib.dprast_fwd_splat.restype = i32
        lib.dprast_band_fold.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                         i32, vp]
        lib.dprast_band_fold.restype = i32
        lib.dprast_band_unfold.argtypes = [vp, vp, i32, i32, i32, i32, i32,
                                           vp]
        lib.dprast_band_unfold.restype = i32
        lib.dprast_bwd_gather.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32,
                                          i32, i64, i64, i32, i32, i32, i32,
                                          i32, i32, i32, i32, i32, i32, i32,
                                          i32, i32, vp]
        lib.dprast_bwd_gather.restype = i32
        lib.dprast_coords.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32,
                                      i32, i32, i32, i32, i32, i32, i32, i32,
                                      i32, i32, i32, f32, f32, f32, vp]
        lib.dprast_coords.restype = i32
        lib.dprast_frame_gather.argtypes = [vp, i64, i32, vp, i32, vp, vp,
                                            i32, i32, i32, i64, vp]
        lib.dprast_frame_gather.restype = i32
        lib.dprast_slot_prep.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                         i32, i32, i32, vp]
        lib.dprast_slot_prep.restype = i32
        lib.dprast_epilogue_rows.argtypes = [vp, vp, i64, vp, vp, vp, i64,
                                             f32, f32, f32, vp, i32, vp, i32,
                                             i32, i32, i32, i32, i64, i32, vp]
        lib.dprast_epilogue_rows.restype = i32
        lib.dprast_epilogue_tile.argtypes = [vp, i64, i64, vp, vp, vp, vp,
                                             i64, f32, f32, f32, vp, i32, i32,
                                             vp, vp, i32, i32, i32, i32, i32,
                                             vp]
        lib.dprast_epilogue_tile.restype = i32
        lib.dprast_epilogue_points.argtypes = [vp, i32, vp, vp, vp, i64, f32,
                                               f32, f32, vp, i32, i32, vp, vp,
                                               vp, vp, vp, i32, i32, i32, i32,
                                               i32, vp]
        lib.dprast_epilogue_points.restype = i32
        lib.dprast_epilogue_poses.argtypes = [vp, i32, i32, vp, vp, vp, vp, vp,
                                              i32, i32, i32, i32, vp]
        lib.dprast_epilogue_poses.restype = i32
        sizes = ctypes.POINTER(ctypes.c_int)
        lib.dprast_xla_neighbours.argtypes = [vp, vp, vp, vp, i64, vp, i64,
                                              vp, i32, vp, vp, vp, i32, i32,
                                              i32, i32, sizes, i32, vp]
        lib.dprast_xla_neighbours.restype = i32
        lib.dprast_xla_scatter.argtypes = [vp, vp, i64, vp, i32, vp, vp, i64,
                                           i32, i64, i32, vp]
        lib.dprast_xla_scatter.restype = i32
        lib.dprast_xla_gather.argtypes = [vp, vp, vp, vp, i64, vp, i64, vp, vp,
                                          i32, i32, i32, sizes, i32, vp]
        lib.dprast_xla_gather.restype = i32
        lib.dprast_error_string.argtypes = [i32]
        lib.dprast_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def error_string(err: int) -> str:
    return load().dprast_error_string(err).decode()
