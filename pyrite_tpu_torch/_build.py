"""Build and load the CUDA kernels of ``csrc/``.

At first CUDA use, one ``nvcc`` per ``csrc/*.cu`` compiles it for
``sm_90a`` (all of them at once, in parallel), and a last ``nvcc`` links the
objects into one shared library with a plain C interface, which ``ctypes``
loads. The library goes to ``_build/<hash of the sources>/``, so a change to
a source or header rebuilds. Nothing here links against PyTorch: pointers
and the stream are passed as integers.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
# --fmad=false keeps products rounded before they are added (no fused
# multiply-add), as in the plain PyTorch version the kernels are held to;
# -Xptxas=-v reports each kernel's registers and spills (build_log)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lib = None
# the compilers' output of the last build this process made ("" if it
# loaded a library built before)
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
_DE = [_I, _F]  # the DE march's step cap and over-relaxation factor
# ... ending in the scene's DE shape count, which picks the kernel
# instantiation, and the march pass's t
# the scene and programs every shading kernel takes first (kernels_dense.
# _scene_args): sheet, meta, code and per-launch values, then the baked
# program tables, the lanes' wavelengths, the tables' grid, first
# wavelength and steps per nm
_SCENE = [_P] * 7 + [_P] * 3 + [_I, _F, _F]
_BOUNCE = _SCENE + [_P] * 22 + [_I] * 5 + [_P]
_NEE = _SCENE + [_P] * 9 + [_I] * 4 + [_F, _I, _P]
_WIDE = [_P] * 6 + [_I]  # the mesh scene's tables and its leaf size
_RECORD = [_P] * 11  # a kRecord bounce's camera vertex and its chain factors
_LAMP = _SCENE + [_P] * 17 + [_I] * 6 + [_P]  # the lamp kernels
# what the kProg instantiations read (kernels_dense.prog_args), last before
# the stream: ten tables, two program counts, the program stack's depth
# and the scene's form (kernels_dense.FORM_*)
_PROG = [_P] * 10 + [_I] * 4
# argument lists of the extern "C" launchers in csrc/bounce.cu,
# csrc/wide_bvh.cu, csrc/march_de.cu and csrc/draws.cu; a march pass ends in
# its work counter (an unsigned 64-bit word) and the stream
_SIGNATURES = {
    "pyrite_dense_bounce": _BOUNCE + _PROG + [_P],
    "pyrite_dense_nee": _NEE + _PROG + [_P],
    "pyrite_wide_bounce": _BOUNCE + _WIDE + _PROG + [_P],
    "pyrite_wide_nee": _NEE + _WIDE + _PROG + [_P],
    "pyrite_dense_bounce_record": _BOUNCE + _RECORD + _PROG + [_P],
    "pyrite_wide_bounce_record": _BOUNCE + _WIDE + _RECORD + _PROG + [_P],
    "pyrite_dense_lamp": _LAMP + _PROG + [_P],
    "pyrite_wide_lamp": _LAMP + _WIDE + _PROG + [_P],
    "pyrite_program_colors": _SCENE + [_P] * 6 + [_I] * 4 + _PROG + [_P],
    "pyrite_dense_shadow": [_P] * 8 + [_I] * 2 + [_P, _P],
    "pyrite_wide_closest": [_P] * 4 + [_I] + [_P] * 12 + [_I, _P],
    "pyrite_wide_shadow": [_P] * 4 + [_I] + [_P] * 5 + [_I, _P],
    "pyrite_march_de": [_P] * 6 + _DE + [_P] * 2 + [_I, _P, _P],
    "pyrite_de_march_bounce": [_P] * 6 + [_I] * 2 + _DE + [_P, _P],
    "pyrite_de_march_shadow": [_P] * 8 + [_I] * 3 + _DE + [_P, _P],
    "pyrite_de_march_query_shadow": [_P] * 7 + [_I] * 2 + _DE + [_P, _P],
    "pyrite_philox_draws": [_U, _U, _I, _I, _U, _U, _U, _I, _I, _I] + [_P] * 7 + [_U, _I, _I, _P],
    "pyrite_bounce_occupancy": [_I, _I, _P],
    "pyrite_bounce_smem": [_I, _I, _I],
    "pyrite_bounce_record_smem": [_I, _I, _I],
    "pyrite_nee_smem": [_I, _I],
    "pyrite_draws_smem": [_I],
    "pyrite_gather_smem": [_I, _I, _I],
    "pyrite_photon_gather": [_P] * 33 + [_I] * 11 + [_F] * 6 + [_P],
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def find_nvcc() -> str | None:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), DEFAULT_CUDA_HOME):
        if home:
            candidate = os.path.join(home, "bin", "nvcc")
            if os.access(candidate, os.X_OK):
                return candidate
    return shutil.which("nvcc")


def library_path() -> str:
    digest = hashlib.sha256()
    for path in sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_ROOT, digest.hexdigest()[:16], "libpyrite_kernels.so")


def load():
    """The loaded kernel library, built first if needed. Raises RuntimeError
    when nvcc is missing or the build fails."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not os.path.exists(so):
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
                f"{DEFAULT_CUDA_HOME} and PATH): the CUDA kernels cannot be built"
            )
        out_dir = os.path.dirname(so)
        os.makedirs(out_dir, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=out_dir)
        units = [p for p in sources() if p.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in units]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, unit],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for unit, obj in zip(units, objs)
        ]
        outputs = [p.communicate()[0] for p in procs]
        build_log = "\n".join(outputs)
        failed = [(p.args, out) for p, out in zip(procs, outputs) if p.returncode != 0]
        if not failed:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", os.path.join(tmp, "lib.so"), *objs],
                capture_output=True, text=True,
            )
            if link.returncode != 0:
                failed = [(link.args, link.stdout + link.stderr)]
        if failed:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(
                "nvcc failed:\n" + "\n".join(f"{' '.join(a)}\n{out}" for a, out in failed)
            )
        os.replace(os.path.join(tmp, "lib.so"), so)
        shutil.rmtree(tmp, ignore_errors=True)
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
