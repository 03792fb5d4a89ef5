"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface. It is compiled
at first use with ``nvcc`` into a shared library under ``_build/`` (listed in
``.gitignore``), named by a hash of its source, the ``csrc/*.cuh`` headers it
includes and the flags, so that an edit of any of them rebuilds it, and
loaded with ``ctypes``. Kernels launch on PyTorch's current
stream. There is no fallback: a missing ``nvcc``, a failed build or a
refused launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("megakernel_v4", "wavefront_step", "megakernel_grad")
# -fmad=false: no contraction of a*b+c into one FMA, so the kernel rounds
# op for op as its plain PyTorch version does on the card (whose elementwise
# ops are separate kernels); path-tracing near-ties otherwise flip paths.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# A block's shared memory on Hopper (232,448 bytes with the opt-in).
MAX_SMEM_BYTES = 232448

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled with the CUDA "
            "toolkit's nvcc at first use")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: dict) -> dict:
    """``path`` and every file under ``csrc/`` it includes with quotes,
    transitively: path → bytes."""
    if path not in seen:
        seen[path] = path.read_bytes()
        for inc in _INCLUDE.findall(seen[path]):
            _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path, src in sorted(_sources(CSRC_DIR / f"{name}.cu", {}).items()):
        h.update(path.name.encode() + b"\0" + src)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> dict[str, Path]:
    """Compile every kernel that is not built yet, one ``nvcc`` per source,
    all started together. Returns name → library path."""
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def _bind_megakernel_v4(lib: ctypes.CDLL) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.megakernel_v4_launch.argtypes = [i, p, i, p, p, i, i, i, i, i, i, i, i, i, i, p, p]
    lib.megakernel_v4_launch.restype = i
    lib.megakernel_v4_smem_bytes.argtypes = [i] * 6
    lib.megakernel_v4_smem_bytes.restype = i
    lib.megakernel_v4_error_string.argtypes = [i]
    lib.megakernel_v4_error_string.restype = ctypes.c_char_p


def _bind_wavefront_step(lib: ctypes.CDLL) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.wavefront_step_launch.argtypes = [i, p, i, p, p, i, i, i, i, i, i, p, i, i, i, i, i, p]
    lib.wavefront_step_launch.restype = i
    lib.wavefront_step_smem_bytes.argtypes = [i] * 6
    lib.wavefront_step_smem_bytes.restype = i
    lib.wavefront_step_state_cols.argtypes = []
    lib.wavefront_step_state_cols.restype = i
    lib.wavefront_step_error_string.argtypes = [i]
    lib.wavefront_step_error_string.restype = ctypes.c_char_p


def _bind_megakernel_grad(lib: ctypes.CDLL) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.megakernel_grad_launch.argtypes = [i, p, i, p, p, i, i, i, i, i, i, i, i, i, i,
                                           p, p, p, p, i, p, p]
    lib.megakernel_grad_launch.restype = i
    lib.megakernel_grad_smem_bytes.argtypes = [i] * 7
    lib.megakernel_grad_smem_bytes.restype = i
    lib.megakernel_grad_error_string.argtypes = [i]
    lib.megakernel_grad_error_string.restype = ctypes.c_char_p


_BINDERS = {"megakernel_v4": _bind_megakernel_v4, "wavefront_step": _bind_wavefront_step,
            "megakernel_grad": _bind_megakernel_grad}


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built and bound at first use."""
    with _LOCK:
        if name not in _LIBS:
            path = build_all((name,))[name]
            lib = ctypes.CDLL(str(path))
            _BINDERS[name](lib)
            _LIBS[name] = lib
        return _LIBS[name]


def _require_cuda(**tensors) -> torch.device:
    device = None
    for name, t in tensors.items():
        if not t.is_cuda or not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
        if device is not None and t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        device = t.device
    return device


def _check_smem(smem: int) -> None:
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"scene tables need {smem} B of shared memory, "
                         f"above the {MAX_SMEM_BYTES} B a block can have")


def launch_megakernel_v4(camv, seed: int, background, packed, out, *, n_pix,
                         max_depth, sizes, checker_depth, has_noise) -> None:
    """Launch ``megakernel_v4`` writing ``out`` [n_pix, 3]; raises on a
    refused launch."""
    device = _require_cuda(camv=camv, background=background, packed=packed, out=out)
    if out.numel() != 3 * n_pix:
        raise ValueError("out must hold n_pix x 3 floats")
    lib = load("megakernel_v4")
    n_sph, n_quad, n_mat, n_tex, n_med, n_box = (int(x) for x in sizes)
    _check_smem(lib.megakernel_v4_smem_bytes(n_sph, n_quad, n_mat, n_tex, n_med, n_box))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.megakernel_v4_launch(
        device.index, camv.data_ptr(), int(seed), background.data_ptr(),
        packed.data_ptr(), n_sph, n_quad, n_mat, n_tex, n_med, n_box,
        int(n_pix), int(max_depth), int(checker_depth), int(bool(has_noise)),
        out.data_ptr(), stream)
    if err:
        msg = lib.megakernel_v4_error_string(err).decode()
        raise RuntimeError(f"megakernel_v4 launch failed: {msg} (cudaError {err})")


def launch_wavefront_step(camv, seed: int, background, packed, state, *, n_slots,
                          k_bounces, max_depth, sizes, checker_depth, has_noise) -> None:
    """Launch ``wavefront_step``, advancing ``state`` [17, n_slots] in place
    by up to ``k_bounces`` steps per slot; raises on a refused launch."""
    device = _require_cuda(camv=camv, background=background, packed=packed, state=state)
    lib = load("wavefront_step")
    if state.dim() != 2 or tuple(state.shape) != (lib.wavefront_step_state_cols(), n_slots):
        raise ValueError(f"state must be [{lib.wavefront_step_state_cols()}, n_slots], "
                         f"got {tuple(state.shape)}")
    n_sph, n_quad, n_mat, n_tex, n_med, n_box = (int(x) for x in sizes)
    _check_smem(lib.wavefront_step_smem_bytes(n_sph, n_quad, n_mat, n_tex, n_med, n_box))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.wavefront_step_launch(
        device.index, camv.data_ptr(), int(seed), background.data_ptr(),
        packed.data_ptr(), n_sph, n_quad, n_mat, n_tex, n_med, n_box,
        state.data_ptr(), int(n_slots), int(k_bounces), int(max_depth),
        int(checker_depth), int(bool(has_noise)), stream)
    if err:
        msg = lib.wavefront_step_error_string(err).decode()
        raise RuntimeError(f"wavefront_step launch failed: {msg} (cudaError {err})")


def launch_megakernel_grad(camv, seed: int, background, packed, g, d_camv, d_bg, d_packed, *,
                           n_pix, max_depth, sizes, checker_depth, has_noise,
                           bounces=None) -> None:
    """Launch ``megakernel_grad``, adding the render's vector-Jacobian product
    with ``g`` [n_pix, 3] to ``d_camv`` [28], ``d_bg`` [3] and ``d_packed``
    (zeroed by the caller); raises on a refused launch. The table cotangents
    accumulate in shared memory where two copies of the tables fit, else in
    device memory. ``bounces`` (an int64 [1] CUDA tensor, optional) gets the
    number of replayed bounces added."""
    device = _require_cuda(camv=camv, background=background, packed=packed, g=g,
                           d_camv=d_camv, d_bg=d_bg, d_packed=d_packed)
    if g.numel() != 3 * n_pix or d_camv.numel() != camv.numel() \
            or d_bg.numel() != 3 or d_packed.numel() != packed.numel():
        raise ValueError("g must hold n_pix x 3 floats and the outputs match their inputs")
    if bounces is not None and (bounces.dtype != torch.int64 or bounces.device != device
                                or bounces.numel() != 1):
        raise ValueError("bounces must be an int64 [1] tensor on the tables' device")
    lib = load("megakernel_grad")
    counts = [int(x) for x in sizes]
    shared_cot = int(lib.megakernel_grad_smem_bytes(*counts, 1) <= MAX_SMEM_BYTES)
    _check_smem(lib.megakernel_grad_smem_bytes(*counts, shared_cot))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.megakernel_grad_launch(
        device.index, camv.data_ptr(), int(seed), background.data_ptr(), packed.data_ptr(),
        *counts, int(n_pix), int(max_depth), int(checker_depth), int(bool(has_noise)),
        g.data_ptr(), d_camv.data_ptr(), d_bg.data_ptr(), d_packed.data_ptr(), shared_cot,
        None if bounces is None else bounces.data_ptr(), stream)
    if err:
        msg = lib.megakernel_grad_error_string(err).decode()
        raise RuntimeError(f"megakernel_grad launch failed: {msg} (cudaError {err})")
