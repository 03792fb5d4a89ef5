"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface. It is compiled
at first use with ``nvcc`` into a shared library under ``_build/`` (listed in
``.gitignore``), named by a hash of its source, the ``csrc/*`` files it
includes, the flags and its defines, so that an edit of any of them rebuilds
it, and loaded with ``ctypes``. A build target is a source name, or a
(name, defines) pair: v4, B4 and the gradient kernel are built once per
scene feature mask (``feature_target``: ``-DV4_FEATURES=<mask>``,
``-DV3_FEATURES``, ``-DGRAD_FEATURES``); where ``megakernel.SWEEP_MODE`` is
"bvh" when a target is chosen, every kernel that walks the clusters (v4,
B4, B3 and the wavefront step, ``step_target``) is built with
``-DRT2_SWEEP_BVH`` (``SWEEP_DEFINE``) into an instance of its own; and the
profiling sources
(``wavefront_profile``, ``grad_profile``, ``megakernel_profile``,
``intersect_profile``) and the
ceiling microkernels (``roofline``) only by the profiling tools.
Kernels launch on PyTorch's current stream. There is no fallback: a missing
``nvcc``, a failed build or a refused launch raises.
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

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# -fmad=false: no contraction of a*b+c into one FMA, so the kernel rounds
# op for op as its plain PyTorch version does on the card (whose elementwise
# ops are separate kernels); path-tracing near-ties otherwise flip paths.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# A block's shared memory on Hopper (232,448 bytes with the opt-in).
MAX_SMEM_BYTES = 232448
# The define that picks each per-scene kernel's feature mask
# (megakernel.scene_features; csrc/path_common.cuh kF*).
FEATURE_DEFINES = {"megakernel_v4": "V4_FEATURES", "megakernel_v3": "V3_FEATURES",
                   "megakernel_grad": "GRAD_FEATURES"}
# The define of the bvh instances: their clustered families walk the
# threaded BVH (csrc/path_common.cuh bvh_sweep), over tables that only
# "bvh" mode packs (megakernel.SWEEP_MODE).
SWEEP_DEFINE = "RT2_SWEEP_BVH"

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# Per built target (target_key): nvcc's output, and its build time in s.
BUILD_LOGS: dict[str, str] = {}
BUILD_SECONDS: dict[str, float] = {}


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


def _target(t) -> tuple:
    """(name, defines) of a build target: a name or a (name, defines) pair."""
    return (t, ()) if isinstance(t, str) else (t[0], tuple(t[1]))


def target_key(t) -> str:
    """``name``, or ``name[D1,D2]`` for a target with defines."""
    name, defines = _target(t)
    return f"{name}[{','.join(defines)}]" if defines else name


def library_path(t) -> Path:
    name, defines = _target(t)
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for path, src in sorted(_sources(CSRC_DIR / f"{name}.cu", {}).items()):
        h.update(path.name.encode() + b"\0" + src)
    tag = "".join(f"-{d.replace('=', '')}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{h.hexdigest()[:16]}.so"


def build_all(targets) -> dict[str, Path]:
    """Compile every target that is not built yet, one ``nvcc`` per target,
    all started together. Returns target_key → library path. nvcc's output
    is kept beside each library, so a cached one still reports it."""
    paths = {target_key(t): library_path(t) for t in targets}
    todo = {target_key(t): _target(t) for t in targets if not library_path(t).exists()}
    for key, path in paths.items():
        log = path.with_name(path.name + ".log")
        if key not in todo and key not in BUILD_LOGS and log.exists():
            BUILD_LOGS[key] = log.read_text()
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for key, (name, defines) in todo.items():
        out = paths[key]
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), tmp,
                      time.perf_counter())
    failed = []
    for key, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[key] = log
        BUILD_SECONDS[key] = time.perf_counter() - t0
        if proc.returncode:
            failed.append(f"{key} (nvcc exit {proc.returncode}):\n{log}")
        else:
            paths[key].with_name(paths[key].name + ".log").write_text(log)
            os.replace(tmp, paths[key])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def _demangle(names: list) -> list:
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not names or not os.path.exists(tool):
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def ptxas_usage(key: str) -> list:
    """Per kernel entry of a target built in this process (``-Xptxas=-v``):
    {kernel (demangled where the toolkit's cu++filt is found), registers,
    stack, spill_stores, spill_loads}."""
    entries, cur = [], None
    for line in BUILD_LOGS.get(key, "").splitlines():
        if m := _ENTRY.search(line):
            cur = {"kernel": m.group(1), "registers": None, "stack": None,
                   "spill_stores": None, "spill_loads": None}
            entries.append(cur)
        elif cur is not None and (m := _STACK.search(line)) and cur["stack"] is None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := _REGS.search(line)):
            cur["registers"] = int(m.group(1))
            cur = None
    for e, name in zip(entries, _demangle([e["kernel"] for e in entries])):
        e["kernel"] = name
    return entries


# ctypes types of the kernels' Counts (csrc/path_common.cuh), as
# megakernel.counts returns them: six sizes, two cluster flags, n_noise.
_COUNTS = [ctypes.c_int] * 9


def _bind_megakernel_v4(lib: ctypes.CDLL) -> None:
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.megakernel_v4_launch.argtypes = [i, p, i, p, p, *_COUNTS[:8], p, i, i, i, f, i, i, i,
                                         p, p, p]
    lib.megakernel_v4_launch.restype = i
    lib.megakernel_v4_smem_bytes.argtypes = _COUNTS
    lib.megakernel_v4_smem_bytes.restype = i
    for name in ("megakernel_v4_features", "megakernel_v4_threads_per_sm"):
        getattr(lib, name).restype = i
    lib.megakernel_v4_features.argtypes = []
    lib.megakernel_v4_threads_per_sm.argtypes = [i]
    lib.megakernel_v4_error_string.argtypes = [i]
    lib.megakernel_v4_error_string.restype = ctypes.c_char_p


def _bind_wavefront_step(lib: ctypes.CDLL) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.wavefront_step_launch.argtypes = [i, p, i, p, p, *_COUNTS[:8], p, i, p, i, i, i, i, i,
                                          p]
    lib.wavefront_step_launch.restype = i
    lib.wavefront_step_smem_bytes.argtypes = _COUNTS
    lib.wavefront_step_smem_bytes.restype = i
    lib.wavefront_step_state_cols.argtypes = []
    lib.wavefront_step_state_cols.restype = i
    lib.wavefront_step_threads_per_sm.argtypes = [i]
    lib.wavefront_step_threads_per_sm.restype = i
    lib.wavefront_step_error_string.argtypes = [i]
    lib.wavefront_step_error_string.restype = ctypes.c_char_p


def _bind_megakernel_grad(lib: ctypes.CDLL) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.megakernel_grad_launch.argtypes = [i, p, i, p, p, *_COUNTS[:8], p, i, i, i, i, i,
                                           p, p, p, p, i, p, p]
    lib.megakernel_grad_launch.restype = i
    lib.megakernel_grad_smem_bytes.argtypes = _COUNTS + [i]
    lib.megakernel_grad_smem_bytes.restype = i
    lib.megakernel_grad_features.argtypes = []
    lib.megakernel_grad_features.restype = i
    lib.megakernel_grad_threads_per_sm.argtypes = [i]
    lib.megakernel_grad_threads_per_sm.restype = i
    lib.megakernel_grad_error_string.argtypes = [i]
    lib.megakernel_grad_error_string.restype = ctypes.c_char_p


def _bind_grad_profile(lib: ctypes.CDLL) -> None:
    _bind_megakernel_grad(lib)
    for name in ("megakernel_grad_prepass_launch", "megakernel_grad_no_atomics_launch"):
        getattr(lib, name).argtypes = lib.megakernel_grad_launch.argtypes
        getattr(lib, name).restype = ctypes.c_int


def _bind_wavefront_profile(lib: ctypes.CDLL) -> None:
    _bind_wavefront_step(lib)
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.wavefront_profile_launch.argtypes = [i, *lib.wavefront_step_launch.argtypes[:-1], p, p]
    lib.wavefront_profile_launch.restype = i
    lib.wavefront_profile_counters.argtypes = []
    lib.wavefront_profile_counters.restype = i


def _bind_megakernel_profile(lib: ctypes.CDLL) -> None:
    _bind_megakernel_v4(lib)
    _bind_megakernel_v3(lib)
    p = ctypes.c_void_p
    lib.megakernel_v4_profile_launch.argtypes = [*lib.megakernel_v4_launch.argtypes[:-1], p, p]
    lib.megakernel_v3_profile_launch.argtypes = [*lib.megakernel_v3_launch.argtypes[:-1], p, p]
    for name in ("megakernel_v4_profile_launch", "megakernel_v3_profile_launch",
                 "megakernel_profile_counters"):
        getattr(lib, name).restype = ctypes.c_int
    lib.megakernel_profile_counters.argtypes = []


def _bind_roofline(lib: ctypes.CDLL) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.roofline_chains.argtypes = []
    lib.roofline_chains.restype = i
    lib.roofline_chain_launch.argtypes = [i, i, p, i, i, i, p]
    lib.roofline_chain_launch.restype = i
    lib.roofline_copy_launch.argtypes = [i, p, p, ctypes.c_longlong, i, p]
    lib.roofline_copy_launch.restype = i
    lib.roofline_error_string.argtypes = [i]
    lib.roofline_error_string.restype = ctypes.c_char_p


def _bind_intersect_kernel(lib: ctypes.CDLL) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.intersect_kernel_launch.argtypes = [i, p, p, p, p, p, p, i, i, p, i, i, i, i, i, i, i,
                                            i, p, p, p]
    lib.intersect_kernel_launch.restype = i
    lib.intersect_kernel_error_string.argtypes = [i]
    lib.intersect_kernel_error_string.restype = ctypes.c_char_p


def _bind_intersect_profile(lib: ctypes.CDLL) -> None:
    _bind_intersect_kernel(lib)
    lib.intersect_profile_launch.argtypes = [*lib.intersect_kernel_launch.argtypes[:-1],
                                             ctypes.c_void_p, ctypes.c_void_p]
    lib.intersect_profile_launch.restype = ctypes.c_int
    lib.intersect_profile_counters.argtypes = []
    lib.intersect_profile_counters.restype = ctypes.c_int


def _bind_bvh_traverse(lib: ctypes.CDLL) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.bvh_traverse_launch.argtypes = [i, *[p] * 13, i, p, p, p]
    lib.bvh_traverse_launch.restype = i
    lib.bvh_traverse_error_string.argtypes = [i]
    lib.bvh_traverse_error_string.restype = ctypes.c_char_p


def _bind_megakernel_v3(lib: ctypes.CDLL) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.megakernel_v3_launch.argtypes = [i, p, p, *_COUNTS[:8], p, p, i, i, i, i, i, i, p, p]
    lib.megakernel_v3_launch.restype = i
    lib.megakernel_v3_smem_bytes.argtypes = _COUNTS[:8]
    lib.megakernel_v3_smem_bytes.restype = i
    for name in ("megakernel_v3_state_cols", "megakernel_v3_tile", "megakernel_v3_features"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.megakernel_v3_threads_per_sm.argtypes = [i]
    lib.megakernel_v3_threads_per_sm.restype = i
    lib.megakernel_v3_error_string.argtypes = [i]
    lib.megakernel_v3_error_string.restype = ctypes.c_char_p


_BINDERS = {"megakernel_v4": _bind_megakernel_v4, "wavefront_step": _bind_wavefront_step,
            "megakernel_grad": _bind_megakernel_grad, "intersect_kernel": _bind_intersect_kernel,
            "megakernel_v3": _bind_megakernel_v3, "grad_profile": _bind_grad_profile,
            "wavefront_profile": _bind_wavefront_profile,
            "megakernel_profile": _bind_megakernel_profile, "roofline": _bind_roofline,
            "intersect_profile": _bind_intersect_profile, "bvh_traverse": _bind_bvh_traverse}


def load(t) -> ctypes.CDLL:
    """The library of build target ``t``, built and bound at first use."""
    key = target_key(t)
    with _LOCK:
        if key not in _LIBS:
            lib = ctypes.CDLL(str(build_all((t,))[key]))
            _BINDERS[_target(t)[0]](lib)
            _LIBS[key] = lib
        return _LIBS[key]


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


def _ntab_args(ntab, device) -> tuple:
    """(pointer, tables) of an optional ntab operand [6, T*256]."""
    if ntab is None:
        return None, 0
    _require_cuda(ntab=ntab)
    if ntab.device != device:
        raise ValueError(f"ntab is on {ntab.device}, expected {device}")
    return ntab.data_ptr(), ntab.shape[1] // 256


def sweep_defines() -> tuple:
    """``(SWEEP_DEFINE,)`` where ``megakernel.SWEEP_MODE`` is "bvh", else
    ``()``: read at each call, as the tables are packed by the mode at
    hand."""
    from raytrace2_tpu_torch.ops.kernels import megakernel as mk

    return (SWEEP_DEFINE,) if mk.SWEEP_MODE == "bvh" else ()


def feature_target(name: str, features: int) -> tuple:
    """Build target of kernel ``name``'s instance for a scene feature mask
    (``megakernel.scene_features``): ``(name, ("<DEFINE>=<mask>",))``, with
    ``SWEEP_DEFINE`` after it in "bvh" mode."""
    return (name, (f"{FEATURE_DEFINES[name]}={int(features)}", *sweep_defines()))


def step_target(name: str = "wavefront_step"):
    """Build target of the wavefront step (or its profiling build
    ``wavefront_profile``): the name, or in "bvh" mode its bvh instance."""
    defines = sweep_defines()
    return (name, defines) if defines else name


def launch_megakernel_v4(camv, seed: int, background, packed, ntab, out, *, n_pix,
                         max_depth, counts, checker_depth, has_noise, features, block=False,
                         wave_frac=1.0) -> None:
    """Launch ``megakernel_v4``'s instance for the feature mask ``features``
    (built at first use), writing ``out`` [n_pix, 3] (one row per slot of
    the linear or, with ``block``, the block-tiled layout); ``counts`` is
    ``megakernel.counts`` of the scene, whose n_noise must match ``ntab``;
    raises on a refused launch."""
    device = _require_cuda(camv=camv, background=background, packed=packed, out=out)
    if out.numel() != 3 * n_pix:
        raise ValueError("out must hold n_pix x 3 floats")
    nt, n_noise = _ntab_args(ntab, device)
    if n_noise != counts[8]:
        raise ValueError("counts and ntab disagree on the number of noise tables")
    lib = load(feature_target("megakernel_v4", features))
    _check_smem(lib.megakernel_v4_smem_bytes(*counts))
    # The persistent kernel's pixel counter; the launch zeroes it on the stream.
    next_slot = torch.empty(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.megakernel_v4_launch(
        device.index, camv.data_ptr(), int(seed), background.data_ptr(),
        packed.data_ptr(), *counts[:8], nt, n_noise, int(n_pix), int(bool(block)),
        float(wave_frac), int(max_depth), int(checker_depth), int(bool(has_noise)),
        next_slot.data_ptr(), out.data_ptr(), stream)
    if err:
        msg = lib.megakernel_v4_error_string(err).decode()
        raise RuntimeError(f"megakernel_v4 launch failed: {msg} (cudaError {err})")


def launch_wavefront_step(camv, seed: int, background, packed, ntab, state, *, n_slots,
                          k_bounces, max_depth, counts, checker_depth, has_noise) -> None:
    """Launch ``wavefront_step``, advancing ``state`` [17, n_slots] in place
    by up to ``k_bounces`` steps per slot; raises on a refused launch."""
    device = _require_cuda(camv=camv, background=background, packed=packed, state=state)
    lib = load(step_target())
    if state.dim() != 2 or tuple(state.shape) != (lib.wavefront_step_state_cols(), n_slots):
        raise ValueError(f"state must be [{lib.wavefront_step_state_cols()}, n_slots], "
                         f"got {tuple(state.shape)}")
    nt, n_noise = _ntab_args(ntab, device)
    if n_noise != counts[8]:
        raise ValueError("counts and ntab disagree on the number of noise tables")
    _check_smem(lib.wavefront_step_smem_bytes(*counts))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.wavefront_step_launch(
        device.index, camv.data_ptr(), int(seed), background.data_ptr(),
        packed.data_ptr(), *counts[:8], nt, n_noise, state.data_ptr(), int(n_slots),
        int(k_bounces), int(max_depth), int(checker_depth), int(bool(has_noise)), stream)
    if err:
        msg = lib.wavefront_step_error_string(err).decode()
        raise RuntimeError(f"wavefront_step launch failed: {msg} (cudaError {err})")


def grad_target(features: int, profiling: bool = False) -> tuple:
    """Build target of the gradient kernel's instance for a feature mask
    (``megakernel_grad.grad_features``); with ``profiling`` its profiling
    build (``csrc/grad_profile.cu``), which also exports the variants'
    launches (``tools/profile_grad.py``)."""
    return ("grad_profile" if profiling else "megakernel_grad",
            feature_target("megakernel_grad", features)[1])


def profile_target(v4_features: int, v3_features: int) -> tuple:
    """Build target of the v4 and B4 profiling instances
    (``csrc/megakernel_profile.cu``, ``tools/roofline.py``) for the feature
    masks of the production instances they profile."""
    return ("megakernel_profile", (feature_target("megakernel_v4", v4_features)[1][0],
                                   *feature_target("megakernel_v3", v3_features)[1]))


def launch_megakernel_grad(camv, seed: int, background, packed, ntab, g, d_camv, d_bg,
                           d_packed, *, n_pix, max_depth, counts, checker_depth, has_noise,
                           features, bounces=None) -> None:
    """Launch ``megakernel_grad``'s instance for the feature mask
    ``features`` (built at first use), adding the render's vector-Jacobian
    product with ``g`` [n_pix, 3] to ``d_camv`` [28], ``d_bg`` [3] and
    ``d_packed`` (zeroed by the caller); raises on a refused launch. The
    table cotangents accumulate in shared memory where two copies of the
    tables fit, else in device memory. ``ntab`` takes no cotangent.
    ``bounces`` (an int64 [1] CUDA tensor, optional) gets the number of
    replayed bounces added."""
    device = _require_cuda(camv=camv, background=background, packed=packed, g=g,
                           d_camv=d_camv, d_bg=d_bg, d_packed=d_packed)
    if g.numel() != 3 * n_pix or d_camv.numel() != camv.numel() \
            or d_bg.numel() != 3 or d_packed.numel() != packed.numel():
        raise ValueError("g must hold n_pix x 3 floats and the outputs match their inputs")
    if bounces is not None and (bounces.dtype != torch.int64 or bounces.device != device
                                or bounces.numel() != 1):
        raise ValueError("bounces must be an int64 [1] tensor on the tables' device")
    nt, n_noise = _ntab_args(ntab, device)
    if n_noise != counts[8]:
        raise ValueError("counts and ntab disagree on the number of noise tables")
    lib = load(grad_target(features))
    shared_cot = int(lib.megakernel_grad_smem_bytes(*counts, 1) <= MAX_SMEM_BYTES)
    _check_smem(lib.megakernel_grad_smem_bytes(*counts, shared_cot))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.megakernel_grad_launch(
        device.index, camv.data_ptr(), int(seed), background.data_ptr(), packed.data_ptr(),
        *counts[:8], nt, n_noise, int(n_pix), int(max_depth), int(checker_depth),
        int(bool(has_noise)), g.data_ptr(), d_camv.data_ptr(), d_bg.data_ptr(),
        d_packed.data_ptr(), shared_cot, None if bounces is None else bounces.data_ptr(),
        stream)
    if err:
        msg = lib.megakernel_grad_error_string(err).decode()
        raise RuntimeError(f"megakernel_grad launch failed: {msg} (cudaError {err})")


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_intersect_kernel(o, d, time, t_min, t_max, sph, qd, out_t, out_code, *, n_sph,
                            n_quad, config, smem) -> None:
    """Launch ``intersect_kernel`` over the live records [0, n_sph) and
    [0, n_quad) with ``config`` = (lane group, threads a block, cap_s, cap_q)
    (``intersect_kernel.launch_config``) and ``smem`` bytes of shared memory
    (``intersect_kernel.smem_bytes``), writing ``out_t`` [N] f32 and
    ``out_code`` [N] int32; raises on a refused launch."""
    device = _require_cuda(o=o, d=d, time=time, t_min=t_min, t_max=t_max, sph=sph, qd=qd,
                           out_t=out_t)
    n = out_t.numel()
    if (out_code.dtype != torch.int32 or out_code.device != device
            or not out_code.is_contiguous() or out_code.numel() != n):
        raise ValueError("out_code must be a contiguous int32 CUDA tensor of N entries")
    if o.numel() != 3 * n or d.numel() != 3 * n or any(x.numel() != n
                                                       for x in (time, t_min, t_max)):
        raise ValueError("ray columns must hold N (o, d: N x 3) floats")
    group, threads, cap_s, cap_q = config
    if n * group >= 2**31:
        raise ValueError(f"{n} rays x {group} lanes exceed the kernel's int32 thread index")
    _check_smem(smem)
    lib = load("intersect_kernel")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.intersect_kernel_launch(
        device.index, o.data_ptr(), d.data_ptr(), time.data_ptr(), t_min.data_ptr(),
        t_max.data_ptr(), sph.data_ptr(), int(sph.shape[-1]), int(n_sph), qd.data_ptr(),
        int(qd.shape[-1]), int(n_quad), int(n), int(group), int(threads), int(cap_s),
        int(cap_q), int(smem), out_t.data_ptr(), out_code.data_ptr(), stream)
    if err:
        msg = lib.intersect_kernel_error_string(err).decode()
        raise RuntimeError(f"intersect_kernel launch failed: {msg} (cudaError {err})")


def launch_bvh_traverse(o, d, time, t_min, t_max, tables, out_t, out_prim) -> None:
    """Launch ``bvh_traverse`` over N rays (one thread a ray) and the walk's
    ``tables`` (``bvh_traverse.pack``: node boxes, children, leaf prims,
    sphere centres, displacements, radii), writing ``out_t`` [N] f32 and
    ``out_prim`` [N] int32; raises where the launch is refused. The caller
    checks the tree's depth against the kernel's stack
    (``bvh_traverse.MAX_STACK``)."""
    lo, hi, left, right, prim, c0, disp, rad = tables
    device = _require_cuda(o=o, d=d, time=time, t_min=t_min, t_max=t_max, box_lo=lo,
                           box_hi=hi, center0=c0, displacement=disp, radius=rad, out_t=out_t)
    n = out_t.numel()
    for name, t in (("left", left), ("right", right), ("prim", prim), ("out_prim", out_prim)):
        if t.dtype != torch.int32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {device}")
    if o.numel() != 3 * n or d.numel() != 3 * n or out_prim.numel() != n or any(
            x.numel() != n for x in (time, t_min, t_max)):
        raise ValueError("ray columns must hold N (o, d: N x 3) entries")
    m = left.numel()
    if lo.numel() != 3 * m or hi.numel() != 3 * m or right.numel() != m or prim.numel() != m:
        raise ValueError("the node tables must hold M (boxes: M x 3) entries")
    if c0.numel() != 3 * rad.numel() or disp.numel() != 3 * rad.numel():
        raise ValueError("the sphere tables must hold S (centres, displacements: S x 3) entries")
    lib = load("bvh_traverse")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.bvh_traverse_launch(
        device.index, *(x.data_ptr() for x in (o, d, time, t_min, t_max, lo, hi, left, right,
                                                prim, c0, disp, rad)),
        int(n), out_t.data_ptr(), out_prim.data_ptr(), stream)
    if err:
        msg = lib.bvh_traverse_error_string(err).decode()
        raise RuntimeError(f"bvh_traverse launch failed: {msg} (cudaError {err})")


def launch_megakernel_v3(background, packed, state, rid, radiance, *, seed_lane, min_alive,
                         max_depth, counts, checker_depth, has_noise, features) -> None:
    """Launch one pass of ``megakernel_v3``'s instance for the feature mask
    ``features`` (built at first use): ``state`` [12, n] advanced in place,
    ``rid`` [n] int32, this pass's radiance written to ``radiance`` [n, 3];
    raises on a refused launch."""
    device = _require_cuda(background=background, packed=packed, state=state,
                           radiance=radiance)
    lib = load(feature_target("megakernel_v3", features))
    n = rid.numel()
    if state.dim() != 2 or tuple(state.shape) != (lib.megakernel_v3_state_cols(), n):
        raise ValueError(f"state must be [{lib.megakernel_v3_state_cols()}, n], "
                         f"got {tuple(state.shape)}")
    if rid.dtype != torch.int32 or rid.device != device or not rid.is_contiguous():
        raise ValueError("rid must be a contiguous int32 CUDA tensor")
    if radiance.numel() != 3 * n or n % lib.megakernel_v3_tile():
        raise ValueError(f"radiance must hold n x 3 floats and n be a multiple of "
                         f"{lib.megakernel_v3_tile()}")
    _check_smem(lib.megakernel_v3_smem_bytes(*counts[:8]))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.megakernel_v3_launch(
        device.index, background.data_ptr(), packed.data_ptr(), *counts[:8],
        state.data_ptr(), rid.data_ptr(), int(n), int(seed_lane),
        int(min_alive), int(max_depth), int(checker_depth), int(bool(has_noise)),
        radiance.data_ptr(), stream)
    if err:
        msg = lib.megakernel_v3_error_string(err).decode()
        raise RuntimeError(f"megakernel_v3 launch failed: {msg} (cudaError {err})")
