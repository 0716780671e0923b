"""Build, load and launch-check the port's CUDA kernels.

One ``nvcc -c`` per ``csrc/*.cu``, all started together, compiles each
source for ``sm_90a``; one more ``nvcc`` links the objects into a shared
library with a plain C interface, which is loaded with ``ctypes``. The build
runs at first use, into ``kernels/build/`` (git-ignored), under a file name
that carries a hash of the sources and flags, so an edited source rebuilds
and a finished build is reused.

Numerics: ``--fmad=false`` (no a*b+c contraction, like eager torch) and no
fast-math, so division and sqrt are IEEE-rounded. The kernels are held
bit-equal (K1, K2, K4, K6, K7, K8, K9, K11, K12, K13, K14: K6 and K9 to
their order of sums, ``render/camera.py::ordered_camera_sums``) or within a
stated tolerance (K3, K5, K10) to their plain torch versions. ``hit_simple.cu``,
``camera_bwd_simple.cu``, ``shade_simple.cu``, ``shade_bwd_simple.cu``,
``lights_simple.cu``, ``overlap_simple.cu`` and ``records_simple.cu`` are
the first forms of K1, K6 with K9, K4, K5, K8 with K10, K11 and K13, built
for the same-card comparisons of ``chip_smoke.py`` and the card tests
only.

Each wrapper counts its launches in ``launches``; a run resets the counts
with ``reset_launches`` and reads them afterwards to show which kernels it
went through, and ``skipped_launches`` for those of them that belong to the
dead bounces of the device loops (the frame's and the training step's),
which their CUDA graphs do not launch. The dead bounces are tallied only
inside a ``utils.tracer.recording()`` block, which a reader of
``skipped_launches`` opens around the frames and steps it counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from ..utils import tracer

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("hit.cu", "hit_simple.cu", "camera.cu", "camera_bwd_simple.cu",
           "pixel.cu", "shade.cu", "shade_simple.cu", "shade_bwd.cu",
           "shade_bwd_simple.cu", "stochastic.cu", "lights.cu",
           "lights_simple.cu", "overlap.cu", "overlap_simple.cu", "bounce.cu",
           "records.cu", "records_simple.cu")
HEADERS = ("common.cuh", "shade.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

# launches of each kernel since the last reset_launches(); "hit" counts K1's
# nearest and any-hit launches, "hit_any" its any-hit launches alone; K5
# with per-ray light positions counts apart from K5 with the fixed ones;
# "overlap_refit" counts the refit of K11's records; "bounce" counts K12
# (both forms); "records" K13, the device loops' packing of K1's and K4's
# records; "bounce_bwd" K14, the reverse of K12.
# A CUDA graph of a device loop (the frame's chunk, the training step) adds,
# for each replay, what its capture counted: a launch inside a conditional
# IF node (a bounce after the first, or its reverse) counts on every
# replay, whether or not the node runs its body; ``skipped_launches`` gives
# apart those of dead bounces, which the card does not launch
launches = {"hit": 0, "hit_any": 0, "camera_rays": 0, "pixel_finish": 0,
            "shade": 0, "shade_bwd": 0, "shade_bwd_lights": 0, "camera_bwd": 0,
            "camera_rays_stochastic": 0, "camera_bwd_stochastic": 0,
            "light_points": 0, "light_points_bwd": 0, "overlap": 0,
            "overlap_refit": 0, "bounce": 0, "records": 0, "bounce_bwd": 0}
# the device loops' dead bounces since the last reset_launches(), tallied on
# the card (no sync) inside ``tracer.recording()``: device -> (4,) i64, the
# bounces of frames without and with lights, then of training steps without
# and with lights; the frames and steps run on the card outside it, whose
# bounces went untallied; and the records of the last frame and the last
# step (``note_frame``, ``note_step``)
_dead_bounces: dict = {}
_untallied = 0
_last_frame: dict = {}
_last_step: dict = {}


def reset_launches() -> None:
    global _untallied
    for k in launches:
        launches[k] = 0
    _dead_bounces.clear()
    _untallied = 0


def note_frame(ran: torch.Tensor, lights: bool, host_ms: dict,
               cache_hit: bool = False, dead_launched: bool = False) -> None:
    """Record a device-loop frame: ``ran`` is its (chunks, max_depth + 1)
    i32 alive words, a chunk a row (1 where the bounce ran), ``lights``
    whether its scene has lights, ``host_ms`` the host's milliseconds in
    its stages, ``cache_hit`` whether it replayed a graph kept from an
    earlier call. On CUDA its dead bounces join the tally (``_note_dead``),
    unless ``dead_launched`` (the loop's first form, which makes their
    launches)."""
    _last_frame.clear()
    _last_frame.update(ran=ran, lights=lights, host_ms=host_ms,
                       cache_hit=cache_hit)
    if not dead_launched:
        _note_dead(ran, int(lights))


def note_step(ran: torch.Tensor, lights: bool, host_ms: dict,
              cache_hit: bool) -> None:
    """Record a training step of the device loop
    (``render/renderer.py::loss_grads_device``): ``ran`` is its
    (max_depth + 1,) i32 alive words (1 where the bounce, and so its
    reverse, ran), the rest as in ``note_frame``. On CUDA its dead bounces
    join the tally (``_note_dead``)."""
    _last_step.clear()
    _last_step.update(ran=ran, lights=lights, host_ms=host_ms,
                      cache_hit=cache_hit)
    _note_dead(ran[None], 2 + int(lights))


def _note_dead(ran: torch.Tensor, slot: int) -> None:
    """Inside a ``tracer.recording()`` block, add the dead bounces of
    ``ran`` to the tally (``_tally``); outside one, only count a frame or
    step on the card as untallied, so that ``skipped_launches`` refuses
    to read a tally that lacks it. Off the path of untraced and
    profiled calls alike: the tally's four ops a call are work that
    nothing but the launch counts reads."""
    global _untallied
    if tracer.in_recording():
        _tally(ran, slot)
    elif ran.is_cuda:
        _untallied += 1


def _tally(ran: torch.Tensor, slot: int) -> None:
    """Add the dead bounces of ``ran`` (rows of alive words, the last
    column past the last bounce) to the device tally's ``slot``, on the
    card (no sync); nothing on the CPU, whose loop makes no launch it
    skips."""
    if ran.device.type != "cuda":
        return
    tally = _dead_bounces.get(ran.device)
    if tally is None:
        tally = _dead_bounces[ran.device] = torch.zeros(
            4, dtype=torch.int64, device=ran.device)
    bounces = ran[:, :-1]
    tally[slot].add_(bounces.numel() - bounces.sum())


def last_frame() -> dict:
    """The last device-loop frame's record (``note_frame``): "ran",
    "lights", "host_ms", "cache_hit". "ran" is the loop's own buffer,
    valid until its next frame."""
    return dict(_last_frame)


def last_step() -> dict:
    """The last training step's record (``note_step``): "ran", "lights",
    "host_ms", "cache_hit". "ran" is the step's own buffer, valid until its
    next call."""
    return dict(_last_step)


def skipped_launches() -> dict:
    """The launches counted since the last reset_launches() that belong to
    the device loops' dead bounces, by launch-count key, and the dead
    bounces ("bounces"; of training steps also apart, "step_bounces"). The
    CUDA graphs of ``frame_device`` and ``loss_grads_device`` do not make
    these launches: a dead bounce sits in an IF node whose body does not
    run. Reads the tally: a copy to the host, which waits for the frames.
    The tally holds the frames and steps run inside
    ``utils.tracer.recording()``; a frame or step run on the card outside
    it since the last reset_launches() makes this raise.
    A bounce of the device loop (``render/renderer.py``) holds K1 nearest,
    K4 and K12, and K1 any hit where the scene has lights; a training
    step's bounce also its reverse, K14 and K5."""
    if _untallied:
        raise RuntimeError(
            f"{_untallied} device-loop frames or steps ran on the card "
            "outside tracer.recording() since reset_launches(): their dead "
            "bounces were not tallied")
    out = dict.fromkeys(launches, 0)
    out["bounces"] = out["step_bounces"] = 0
    for tally in _dead_bounces.values():
        for slot, dead in enumerate(tally.tolist()):
            lights = slot % 2
            for k in ("bounces", "hit", "shade", "bounce"):
                out[k] += dead
            out["hit"] += lights * dead
            out["hit_any"] += lights * dead
            if slot >= 2:
                for k in ("step_bounces", "bounce_bwd", "shade_bwd"):
                    out[k] += dead
    return out


def made_launches() -> dict:
    """The launches that the card made since the last reset_launches(), by
    launch-count key: ``launches`` less ``skipped_launches()`` (a copy to
    the host, which waits for the frames)."""
    skipped = skipped_launches()
    return {k: v - skipped[k] for k, v in launches.items()}


@dataclass
class BuildInfo:
    path: Path
    seconds: float    # 0.0 when an earlier build was reused
    log: str          # nvcc's output (ptxas register/spill lines), also
                      # of a reused build


_build_info: BuildInfo | None = None
_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")
    return found


def build() -> BuildInfo:
    """Compile the kernels (once per process and per source hash)."""
    global _build_info
    if _build_info is not None:
        return _build_info
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"libyrt_kernels_{h.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")   # nvcc's output, kept with the build
    if so.exists():
        log = log_path.read_text() if log_path.exists() else ""
        _build_info = BuildInfo(so, 0.0, "reused " + so.name + "\n" + log)
        return _build_info
    objdir = BUILD_DIR / f"obj_{so.stem}.{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [objdir / (s + ".o") for s in SOURCES]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                          str(CSRC / s)] for s, o in zip(SOURCES, objs))]
    log = []
    try:
        for cmd, proc in procs:
            out, _ = proc.communicate(timeout=900)
            log.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
    finally:
        for _, proc in procs:   # stop every compiler on the way out
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    text = "".join(log) + proc.stdout + proc.stderr
    log_tmp = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
    log_tmp.write_text(text)
    os.replace(log_tmp, log_path)
    os.replace(tmp, so)
    shutil.rmtree(objdir, ignore_errors=True)
    _build_info = BuildInfo(so, seconds, text)
    return _build_info


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build().path))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.yrt_error_string.restype = ctypes.c_char_p
    lib.yrt_error_string.argtypes = [i32]
    lib.yrt_hit.restype = i32
    lib.yrt_hit.argtypes = ([vp] * 4 + [i32] + [vp] * 4 + [i32] * 2
                            + [vp] * 6)
    lib.yrt_hit_simple.restype = i32
    lib.yrt_hit_simple.argtypes = ([vp] * 15 + [vp] * 4 + [i32, i32]
                                   + [vp] * 4 + [vp])
    lib.yrt_camera_rays.restype = i32
    lib.yrt_camera_rays.argtypes = [vp, i32, i32, i32, i32] + [vp] * 9
    lib.yrt_camera_bwd_scratch.restype = i32
    lib.yrt_camera_bwd_scratch.argtypes = [i32]
    lib.yrt_camera_bwd.restype = i32
    lib.yrt_camera_bwd.argtypes = [vp, vp, vp, i32] + [vp] * 9
    lib.yrt_camera_bwd_simple_scratch.restype = i32
    lib.yrt_camera_bwd_simple_scratch.argtypes = [i32]
    lib.yrt_camera_bwd_simple.restype = i32
    lib.yrt_camera_bwd_simple.argtypes = [vp, vp, vp, i32] + [vp] * 8
    shade_p = ctypes.POINTER(ShadeScene)
    lib.yrt_shade_prep.restype = i32
    lib.yrt_shade_prep.argtypes = [shade_p] + [vp] * 5 + [i32] + [vp] * 5
    lib.yrt_shade_finish.restype = i32
    lib.yrt_shade_finish.argtypes = [shade_p] + [vp] * 6 + [i32] + [vp] * 5
    lib.yrt_shade_prep_simple.restype = i32
    lib.yrt_shade_prep_simple.argtypes = lib.yrt_shade_prep.argtypes
    lib.yrt_shade_finish_simple.restype = i32
    lib.yrt_shade_finish_simple.argtypes = lib.yrt_shade_finish.argtypes
    grads_p = ctypes.POINTER(ShadeGrads)
    lib.yrt_shade_bwd.restype = i32
    lib.yrt_shade_bwd.argtypes = ([shade_p, grads_p] + [vp] * 6 + [i32]
                                  + [vp] * 8)
    lib.yrt_shade_bwd_scratch.restype = ctypes.c_longlong
    lib.yrt_shade_bwd_scratch.argtypes = [i32, i32]
    lib.yrt_shade_bwd_simple.restype = i32
    lib.yrt_shade_bwd_simple.argtypes = ([shade_p, grads_p] + [vp] * 6
                                         + [i32] + [vp] * 7)
    lib.yrt_pixel_finish.restype = i32
    lib.yrt_pixel_finish.argtypes = [vp, i32, i32, i32, vp, vp, vp, vp]
    u64 = ctypes.c_ulonglong
    lib.yrt_bounce.restype = i32
    lib.yrt_bounce.argtypes = [vp] * 5 + [i32] + [vp] * 7 + [u64, i32, vp]
    lib.yrt_bounce_out.restype = i32
    lib.yrt_bounce_out.argtypes = ([vp] * 5 + [i32] + [vp] * 8
                                   + [u64, u64, i32, vp])
    lib.yrt_bounce_bwd.restype = i32
    lib.yrt_bounce_bwd.argtypes = [vp] * 12 + [i32, vp]
    for name in ("yrt_records", "yrt_records_empty"):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [vp] * 5
    lib.yrt_records_simple.restype = i32
    lib.yrt_records_simple.argtypes = [vp, vp] + [i32] * 5 + [vp]
    lib.yrt_if_handle.restype = i32
    lib.yrt_if_handle.argtypes = [vp, ctypes.POINTER(u64)]
    lib.yrt_if_begin.restype = i32
    lib.yrt_if_begin.argtypes = [vp, u64, vp]
    lib.yrt_if_end.restype = i32
    lib.yrt_if_end.argtypes = [vp]
    u32 = ctypes.c_uint32
    u32p = ctypes.POINTER(u32)   # magic_divisor's numbers
    lib.yrt_camera_rays_stochastic.restype = i32
    lib.yrt_camera_rays_stochastic.argtypes = ([vp, i32, i32, i32, i32, u32p,
                                                u32] + [vp] * 11)
    lib.yrt_camera_stochastic_bwd.restype = i32
    lib.yrt_camera_stochastic_bwd.argtypes = ([vp, i32, i32, i32, i32, u32p,
                                               u32] + [vp] * 12)
    lib.yrt_camera_stochastic_bwd_simple.restype = i32
    lib.yrt_camera_stochastic_bwd_simple.argtypes = ([vp, i32, i32, i32, i32,
                                                      u32] + [vp] * 11)
    light_args = [vp, i32, u32, vp, i32, i32] + [vp] * 5 + [i32]
    for name in ("yrt_light_points_simple", "yrt_light_points_bwd_simple"):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = light_args + [vp] * 4
    lib.yrt_light_points.restype = i32
    lib.yrt_light_points.argtypes = light_args + [vp] * 5   # + seed word
    lib.yrt_light_points_bwd.restype = i32
    lib.yrt_light_points_bwd.argtypes = light_args + [vp, i32] + [vp] * 4
    lib.yrt_light_points_bwd_scratch.restype = ctypes.c_longlong
    lib.yrt_light_points_bwd_scratch.argtypes = [i32] * 3
    lib.yrt_overlap_refit.restype = i32
    lib.yrt_overlap_refit.argtypes = [vp] * 12 + [i32] * 2 + [vp] * 5
    lib.yrt_overlap.restype = i32
    lib.yrt_overlap.argtypes = ([vp, vp, i32] + [vp] * 3 + [i32] + [vp] * 3
                                + [i32] + [vp] * 6)
    lib.yrt_overlap_simple.restype = i32
    lib.yrt_overlap_simple.argtypes = ([vp, vp, i32] + [vp] * 4 + [i32]
                                       + [vp] * 4 + [vp] * 6)
    _lib = lib
    return lib


class ShadeScene(ctypes.Structure):
    """Scene arrays, shade records (``ops/shade_records.py``) and constants
    of a shading launch: the C struct ``yrt::ShadeScene`` of
    ``csrc/shade.cuh``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "pos", "norm", "texcoord", "prim_v", "prim_type", "inst_axes",
        "inst_o", "inst_mat", "inst_is_lines", "mat_kd", "mat_ks", "mat_kr",
        "mat_rs", "mat_kd_txt", "mat_ks_txt", "tex_quad", "tex_w", "tex_h",
        "light_pos", "light_axes", "light_o", "light_ke", "amb",
        "light_pos_ray", "prim_rec", "inst_rec", "mat_rec", "alive")]
        + [(name, ctypes.c_int) for name in (
            "tex_th", "tex_tw", "num_lights", "has_kd_tex", "has_ks_tex")]
        + [(name, ctypes.c_float) for name in (
            "gamma", "rs_exp", "texel_scale")])


class ShadeGrads(ctypes.Structure):
    """Gradient buffers of a K5 launch (f64 leaf sums, and the f32 per-ray
    light positions' or null): ``yrt::ShadeGrads`` of
    ``csrc/shade_bwd.cu``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "pos", "norm", "texcoord", "inst_axes", "inst_o", "mat_kd", "mat_ks",
        "mat_kr", "mat_rs", "light_pos", "light_axes", "light_o",
        "light_ke", "light_pos_ray")]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def current_stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check_launch(err: int, name: str) -> None:
    """Raise when a kernel launch returned a CUDA error."""
    if err != 0:
        msg = library().yrt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Validate a kernel argument: device, dtype, shape (-1 = any), and
    contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s != -1 and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def device_kind(t: torch.Tensor) -> str:
    """'cpu' or 'cuda'; any other device raises (no kernel, no plain path)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type
