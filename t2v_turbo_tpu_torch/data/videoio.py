"""ctypes bindings for the native video library (decode / encode / probe).

Port of t2v_turbo_tpu/data/videoio.py. The C++ library in the repository's
`native/videoio/` (libav: libavformat, libavcodec, libavutil, libswscale,
libswresample) replaces the reference's decord decoder
(data/dataloader/video_decode.py) and torchvision's mp4 writer. It is
compiled at first use, with the flags and libraries of its Makefile, into
`build/t2v_turbo_tpu_torch/videoio/<hash of the source>/libvideoio.so`
beside the package (linked to a temporary name, then renamed, so processes
building at the same time see all of it or none); nothing is written into
`native/`. Without a C++ compiler or libav's headers and libraries the
build raises and names them: there is no fallback. Decoding releases the
GIL inside libav, so `VideoDecoder`'s threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "native", "videoio")
BUILD_ROOT = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "t2v_turbo_tpu_torch", "videoio")
# native/videoio/Makefile's CXXFLAGS and LDLIBS
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall")
LIBAV = ("avformat", "avcodec", "avutil", "swscale", "swresample")


class _VioInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("fps", ctypes.c_double),
        ("n_frames", ctypes.c_int64),
        ("duration", ctypes.c_double),
    ]


def _source() -> str:
    src = os.path.join(SOURCE_DIR, "videoio.cpp")
    if not os.path.exists(src):
        raise RuntimeError(f"the native video library's source is missing: {src}")
    return src


def library_path() -> str:
    """Path of the shared library for the current source and flags."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LIBAV).encode())
    with open(_source(), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libvideoio.so")


def build() -> str:
    """Compile the library if it is missing; return its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: the native video library cannot be built")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *CXXFLAGS, "-shared", _source(), "-o", tmp, *(f"-l{n}" for n in LIBAV)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        output = proc.stdout + proc.stderr
        headers = sorted(set(re.findall(r"([\w/]+\.h): No such file", output)))
        libs = sorted(set(re.findall(r"cannot find -l(\w+)", output)))
        missing = (f"missing headers {headers}; " if headers else "") + (f"missing libraries {libs}; " if libs else "")
        raise RuntimeError(
            f"the native video library needs libav's headers and libraries (lib{', lib'.join(LIBAV)}): "
            f"{missing}{' '.join(cmd)} failed ({proc.returncode}):\n{output}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded library with its C signatures declared (built on first use)."""
    lib = ctypes.CDLL(build())
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.vio_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(_VioInfo)]
    lib.vio_probe.restype = ctypes.c_int
    lib.vio_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_uint,
                               ctypes.c_int, ctypes.c_int, u8p]
    lib.vio_decode.restype = ctypes.c_int
    lib.vio_decode_window.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, u8p]
    lib.vio_decode_window.restype = ctypes.c_int
    lib.vio_encode.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                               ctypes.c_char_p]
    lib.vio_encode.restype = ctypes.c_int
    lib.vio_last_error.argtypes = []
    lib.vio_last_error.restype = ctypes.c_char_p
    return lib


def available() -> bool:
    """True when the library builds and loads here."""
    try:
        load()
        return True
    except (RuntimeError, OSError):
        return False


def _err(lib) -> str:
    return lib.vio_last_error().decode("utf-8", "replace")


# libswscale's vector loops write (and read) whole vectors past a row's end:
# with rows packed at 3 * width bytes, the last row's tail would land past
# the buffer when 3 * width is not a multiple of the vector (a heap overflow
# in the JAX package's binding, which passes the array itself). The frames'
# buffers get this many spare bytes after them.
_SWS_SLACK = 4096


def _padded(shape) -> np.ndarray:
    """An uninitialised uint8 array of `shape` at the start of a buffer with
    `_SWS_SLACK` spare bytes after it."""
    n = int(np.prod(shape))
    return np.empty(n + _SWS_SLACK, np.uint8)[:n].reshape(shape)


def _frames_out(path: str, n_frames: int, width: int, height: int) -> np.ndarray:
    if n_frames <= 0:
        raise ValueError(f"n_frames must be positive, got {n_frames}")
    if width <= 0 or height <= 0:
        info = probe(path)
        width = width if width > 0 else info.width
        height = height if height > 0 else info.height
    return _padded((n_frames, height, width, 3))


@dataclass(frozen=True)
class VideoInfo:
    width: int
    height: int
    fps: float
    n_frames: int
    duration: float


def probe(path: str) -> VideoInfo:
    lib = load()
    info = _VioInfo()
    if lib.vio_probe(path.encode(), ctypes.byref(info)) != 0:
        raise IOError(f"probe({path}): {_err(lib)}")
    return VideoInfo(info.width, info.height, info.fps, info.n_frames, info.duration)


def decode(
    path: str,
    n_frames: int = 16,
    target_fps: float = 0.0,
    random_offset: bool = False,
    seed: int = 0,
    width: int = 0,
    height: int = 0,
) -> np.ndarray:
    """Decode n_frames sampled at target_fps -> (T, H, W, 3) uint8.
    target_fps <= 0 uses the native fps; width / height <= 0 keep the
    native size. The reference VideoDecorder's semantics
    (data/dataloader/video_decode.py:41-186)."""
    lib = load()
    out = _frames_out(path, n_frames, width, height)
    got = lib.vio_decode(path.encode(), n_frames, float(target_fps), 1 if random_offset else 0, seed,
                         out.shape[2], out.shape[1], out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if got < 0:
        raise IOError(f"decode({path}): {_err(lib)}")
    return out


def decode_window(
    path: str,
    start: int,
    n_frames: int,
    stride: int = 1,
    width: int = 0,
    height: int = 0,
) -> np.ndarray:
    """Decode exact frame indices start, start+stride, ... -> (T, H, W, 3)
    uint8 (decord's get_batch; the cut-aware sampler's decode, reference
    video_decode.py:222-224)."""
    lib = load()
    out = _frames_out(path, n_frames, width, height)
    got = lib.vio_decode_window(path.encode(), start, stride, n_frames, out.shape[2], out.shape[1],
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if got < 0:
        raise IOError(f"decode_window({path}): {_err(lib)}")
    return out


def detect_cuts(frames: np.ndarray, threshold: float = 0.3, min_scene_len: int = 2) -> np.ndarray:
    """Scene cuts in decoded frames: the mean absolute luma difference of
    consecutive frames over 255; a cut wherever it exceeds `threshold`.
    Returns (n_scenes, 2) [start, end) frame ranges, the scene lists the
    reference's VideoDecorderWithCutDetection reads (video_decode.py:188-224)."""
    f = frames.astype(np.float32)
    luma = f @ np.array([0.299, 0.587, 0.114], np.float32)
    diff = np.abs(np.diff(luma, axis=0)).mean(axis=(1, 2)) / 255.0
    cut_points = np.flatnonzero(diff > threshold) + 1
    bounds = [0, *cut_points.tolist(), frames.shape[0]]
    scenes = [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b - a >= min_scene_len]
    if not scenes:
        scenes = [(0, frames.shape[0])]
    return np.asarray(scenes, np.int64)


def sample_scene_clip(scene_list: np.ndarray, n_frames: int, stride: int = 1, seed: int = 0) -> np.ndarray:
    """A random scene longer than n_frames * stride and a random start in
    it; the strided frame indices (the reference's cut-aware sampling,
    video_decode.py:211-224)."""
    min_len = n_frames * stride
    eligible = [s for s in np.asarray(scene_list) if s[1] - s[0] > min_len]
    if not eligible:
        raise ValueError("video clips not long enough for decoding")
    rng = np.random.RandomState(seed)
    start, end = eligible[rng.randint(len(eligible))]
    frame_start = rng.randint(int(end - start) - min_len) + start
    return np.arange(frame_start, frame_start + min_len, stride)[:n_frames]


def decode_scene_aware(
    path: str,
    n_frames: int = 16,
    stride: int = 1,
    seed: int = 0,
    width: int = 0,
    height: int = 0,
    scene_list: Optional[np.ndarray] = None,
    threshold: float = 0.3,
    probe_height: int = 72,
) -> np.ndarray:
    """A clip that crosses no scene boundary. scene_list=None detects the
    cuts on a `probe_height`-tall strip of every frame first; then only the
    chosen window is decoded at full size."""
    if scene_list is None:
        info = probe(path)
        total = max(int(info.n_frames), n_frames)
        pw = max(2, round(probe_height * info.width / max(info.height, 1)))
        strip = decode(path, n_frames=total, target_fps=0.0, width=pw, height=probe_height)
        scene_list = detect_cuts(strip, threshold=threshold)
    idx = sample_scene_clip(scene_list, n_frames, stride=stride, seed=seed)
    return decode_window(path, int(idx[0]), n_frames, stride=stride, width=width, height=height)


def encode(path: str, frames: np.ndarray, fps: float = 8.0, codec: str = "") -> None:
    """frames: (T, H, W, 3) uint8 -> mp4 (libx264 if present, else mpeg4)."""
    lib = load()
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"encode: frames must be (T, H, W, 3), got {frames.shape}")
    src = _padded(frames.shape)
    src[...] = frames
    frames = src
    t, h, w, _ = frames.shape
    rc = lib.vio_encode(path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t, h, w,
                        float(fps), codec.encode())
    if rc != 0:
        raise IOError(f"encode({path}): {_err(lib)}")


class VideoDecoder:
    """Threaded batch decoder (libav releases the GIL)."""

    def __init__(self, n_frames=16, target_fps=8.0, width=0, height=0, workers=None):
        load()  # raise here, not in a worker
        self.n_frames = n_frames
        self.target_fps = target_fps
        self.width = width
        self.height = height
        # one decode thread per core: more thrash libav's per-thread contexts
        self.pool = ThreadPoolExecutor(max_workers=workers or os.cpu_count() or 1)

    def decode_batch(self, paths: Sequence[str], random_offset=True, seed: int = 0) -> list:
        """(T, H, W, 3) uint8 per path, None where its decode failed (the
        reference's warn-and-continue)."""
        futs = [self.pool.submit(decode, p, self.n_frames, self.target_fps, random_offset, seed + i,
                                 self.width, self.height) for i, p in enumerate(paths)]
        out = []
        for f in futs:
            try:
                out.append(f.result())
            except IOError:
                out.append(None)
        return out

    def close(self) -> None:
        self.pool.shutdown()
