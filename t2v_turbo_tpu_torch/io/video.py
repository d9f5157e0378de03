"""Host-side video writing for the port's CLI (the part of
t2v_turbo_tpu/io/video.py the port needs, without its native libav path and
its GIF fallback).

- `.npy`: the (T, H, W, 3) uint8 frames, through numpy.
- `.mp4`: through an `ffmpeg` binary (libx264, yuv420p) when one is on the
  PATH; without one, or when it fails, the call raises and names `.npy`.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np


def save_video(frames: np.ndarray, path: str, fps: int = 8) -> str:
    """Write (T, H, W, 3) uint8 frames to `path` (.npy or .mp4); returns it."""
    if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
        raise ValueError(f"expected (T, H, W, 3) uint8 frames, got {frames.shape} {frames.dtype}")
    ext = os.path.splitext(path)[1].lower() or ".mp4"
    if ext == ".npy":
        np.save(path, frames)
        return path
    if ext != ".mp4":
        raise ValueError(f"unsupported video extension {ext!r}: use .mp4 or .npy")
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(f"no ffmpeg binary to write {path}: write a .npy instead")
    t, h, w, _ = frames.shape
    cmd = [
        ffmpeg, "-y", "-loglevel", "error",
        "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", str(fps), "-i", "-",
        "-c:v", "libx264", "-pix_fmt", "yuv420p", path,
    ]
    proc = subprocess.run(cmd, input=np.ascontiguousarray(frames).tobytes(), capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"ffmpeg failed ({proc.returncode}) writing {path}: "
            f"{proc.stderr.decode(errors='replace')}; write a .npy instead"
        )
    return path
