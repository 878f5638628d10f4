"""Channel-map image and movie export.

Port of ``spectral_cube_tpu/visualization_tools.py`` (the reference
library's ``visualization-tools.py``, aplpy and ffmpeg scripting): each
channel map is filled on the cube's device and copied to the host, then
rendered to a PNG with matplotlib; ffmpeg assembles the movie.
matplotlib is imported only when a function is called.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

__all__ = ["check_ffmpeg", "make_rgb_movie", "make_multispecies_rgb"]


def check_ffmpeg(ffmpeg_cmd="ffmpeg"):
    returncode = os.system(f"{ffmpeg_cmd} -h > /dev/null 2>&1")
    if returncode != 0:
        raise OSError(f"{ffmpeg_cmd} not found in the executable path.")


def _norm(img, vmin=None, vmax=None):
    finite = img[np.isfinite(img)]
    if finite.size == 0:
        return np.zeros_like(img)
    vmin = np.percentile(finite, 1) if vmin is None else vmin
    vmax = np.percentile(finite, 99.5) if vmax is None else vmax
    out = (img - vmin) / max(vmax - vmin, 1e-30)
    return np.clip(np.nan_to_num(out), 0, 1)


def _channel(cube, index):
    """One filled channel map, copied to the host."""
    return cube._get_filled_data(
        view=(index, slice(None), slice(None))).cpu().numpy()


def make_rgb_movie(cube, prefix, v1, v2, vmin=None, vmax=None, fps=10,
                   ffmpeg_cmd="ffmpeg"):
    """Render channels v1..v2 (Quantities) as rolling RGB frames (previous/
    current/next channel as R/G/B) and assemble an mp4."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z1 = cube.closest_spectral_channel(v1)
    z2 = cube.closest_spectral_channel(v2)
    lo, hi = min(z1, z2), max(z1, z2)
    check_ffmpeg(ffmpeg_cmd)   # fail fast, before the render loop
    frames = []
    for ii in range(lo + 1, hi):
        rgb = np.stack([
            _norm(_channel(cube, ii + o), vmin, vmax)
            for o in (1, 0, -1)], axis=-1)
        fname = f"{prefix}_v{ii:04d}.png"
        plt.imsave(fname, rgb, origin="lower")
        frames.append(fname)
    # -start_number: frames are numbered by CHANNEL index; ffmpeg's
    # image2 demuxer only probes start numbers 0-4 by default, so any
    # velocity range starting past channel 4 found no input at all
    subprocess.run(
        [ffmpeg_cmd, "-y", "-r", str(fps), "-start_number", str(lo + 1),
         "-i", f"{prefix}_v%04d.png",
         "-c:v", "libx264", "-pix_fmt", "yuv420p", f"{prefix}.mp4"],
        check=True, capture_output=True)
    return frames


def make_multispecies_rgb(cube_r, cube_g, cube_b, prefix, v1, v2, vmin=None,
                          vmax=None, fps=10, ffmpeg_cmd="ffmpeg"):
    """Per-channel RGB frames from three co-gridded cubes (one per color)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z1 = cube_r.closest_spectral_channel(v1)
    z2 = cube_r.closest_spectral_channel(v2)
    lo, hi = min(z1, z2), max(z1, z2)
    check_ffmpeg(ffmpeg_cmd)   # fail fast, before the render loop
    frames = []
    for ii in range(lo, hi + 1):
        rgb = np.stack([
            _norm(_channel(c, ii), vmin, vmax)
            for c in (cube_r, cube_g, cube_b)], axis=-1)
        fname = f"{prefix}_v{ii:04d}.png"
        plt.imsave(fname, rgb, origin="lower")
        frames.append(fname)
    subprocess.run(
        [ffmpeg_cmd, "-y", "-r", str(fps), "-start_number", str(lo),
         "-i", f"{prefix}_v%04d.png",
         "-c:v", "libx264", "-pix_fmt", "yuv420p", f"{prefix}.mp4"],
        check=True, capture_output=True)
    return frames
