"""yt export (reference library ``spectral_cube/ytcube.py``).

Port of ``spectral_cube_tpu/ytcube.py``: the cube's filled data is
copied to the host and handed to yt as a uniform grid.  yt is imported
only when ``to_yt`` is called, and its absence raises ImportError."""

from __future__ import annotations

import numpy as np


def to_yt(cube, spectral_factor=1.0, nprocs=None, **kwargs):
    try:
        import yt  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "yt is required for to_yt() but is not installed") from exc
    from yt.loaders import load_uniform_grid
    # filled() copies the data off the device (.cpu().numpy())
    data = {"flux": cube.filled().value.T}
    nz, ny, nx = cube.shape
    # dims must match the data shape; spectral_factor stretches the
    # BBOX, not the grid (reference spectral_cube.py:2430-2437)
    bbox = np.array([[0.5, float(nx) + 0.5],
                     [0.5, float(ny) + 0.5],
                     [0.5, spectral_factor * float(nz) + 0.5]])
    ds = load_uniform_grid(data, [nx, ny, nz], 1.0, bbox=bbox,
                           nprocs=nprocs or 1,
                           periodicity=(False, False, False), **kwargs)
    return ytCube(cube, ds, spectral_factor=spectral_factor)


class ytCube:
    """Thin wrapper pairing a cube with its yt dataset
    (reference ytcube.py:11-286)."""

    def __init__(self, cube, dataset, spectral_factor=1.0):
        self.cube = cube
        self.wcs = cube.wcs
        self.dataset = dataset
        self.spectral_factor = spectral_factor

    def world2yt(self, world_coord, first_index=0):
        pix = self.wcs.wcs_world2pix([world_coord], first_index)[0]
        # pixel-CENTER scaling (reference ytcube.py:36-37): the stretch
        # is about the half-pixel bbox origin, not about zero
        pix[2] = (pix[2] - 0.5) * self.spectral_factor + 0.5
        return pix

    def yt2world(self, yt_coord, first_index=0):
        yt_coord = list(yt_coord)
        yt_coord[2] = (yt_coord[2] - 0.5) / self.spectral_factor + 0.5
        return self.wcs.wcs_pix2world([yt_coord], first_index)[0]

    def auto_transfer_function(self, cmap_range, log=False, colormap="doom"):
        """Default yt transfer function over ``cmap_range`` (reference
        ytcube.py:163-171)."""
        from yt.visualization.volume_rendering.transfer_function_helper \
            import TransferFunctionHelper
        tfh = TransferFunctionHelper(self.dataset)
        tfh.set_field("flux")
        tfh.set_log(log)
        tfh.set_bounds(cmap_range)
        tfh.build_transfer_function()
        tfh.tf.add_layers(10, colormap=colormap)
        return tfh.tf

    def quick_render_movie(self, outdir, size=256, nframes=30,
                           camera_angle=(0, 0, 1), north_vector=(0, 0, 1),
                           rot_vector=(1, 0, 0), colormap="doom",
                           cmap_range="auto", transfer_function="auto",
                           start_index=0, image_prefix="",
                           output_filename="out.mp4", log_scale=False,
                           rescale=True):
        """Rotation movie of the cube via yt volume rendering (reference
        ytcube.py:58-161): renders ``nframes`` frames rotating 2*pi about
        ``rot_vector``, then assembles them with ffmpeg."""
        import os
        import yt
        if not os.path.exists(outdir):
            os.makedirs(outdir)
        elif not os.path.isdir(outdir):
            raise OSError(f"Output directory {outdir} exists and is not "
                          "a directory.")
        if cmap_range == "auto":
            upper = float(self.cube.max().value)
            lower = float(self.cube.std().value) * 3
            cmap_range = [lower, upper]
        if transfer_function == "auto":
            tfh = self.auto_transfer_function(cmap_range, log=log_scale,
                                              colormap=colormap)
        else:
            tfh = transfer_function
        scale = max(self.cube.shape)
        sc = yt.create_scene(self.dataset, "flux")
        sc[0].transfer_function = tfh
        cam = sc.camera
        cam.resolution = (size, size)
        cam.position = np.asarray(camera_angle, dtype=float) * scale
        cam.switch_orientation(normal_vector=-np.asarray(camera_angle,
                                                         dtype=float),
                               north_vector=north_vector)
        images = []
        for i, _ in enumerate(cam.iter_rotate(2 * np.pi, nframes,
                                              rot_vector=rot_vector)):
            im = sc.render()
            images.append(im)
            sc.save(os.path.join(
                outdir, f"{image_prefix}{i + start_index:04d}.png"),
                sigma_clip=4.0)
        if rescale:
            _rescale_images(images, os.path.join(outdir, image_prefix))
        self._make_movie(outdir, prefix=image_prefix,
                         filename=output_filename)
        return images

    @staticmethod
    def _make_movie(moviepath, prefix="", filename="out.mp4",
                    overwrite=True):
        """Assemble rendered frames into an mp4 with ffmpeg (reference
        ytcube.py:262-286)."""
        import os
        import subprocess
        outpath = os.path.join(moviepath, filename)
        if os.path.exists(outpath) and overwrite:
            os.remove(outpath)
        elif os.path.exists(outpath):
            raise OSError(f"{outpath} exists and overwrite=False")
        subprocess.check_call(
            ["ffmpeg", "-r", "5", "-pattern_type", "glob", "-i",
             os.path.join(moviepath, prefix + "*.png"),
             "-c:v", "libx264", "-r", "30", "-pix_fmt", "yuv420p",
             outpath])
        return outpath

    def quick_isocontour(self, level="3 sigma", title="", description="",
                         color_map="hot", color_log=False,
                         export_to="sketchfab", filename=None, **kwargs):
        """Export an isocontour surface to sketchfab / .obj / .ply
        (reference ytcube.py:174-247)."""
        import warnings
        if isinstance(level, str):
            sigma = float(self.cube.std().value)
            level = float(level.split()[0]) * sigma
        self.dataset.periodicity = (True, True, True)
        surface = self.dataset.surface(self.dataset.all_data(), "flux",
                                       level)
        if export_to == "sketchfab":
            if filename is not None:
                warnings.warn("sketchfab export does not expect a filename")
            return surface.export_sketchfab(
                title=title, description=description, color_map=color_map,
                color_log=color_log, **kwargs)
        if export_to in ("obj", "ply"):
            if filename is None:
                raise ValueError("If export_to is not 'sketchfab', a "
                                 "filename must be specified")
            exporter = surface.export_obj if export_to == "obj" \
                else surface.export_ply
            exporter(filename, color_field="ones", color_map=color_map,
                     color_log=color_log, **kwargs)
            return None
        raise ValueError("export_to must be one of sketchfab,obj,ply")


def _rescale_images(images, prefix):
    """Rescale saved frames to a common 95th-percentile brightness to
    reduce flicker (reference ytcube.py:249-259)."""
    import matplotlib.image
    amax = max(np.percentile(im[:, :, :3].sum(axis=2), 95)
               for im in images)
    for i, image in enumerate(images):
        image = image.rescale(cmax=amax).swapaxes(0, 1)
        matplotlib.image.imsave(f"{prefix}{i:04d}.png", image)
