"""CASA mask export, on the host.

Port of ``spectral_cube_tpu/io/casa_masks.py``.  The reference library
writes include-masks as CASA images through ``casatools.image``
(``spectral_cube/io/casa_masks.py:11-127``); here the CASA writer
(:mod:`.casa_writer`) does it: the include mask, evaluated on the cube's
device and copied off it once, becomes a float 1/0 CASA image with the
cube's coordinate system (the representation CASA's ia.calcmask
consumes), or a bit-packed Bool subtable appended to an image.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_casa_mask"]


def make_casa_mask(cube, outname, append_to_image=True, img=None,
                   add_stokes=True, stokes_posn=None, overwrite=False):
    """Write the cube's include mask as a CASA image directory; with
    ``append_to_image=True`` the mask is also installed into the existing
    CASA image ``img`` as a boolean mask subtable (the reference's
    ``ia.maskhandler('copy', ...)`` path, io/casa_masks.py:113-127, done
    natively: a bit-packed Bool PagedArray directory named after
    ``outname`` inside the image, which is where CASA keeps lattice
    masks)."""
    import os
    from .casa_writer import write_casa_image

    if stokes_posn is not None:
        raise NotImplementedError(
            "custom Stokes-axis positions are not supported; the Stokes "
            "axis is written at the standard CASA position")
    include = cube._include_view(()).expand(cube.shape).to(torch.float32)
    mask_cube = cube._new_cube_with(data=include, mask=None)
    mask_cube._unit = None
    write_casa_image(mask_cube, outname, overwrite=overwrite,
                     with_stokes=bool(add_stokes))
    if append_to_image:
        if img is None:
            raise TypeError(
                "img argument must be specified to append the mask.")
        maskname = os.path.split(str(outname).rstrip(os.sep))[1]
        if not maskname:
            raise ValueError(f"cannot derive a mask name from {outname!r}")
        _append_mask_subtable(cube, img, maskname, overwrite=overwrite)
    return outname


def _append_mask_subtable(cube, img, maskname, overwrite=False):
    """Install the cube's include mask as ``<img>/<maskname>`` — a
    bit-packed Bool PagedArray subtable, the on-disk form of a CASA
    lattice mask (mirrors the mask0 layout casa_writer emits)."""
    import os
    import shutil
    from .casa_writer import _write_table_dat, _write_tsm, _write_info, \
        TP_BOOL
    from .casa_low import read_tiled_stman

    if not os.path.isdir(img):
        raise OSError(f"{img} is not a CASA image directory")
    _, cube_shape, _ = read_tiled_stman(os.path.join(img, "table.f0"))
    casa_shape = list(cube_shape)  # [nx, ny(, nstokes), nchan]
    nchan, ny, nx = cube.shape
    # 3-axis CASA images have no Stokes axis; their spectral axis sits
    # at index 2 (unconditional [3] crashed with IndexError)
    chan_ax = 3 if len(casa_shape) == 4 else 2
    if len(casa_shape) < 3 or casa_shape[0] != nx \
            or casa_shape[1] != ny or casa_shape[chan_ax] != nchan:
        raise ValueError(
            f"mask shape {cube.shape} does not match image shape "
            f"{casa_shape} (CASA order [x, y(, stokes), chan])")
    maskdir = os.path.join(img, maskname)
    if os.path.exists(maskdir):
        if not overwrite:
            raise OSError(f"{maskdir} exists; use overwrite=True")
        shutil.rmtree(maskdir)
    os.makedirs(maskdir)
    include = cube._include_view(()).cpu().numpy()          # [spec, y, x]
    if len(casa_shape) == 4:
        # CASA numpy layout is [freq, stokes, y, x]
        arr = np.broadcast_to(include[:, None, :, :],
                              (nchan, casa_shape[2], ny, nx))
    else:
        # 3-axis image (no Stokes axis): payload is [freq, y, x] directly
        arr = include
    bits = np.packbits(arr.ravel().astype("u1"),
                       bitorder="little").tobytes()
    _write_table_dat(os.path.join(maskdir, "table.dat"), {}, "PagedArray",
                     TP_BOOL, len(casa_shape))
    _write_tsm(maskdir, "PagedArray", casa_shape, bits, TP_BOOL)
    _write_info(maskdir, "Paged Array")
    # the reference's ia.maskhandler('set', maskname) step: point
    # Image_defaultmask at the new mask so readers actually use it
    # (without this, a pre-existing mask0 keeps winning)
    try:
        from .casa_low import read_table_keywords
        from .casa_writer import TP_FLOAT
        kw = read_table_keywords(os.path.join(img, "table.dat"))
        kw.pop("Image_defaultmask", None)
        kw["Image_defaultmask"] = maskname
        _write_table_dat(os.path.join(img, "table.dat"), kw, "map",
                         TP_FLOAT, len(casa_shape))
    except Exception as exc:
        import warnings
        warnings.warn(
            f"could not update Image_defaultmask in {img}: {exc}; the "
            "appended mask exists but a pre-existing default mask will "
            "still be preferred on read")
    return maskdir
