"""A reference cube handed from one step of a chain to the next: a whole
tensor, or blocks worked out one at a time, so that the last step's cube
is compared a block at a time and is never held whole.  A block is
(index, values, trust): ``values`` is the cube at ``index`` (a tuple of
slices), ``trust`` None or a bool tensor of the voxels float32 can decide
there."""

from __future__ import annotations

import torch

#: voxels a block of the reference holds
BLOCK_VOXELS = 1 << 25


class Stream:
    """A cube of ``shape`` on ``device``: ``whole`` (a tensor), or
    ``blocks()`` (a fresh iterator of blocks on each call)."""

    def __init__(self, shape, device, blocks=None, whole=None):
        self.shape, self.device = tuple(shape), device
        self._blocks, self.whole = blocks, whole

    @classmethod
    def of(cls, tensor):
        return cls(tensor.shape, tensor.device, whole=tensor)

    def blocks(self):
        if self.whole is not None:
            yield (slice(None),), self.whole, None
        else:
            yield from self._blocks()

    def materialize(self):
        """(the cube as one float32 tensor, its trust or None)."""
        if self.whole is not None:
            return self.whole, None
        out = torch.empty(self.shape, dtype=torch.float32, device=self.device)
        trust = None
        for idx, values, t in self._blocks():
            out[idx] = values
            if t is not None:
                if trust is None:
                    trust = torch.ones(self.shape, dtype=torch.bool,
                                       device=self.device)
                trust[idx] = t
        return out, trust


def row_blocks(nchan, ny, nx):
    """Slices of rows (axis 1) that keep a block of whole spectra under
    :data:`BLOCK_VOXELS`."""
    rows = max(1, BLOCK_VOXELS // (nchan * nx))
    return [slice(y0, min(ny, y0 + rows)) for y0 in range(0, ny, rows)]


def spectra(stream, steps, arith):
    """The stream of ``steps`` (each (module, params) of a step that works
    on each spectrum alone) applied to ``stream``, a block of rows at a
    time.  A spectrum is trusted where every voxel of it was."""
    x, trust = stream.materialize()
    nchan, ny, nx = x.shape
    nout = nchan
    for mod, params in steps:
        nout = mod.nchan(nout, params)

    def blocks():
        for rows in row_blocks(nchan, ny, nx):
            z = x[:, rows]
            for mod, params in steps:
                z = mod.apply(z, params, arith)
            t = None
            if trust is not None:
                t = trust[:, rows].all(0, keepdim=True).expand(z.shape)
            yield (slice(None), rows), z, t
    return Stream((nout, ny, nx), x.device, blocks)


def compare(got, want):
    """({"cube_gap", "flip_share"}, what was left out) of the program's
    cube ``got`` (a tensor) against the reference's stream ``want``:
    the widest gap over the voxels both hold as a share of the reference's
    largest magnitude there, and the share of voxels that are NaN on one
    side only, over the voxels float32 decides."""
    if tuple(got.shape) != want.shape:
        return {"cube_gap": 1.0, "flip_share": 1.0}, {
            "shape": f"{tuple(got.shape)} against {want.shape}"}
    diffs, scale, flips, undecided = [], 0.0, 0, 0
    for idx, w, t in want.blocks():
        g = got[idx]
        ng, nw = torch.isnan(g), torch.isnan(w)
        flip, both = ng != nw, ~ng & ~nw
        if t is not None:
            flip &= t
            both &= t
            undecided += int((~t).sum())
        flips += int(flip.sum())
        if bool(both.any()):
            scale = max(scale, float(w[both].abs().max()))
            diffs.append(float((g[both] - w[both]).abs().max()))
    gap = max(diffs) / max(scale, 1e-300) if diffs else 0.0
    n = want.shape[0] * want.shape[1] * want.shape[2]
    return {"cube_gap": gap, "flip_share": flips / n}, {
        "undecided_voxels": undecided}
