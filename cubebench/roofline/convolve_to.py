"""``SpectralCube.convolve_to`` to a single target beam: each input voxel
read once and each output voxel written once (float32), and the
operations of the normalised separable convolution: the numerator and the
denominator (every plane holds NaN outside the primary beam), each a
multiply-add of every tap pair along y and along x, at the rank that
float32 resolves (singular values above 1e-7 of the largest) and the tap
count that the configuration's beams give."""

import numpy as np

from cubebench.reference import beam


def counts(config, mix, shape):
    nchan, ny, nx = shape
    kern = beam.convolution_kernel(config)
    s = np.linalg.svd(kern, compute_uv=False)
    rank = int(np.sum(s > s[0] * 1e-7))
    ky, kx = kern.shape
    voxels = nchan * ny * nx
    return 2 * 4 * voxels, 2 * 2 * rank * (ky + kx) * voxels
