"""Device operations of the port: moments, reductions, convolution,
reprojection."""
