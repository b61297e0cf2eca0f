"""Build and load the port's native code (see :mod:`fots_torch.kernels.build`)."""
