"""The plain reference: PyTorch and NumPy only, nothing of the program
(``spectral_cube_tpu_torch``) and nothing of JAX."""
