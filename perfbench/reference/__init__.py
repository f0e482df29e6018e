"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch and NumPy only: nothing here imports the program
(``madipm_tpu_torch``), its JAX original, or jax.
"""
