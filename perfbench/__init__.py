"""The benchmark of madipm_tpu_torch on one H100: see README.md."""
