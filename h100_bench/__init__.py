"""The benchmark of gpyrn_tpu_torch on one NVIDIA H100 (see README.md)."""
