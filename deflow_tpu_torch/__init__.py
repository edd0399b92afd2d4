"""PyTorch/CUDA port of deflow_tpu (eval path on NVIDIA Hopper)."""
