"""augment layer of the PyTorch/CUDA port (mirrors noise_gnn_tpu/augment)."""
