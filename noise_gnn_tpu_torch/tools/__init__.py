"""Command-line tools of the PyTorch/CUDA port (mirrors the repo's tools/)."""
