"""noise-gnn-tpu-torch: the PyTorch/CUDA port of ``noise_gnn_tpu``.

A second package beside the JAX one, with the same module layout (``graph``,
``ops``, ``models``, ``losses``, ``train``, ``eval``, ``utils``). It imports
neither JAX nor the JAX package. Plain tensor code is PyTorch; the one
Pallas kernel of the JAX package, the CSR SpMM, is a hand-written CUDA
kernel (``csrc/spmm.cu``, bound in ``ops/spmm.py``).

Importing the package imports no submodule: ``import
noise_gnn_tpu_torch.train.pipelines`` (or run ``python -m
noise_gnn_tpu_torch.main -config configs/<x>.yml``).
"""

__version__ = "0.1.0"
