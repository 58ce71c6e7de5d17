"""noise-gnn-tpu-torch: the PyTorch/CUDA port of ``noise_gnn_tpu``.

A second package beside the JAX one, with the same module layout (``graph``,
``ops``, ``models``, ``losses``, ``train``, ``eval``, ``utils``, ``tools``,
``native``). It imports neither JAX nor the JAX package. Plain tensor code
is PyTorch; each Pallas kernel of the JAX package is a hand-written CUDA
kernel: the CSR SpMM (``csrc/spmm.cu``, bound in ``ops/spmm.py``) and the
gather-ring probe (``csrc/gather_ring.cu``, bound in ``ops/gather_ring.py``,
driven by ``tools/gather_probe.py``). The host graph runtime (the CSR's
counting sort and its kin) is the port's copy of the JAX package's C++
(``csrc/graph_runtime.cpp``, bound in ``native/``).

Importing the package imports no submodule: ``import
noise_gnn_tpu_torch.train.pipelines`` (or run ``python -m
noise_gnn_tpu_torch.main -config configs/<x>.yml``).
"""

__version__ = "0.1.0"
