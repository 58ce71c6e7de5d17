"""The plain reference the benchmark judges the program against.

Plain PyTorch and NumPy, float32 with TF32 off unless a precision says
otherwise. It imports neither JAX nor any part of the program
(``noise_gnn_tpu_torch``), takes nothing the program made (weights, tables,
the CSR, noisy labels), and works each of those out again from the inputs
the harness made. Where a step is random (the sampler's picks, dropout),
the reference replays the step's draws from the generator state the step
started from, drawing the same shapes in the order the step's algorithm
draws them; see ``replay.py``.
"""
