"""The benchmark of faucet_tpu_torch on one NVIDIA H100 (see run.py).

Nothing here imports jax, faucet_tpu or bench/: the harness drives the
port, and its yardstick (generator, sizing rule, reference, peaks, byte
counts) lives in this package, where the program cannot change it.
"""
