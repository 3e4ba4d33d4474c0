"""faucet_tpu_torch: the faucet_tpu assembler's main path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors faucet_tpu's layout module for module; faucet_tpu
stays the reference it is tested against. It imports torch and never jax:
from faucet_tpu it takes only the jax-free modules (config, metrics,
io/fastq, io/native). Ported scope: one device, k <= 31 two-word codes,
Bloom mode, branch-node junction detection, two-pass file mode and
single-pass streaming (ROADMAP.md lists what is still to port).
"""
from faucet_tpu.config import Config  # noqa: F401
from faucet_tpu.metrics import Metrics  # noqa: F401
from faucet_tpu.version import __version__  # noqa: F401
