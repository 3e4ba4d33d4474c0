"""faucet_tpu_torch: the faucet_tpu assembler's main path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors faucet_tpu's layout module for module; faucet_tpu
stays the reference it is tested against. It imports torch and never jax,
and nothing of faucet_tpu: the host modules it shares with the reference
(config, metrics, io/fastq, io/native with io/cpp/pack.cc, and the other
host code) are copies that name their source file. Ported scope:
everything the reference runs: k <= 63 (wide codes above 31), Bloom and
exact mode, branch-node and ext8 junctions, two-pass file mode and
single-pass streaming, paired ends, dual-k (-second_kmer), prune_slots,
checkpoints, --profile, and hash-range sharding over one process per
shard (dist/: routed walks, the halo-exchange cleaner, multi-host).
"""
__version__ = "0.1.0"  # faucet_tpu/version.py's

from faucet_tpu_torch.config import Config  # noqa: E402,F401
from faucet_tpu_torch.metrics import Metrics  # noqa: E402,F401
