"""Host->device feed: a reader thread with pinned host tensors and
non-blocking copies (port of faucet_tpu/io/stream.py).

The reader/packer produces (bases uint8[B, L], lens int32[B]) numpy
batches on a background thread; for a CUDA device the thread pins each
batch and starts its copy with non_blocking=True, so the transfer
overlaps the device's work on the previous batch. A bounded queue keeps
memory flat for arbitrarily long streams.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()


def prefetch_batches(batches: Iterable, device, depth: int = 2) -> Iterator:
    """Yield (bases tensor on `device`, lens numpy int32) pairs, `depth`
    batches ahead of the consumer. lens stays on the host as well: the
    pipeline's metrics read it per batch."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    err: list = []

    def worker():
        try:
            for bases, lens in batches:
                t = torch.from_numpy(np.ascontiguousarray(bases))
                if device.type == "cuda":
                    t = t.pin_memory().to(device, non_blocking=True)
                else:
                    t = t.to(device)
                q.put((t, np.asarray(lens)))
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    th = threading.Thread(target=worker, daemon=True,
                          name="faucet-io-prefetch")
    th.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        yield item
    th.join()
    if err:
        raise err[0]
