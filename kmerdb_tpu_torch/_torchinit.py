"""The device of the port's device tier (counterpart of kmerdb_tpu/_jaxinit.py).

The device tier runs on a CUDA card or not at all: asking for it without
one raises, and never quietly hands back the CPU.  (The CPU runs the
kernels' plain versions only when a caller passes CPU tensors itself, as
the tests do.)
"""

import torch


def device() -> torch.device:
    """torch.device("cuda"); raises RuntimeError when CUDA is absent."""
    if not torch.cuda.is_available():
        raise RuntimeError("the device tier needs a CUDA card, and "
                           "torch.cuda.is_available() is false")
    return torch.device("cuda")
