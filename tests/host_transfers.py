"""What a CUDA graph cannot capture, found on the CPU: ``HostTransfers``
is a TorchDispatchMode that records every op that makes a tensor from
host data or reads a device value on the host (``lift_fresh``,
``_local_scalar_dense``, ``nonzero``, ``masked_select``), except inside
the kernels' plain versions (the card runs the kernels there).  Imports
torch only: the spawned ranks of tests/torch_parallel_child.py use it."""

import traceback

from torch.utils._python_dispatch import TorchDispatchMode

HOST_OPS = ("lift_fresh", "_local_scalar_dense", "nonzero", "masked_select")


class HostTransfers(TorchDispatchMode):
    """``bad``: (op, file, line) of each host transfer of the port's code
    run under the mode; ``seen``: every op's name."""

    def __init__(self):
        super().__init__()
        self.bad, self.seen = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.seen.append(name)
        if any(s in name for s in HOST_OPS):
            frames = [f for f in traceback.extract_stack()
                      if "reduced3dgs_torch" in f.filename]
            if not any(f.name.endswith("_plain") for f in frames):
                self.bad.append((name, frames[-1].filename,
                                 frames[-1].lineno))
        return func(*args, **(kwargs or {}))
