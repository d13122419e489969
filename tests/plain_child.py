"""Runs an entry point of the port (its main) with the rehearsals'
stand-ins (tests/chip_rehearsal.py:plain_counting): the kernels' plain
versions counting their launches as the kernels do, the FPS ring one pass
over the views.  The CPU tests and rehearsals of the evaluation scripts
start their training and render subprocesses through it, so that those
processes' launch counts (graphs.log_launches_at_exit) mean what they mean
on a card.

    python tests/plain_child.py [--sh_interval N] [--fine_tune N] \
        <module> [args...]

--sh_interval N steps the SH degree every N iterations in place of 1000,
so that a schedule of a few iterations reaches degree 3 before its cull;
--fine_tune N ends mercy N iterations before the last in place of 3000
(train/trainer.py's SH_DEGREE_INTERVAL and FINE_TUNE_ITERS).
"""

import importlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv):
    from chip_rehearsal import plain_counting

    from reduced3dgs_torch.train import trainer

    names = {"--sh_interval": "SH_DEGREE_INTERVAL",
             "--fine_tune": "FINE_TUNE_ITERS"}
    while argv[0] in names:
        setattr(trainer, names[argv[0]], int(argv[1]))
        argv = argv[2:]
    plain_counting(setattr)
    module = importlib.import_module(argv[0])
    if hasattr(module, "__path__"):  # a package: its __main__
        module = importlib.import_module(argv[0] + ".__main__")
    sys.argv = argv
    module.main(argv[1:])


if __name__ == "__main__":
    main(sys.argv[1:])
