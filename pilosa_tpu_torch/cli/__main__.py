"""CLI entry point: ``python -m pilosa_tpu_torch.cli <verb>``.

Reference: cmd/ (cobra wiring) + ctl/ (command logic). The verbs are
listed in ``commands.py``.
"""

import sys

from .commands import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
