"""CLI entry point: ``python -m pilosa_tpu_torch.cli <verb>``.

Reference: cmd/ (cobra wiring) + ctl/ (command logic). The port's verbs
so far: server, import and export.
"""

import sys

from .commands import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
