"""`python -m mythril_tpu_torch analyze ...` (interfaces/cli.py)."""

import sys

from mythril_tpu_torch.interfaces.cli import main

sys.exit(main())
