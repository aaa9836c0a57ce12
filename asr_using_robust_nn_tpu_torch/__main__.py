"""`python -m asr_using_robust_nn_tpu_torch` runs the port's command line
(`cli/main.py`)."""

import sys

from .cli.main import main

if __name__ == "__main__":
    sys.exit(main())
