"""The benchmark's own tests: on the CPU at tiny sizes, the harness with
the program's plain twins underneath; `cuda`-marked tests need the card."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
