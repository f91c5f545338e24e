"""The benchmark's own tests: on the CPU at tiny sizes, and, marked
``cuda``, the control at a cell's own size on the card
(``python3 -m pytest perfbench/tests -m cuda``)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
