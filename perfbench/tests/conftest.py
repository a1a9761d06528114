"""The benchmark's CPU tests: ``pytest perfbench/tests`` from the checkout's
root. Tests marked ``cuda`` need the card and skip without one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# the tests run in several workers: two threads each keep them from
# crowding one another on the host's cores
torch.set_num_threads(2)
