"""`python3 -m perfbench`: see `perfbench/run.py`."""

import sys

from perfbench.run import main

sys.exit(main())
