"""The benchmark of `calipso_tpu_torch`: one run of one cell of
`BENCHMARK.json`, printing its result as the last line of standard
output (see `benchlib/cli.py` and README.md).

    python3 benchmark/run.py --workload pendulum-t11.b131072 --seed 7 --seconds 30 --trace 0
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchlib import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main())
