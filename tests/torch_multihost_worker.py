"""Worker of the port's two-process test (`tests/test_torch_parallel.py:
test_two_process_psum_batch_axis`), the twin of `tests/multihost_worker.py`:
one process a simulated host, started with torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT), joined into one batch-axis mesh by
`Mesh.from_env`. Both processes hold the same 16 scenarios and solve their
own 8 (`parallel/dryrun.batch_part`); the loss and gradient are summed
across the process boundary over gloo. Prints one MULTIHOST_RESULT line.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from calipso_tpu_torch.parallel import dryrun  # noqa: E402
from calipso_tpu_torch.parallel.mesh import Mesh  # noqa: E402

PER_PROCESS = 8

torch.set_num_threads(1)
mesh = Mesh.from_env("batch", "cpu")
out = dryrun.batch_part(mesh, torch.float64, per_rank=PER_PROCESS)
print(
    "MULTIHOST_RESULT "
    + json.dumps(
        dict(
            pid=mesh.rank,
            loss=float(out["loss"]),
            grad_norm=float(out["grad"].norm()),
            solved=out["batch_solved"],
            batch=out["batch"],
            n_processes=mesh.size,
        )
    ),
    flush=True,
)
dist.destroy_process_group()
