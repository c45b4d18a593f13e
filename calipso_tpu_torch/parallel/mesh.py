"""A one-axis device mesh over torch.distributed ranks.

The counterpart of a one-axis `jax.sharding.Mesh` for the port's SPMD
code: every rank runs the same program (as JAX's multi-controller runtime
does), holds the same replicated inputs, works its own share of one axis
(the batch of `parallel/batch.py`, the horizon of `ops/spike.py`) and
meets the other ranks only in the collectives below.

`Mesh` wraps a process group:
- `axis`, the axis name (checked against `Options.spike_axis` and the
  batched solvers' `axis=`);
- `size` and `rank`;
- `device`, this rank's device, always named by the caller: `cuda:0`
  where ranks share one card, `cpu` in the tests. Nothing falls back to
  another device.
- `all_gather(t)` -> (P, *t.shape) and `all_reduce(t, op)`, on `t`'s
  device. The process groups are gloo's, and gloo takes CPU tensors, so
  both collectives stage their tensor through host memory: each is a
  device-to-host sync, which `collectives` counts (a rank's solve
  counts its loop tests in `stats["host_syncs"]` and these here). NCCL
  refuses two ranks on one card; ranks with a card each could take it.

Ranks start in one of two ways:
- `Mesh.from_env(axis, device)` in processes started by `torchrun` (its
  `RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT` contract);
- `launch(fn, ranks, device=...)`, which spawns `ranks` processes that meet
  through a `FileStore` (a file in a fresh temporary directory, so that
  concurrent launches never share a port or a store), runs `fn(mesh,
  *args)` in each and returns each rank's result.

Every process group is made with a timeout of `GROUP_TIMEOUT_S`, so a
collective that one rank never joins fails instead of waiting forever;
`launch` kills every rank as soon as one fails, and all of them at its
deadline.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

GROUP_TIMEOUT_S = 120.0  # a collective's longest wait for the other ranks
LAUNCH_TIMEOUT_S = 600.0  # `launch`'s default deadline for all ranks
JOIN_S = 10.0  # how long `launch` waits for a rank to exit after its result
FAIL_GRACE_S = 1.0  # how long `launch` collects other ranks' failures after the first


class Mesh:
    """A one-axis mesh over the ranks of a torch.distributed process group
    (the default group unless `group` names another). The group must
    exist already: see `from_env` and `launch`."""

    def __init__(self, axis: str, device, group=None):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs a torch.distributed process group: use Mesh.from_env or launch")
        self.axis = axis
        self.device = torch.device(device)
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.collectives = 0  # all_gather and all_reduce calls on this rank

    @classmethod
    def from_env(cls, axis: str, device):
        """The mesh of all ranks of a `torchrun`-style launch: joins the
        default process group from `RANK`, `WORLD_SIZE`, `MASTER_ADDR`
        and `MASTER_PORT` (once per process)."""
        if not dist.is_initialized():
            dist.init_process_group("gloo", init_method="env://", timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        return cls(axis, device)

    def all_gather(self, t):
        """(P, *t.shape): every rank's `t`, in rank order, on `t`'s device."""
        self.collectives += 1
        host = t.detach().to("cpu").contiguous()
        out = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(out, host, group=self.group)
        return torch.stack(out).to(t.device)

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """`t` reduced elementwise over the ranks by `op`, on `t`'s device
        (a bool tensor reduces as 0/1: MIN is "all", MAX "any")."""
        self.collectives += 1
        host = t.detach().to("cpu")
        host = host.to(torch.uint8) if host.dtype == torch.bool else host.clone()
        dist.all_reduce(host, op=op, group=self.group)
        return host.to(device=t.device, dtype=t.dtype)


def _rank_main(fn, rank, size, store_path, axis, device, args, results):
    """A spawned rank: join the group through the file store, run
    fn(mesh, *args), report (rank, ok, result or traceback). The result
    goes as pickled bytes: the queue's own pickler would share tensors
    through file descriptors that die with this process. A rank that
    fails reports before it leaves the group, so that the first report
    `launch` reads is, as a rule, the failure's own and not that of a
    rank whose collective it broke."""
    torch.set_num_threads(1)  # P ranks share the host's cores
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, size), rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
        )
        out = pickle.dumps(pytree.tree_map_only(torch.Tensor, lambda t: t.detach().cpu(), fn(Mesh(axis, device), *args)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    dist.destroy_process_group()
    results.put((rank, True, out))


def _failures(results, rank, ranks, trace):
    """The failure report of `rank` and of the ranks that report a failure
    within FAIL_GRACE_S after it."""
    lines = [f"launch: rank {rank} of {ranks} raised:\n{trace}"]
    until = time.monotonic() + FAIL_GRACE_S
    while (left := until - time.monotonic()) > 0:
        try:
            other, good, value = results.get(timeout=left)
        except queue.Empty:
            break
        if not good:
            lines.append(f"then rank {other} raised:\n{value}")
    return "\n".join(lines)


def launch(fn, ranks: int, *args, device, axis: str = "batch", timeout=LAUNCH_TIMEOUT_S):
    """Run `fn(mesh, *args)` on `ranks` new processes, one rank each, on
    `device` (one device for all, or a list with one a rank; the caller
    always names it), and return their results in rank order (tensors
    moved to the CPU). `fn` and `args` are pickled: `fn` must be
    importable by name. Raises RuntimeError, with the tracebacks of the ranks that
    failed within FAIL_GRACE_S of the first, as soon as a rank raises or
    dies, and TimeoutError when the ranks have not all reported within
    `timeout` seconds; either way every rank is killed first."""
    if ranks < 1:
        raise ValueError(f"launch needs at least one rank, got {ranks}")
    devices = [str(d) for d in device] if isinstance(device, (list, tuple)) else [str(device)] * ranks
    if len(devices) != ranks:
        raise ValueError(f"launch: {len(devices)} devices for {ranks} ranks")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="calipso_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, args=(fn, r, ranks, store, axis, devices[r], args, results), daemon=True)
            for r in range(ranks)
        ]
        got = {}
        ok = False
        try:
            for p in procs:
                p.start()
            while len(got) < ranks:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"launch: {ranks - len(got)} of {ranks} ranks did not report within {timeout} s"
                    )
                try:
                    rank, good, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in got and p.exitcode not in (None, 0):
                            raise RuntimeError(f"launch: rank {r} died with exit code {p.exitcode}")
                    continue
                if not good:
                    raise RuntimeError(_failures(results, rank, ranks, value))
                got[rank] = pickle.loads(value)
            ok = True
        finally:
            for p in procs:
                if ok and p.pid is not None:
                    p.join(timeout=JOIN_S)
                if p.is_alive():
                    p.kill()
                if p.pid is not None:
                    p.join()
            results.close()
    return [got[r] for r in range(ranks)]
