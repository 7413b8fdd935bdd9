"""Multi-process runtime of the port (port of
``realtime_stereo_matcher_tpu/parallel/distributed.py``; reference
train_stereo.py:139, one ``nn.DataParallel``).

The JAX package turns N processes into one logical device collection with
``jax.distributed.initialize()`` and lets XLA insert the collectives.  Here
every process is one rank with one device, wired by ``torch.distributed``,
and the collectives are issued by the port itself, through the helpers
below:

* :func:`initialize` -- the JAX package's env-driven init (``RSM_COORDINATOR``
  / ``RSM_NUM_PROCESSES`` / ``RSM_PROCESS_ID``, same resolution order);
  ``gloo`` where ranks share a card or run on the CPU, ``nccl`` with one
  rank a card.  No env vars: nothing happens, as in the JAX package.
* :func:`shard_host_batch` -- this rank's local slice (from the
  rank-sharded loader, ``data/loader.py``) moved to its device.
* :func:`all_reduce_sum` -- the differentiable all-reduce: forward
  ``all_reduce(SUM)``, backward ``all_reduce(SUM)`` of the cotangent, the
  transpose of ``jax.lax.psum`` under ``shard_map``.  BatchNorm statistics
  go through it (sync-BN).
* :func:`all_reduce_` (in place, no gradient), :func:`sum_gradients` (one
  flat all-reduce of every gradient, as the JAX step's single
  ``psum(grads)``) and :func:`broadcast_tensors_`.
* :class:`CollectiveRecorder` -- records every collective the helpers issue
  (op, what it carries, dtype, shape, bytes) for ``parallel/comm_audit.py``.
* :func:`spawn_ranks` -- runs one command as ``world`` ranks on this host,
  each with its ``RSM_*`` env vars: the multi-process counterpart of the JAX
  package's multi-device mesh in one process (``parallel/scaling_bench.py``).

A group of ``None`` means one process: every helper returns its input
unchanged and issues nothing.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

# seconds a rendezvous or a collective may wait for the other ranks
DEFAULT_TIMEOUT_S = 300.0
ENV_COORDINATOR = "RSM_COORDINATOR"
ENV_NUM_PROCESSES = "RSM_NUM_PROCESSES"
ENV_PROCESS_ID = "RSM_PROCESS_ID"

# the recorders open now (CollectiveRecorder); autograd's backward threads
# record into them too, so this is not thread-local
_RECORDERS: list = []


def default_backend(device_type: str, world: int) -> str:
    """``nccl`` for CUDA with a card for every rank, else ``gloo`` (CPU
    tensors, or ranks that share a card: NCCL refuses two ranks on one
    device, gloo all-reduces CUDA tensors through the host)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group; returns True if distributed.

    Resolution order: explicit args, then the ``RSM_COORDINATOR`` (host:port
    of rank 0's rendezvous) / ``RSM_NUM_PROCESSES`` / ``RSM_PROCESS_ID`` env
    vars, then single-process (no-op, returns False).  ``device`` is the
    type of device the ranks compute on and picks the backend
    (:func:`default_backend`); under ``nccl`` rank r takes ``cuda:{r %
    device_count}``.  A failed rendezvous raises:
    nothing falls back to one process."""
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if num_processes is None and ENV_NUM_PROCESSES in os.environ:
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and ENV_PROCESS_ID in os.environ:
        process_id = int(os.environ[ENV_PROCESS_ID])

    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not a rank of "
                         f"{num_processes}")
    init_group(coordinator_address, num_processes, process_id,
               backend=default_backend(torch.device(device).type,
                                       num_processes),
               timeout_s=timeout_s)
    return True


def init_group(coordinator_address: str, world: int, rank: int, *,
               backend: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """``init_process_group`` at ``tcp://coordinator_address`` with an
    explicit timeout; under ``nccl`` first selects ``cuda:{rank %
    device_count}``.  Any world size, 1 included."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    logging.info("torch.distributed initialized: rank %d/%d over %s", rank,
                 world, backend)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def default_group():
    """The world group where this process joined one, else None."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank_and_world(group) -> tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shard_host_batch(arrays, device) -> tuple:
    """This rank's local batch arrays (numpy or torch) as tensors on its
    device: the global batch is the ranks' local batches in rank order."""
    return tuple(torch.as_tensor(a).to(device, non_blocking=True)
                 for a in arrays)


class CollectiveRecorder:
    """Records every collective issued through this module's helpers while
    open: ``records`` is a list of {"op", "reduce", "what", "dtype",
    "shape", "bytes"} in issue order (``bytes``: the payload, one rank's
    buffer)."""

    def __init__(self):
        self.records: list[dict] = []

    def __enter__(self):
        _RECORDERS.append(self)
        return self

    def __exit__(self, *exc):
        _RECORDERS.remove(self)
        return False


def _record(op: str, t: torch.Tensor, what: str, reduce: str | None = None):
    if not _RECORDERS:
        return
    entry = {"op": op, "reduce": reduce, "what": what,
             "dtype": str(t.dtype).removeprefix("torch."),
             "shape": tuple(t.shape), "bytes": t.numel() * t.element_size()}
    for rec in list(_RECORDERS):
        rec.records.append(entry)


def _comm_device(group, t: torch.Tensor) -> torch.device:
    """Where ``t`` must lie for ``group``'s backend: NCCL takes CUDA
    tensors only; gloo takes either."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}


def all_reduce_(t: torch.Tensor, group, *, op: str = "sum",
                what: str = "") -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor (``op``: sum, min or max),
    no gradient; returns ``t``.  A no-op for ``group=None``."""
    if group is None:
        return t
    _record("all-reduce", t, what, op)
    dev = _comm_device(group, t)
    buf = t if t.device == dev else t.to(dev)
    dist.all_reduce(buf, op=_REDUCE_OPS[op], group=group)
    if buf is not t:
        t.copy_(buf)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Forward: all-reduce SUM; backward: all-reduce SUM of the cotangent
    (every rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group, what):
        ctx.group, ctx.what = group, what
        y = x.detach().clone(memory_format=torch.contiguous_format)
        return all_reduce_(y, group, what=what)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        g = all_reduce_(g, ctx.group, what=f"{ctx.what} (backward)")
        return g, None, None


def all_reduce_sum(x: torch.Tensor, group, *, what: str = "") -> torch.Tensor:
    """Differentiable sum over the ranks of ``group`` (out of place).  A
    no-op for ``group=None``."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group, what)


@torch.no_grad()
def sum_gradients(params, group) -> None:
    """Sum the ``.grad`` of ``params`` over the ranks in one flat
    all-reduce in the parameters' type (float32 parameters: 4 bytes a
    parameter; a parameter without a gradient sends zeros and keeps None,
    the same on every rank).  A no-op for ``group=None``."""
    if group is None:
        return
    params = list(params)
    if not params:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                      for p, g in zip(params, grads)])
    all_reduce_(flat, group, what="gradients")
    offset = 0
    for p, g in zip(params, grads):
        n = p.numel()
        if g is not None:
            g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


@torch.no_grad()
def broadcast_tensors_(tensors, group, *, src: int = 0,
                       what: str = "state") -> None:
    """Overwrite ``tensors`` with rank ``src``'s values: one broadcast per
    (dtype, device) of the flattened tensors.  A no-op for ``group=None``."""
    if group is None:
        return
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dev = _comm_device(group, flat)
        flat = flat.to(dev)
        _record("broadcast", flat, what)
        dist.broadcast(flat, src=dist.get_global_rank(group, src), group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def barrier(group) -> None:
    """Wait for every rank of ``group``; a no-op for None."""
    if group is not None:
        dist.barrier(group=group)


def free_port() -> int:
    """A TCP port free on localhost now (bound to port 0 and released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(args, world: int, *, timeout: float, env=None,
                cwd=None) -> list[tuple[str, str]]:
    """Run ``python args...`` as ranks 0..world-1 of one group on this host
    (``RSM_COORDINATOR`` on a free localhost port); returns each rank's
    (stdout, stderr).  Raises if a rank exits non-zero (the others are
    killed at once) or if the ranks are not done within ``timeout``
    seconds (all are killed)."""
    port = free_port()
    base = dict(os.environ, **(env or {}))
    outs, procs = [], []
    try:
        for rank in range(world):
            out, err = (tempfile.TemporaryFile("w+") for _ in range(2))
            outs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, *map(str, args)], stdout=out, stderr=err,
                cwd=cwd, env=dict(base, **{
                    ENV_COORDINATOR: f"localhost:{port}",
                    ENV_NUM_PROCESSES: str(world),
                    ENV_PROCESS_ID: str(rank)})))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = next((r for r, c in enumerate(codes)
                           if c not in (None, 0)), None)
            running = None in codes
            if (failed is not None or not running
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        texts = []
        for out, err in outs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
        if failed is not None:
            raise RuntimeError(
                f"rank {failed} of {world} exited with "
                f"{procs[failed].returncode}:\n{texts[failed][1][-4000:]}")
        if running:
            raise TimeoutError(
                f"{world} ranks not done in {timeout} s; rank 0 stderr:\n"
                f"{texts[0][1][-4000:]}")
        return texts
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in outs:
            out.close()
            err.close()
