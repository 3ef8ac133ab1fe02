"""Process-group set-up and the collectives the sharded path uses.

Port of ``textgcn_tpu/parallel/distributed.py``. Where the JAX package joins
its processes with ``jax.distributed.initialize`` and lets XLA place the
mesh collectives, the port holds one ``torch.distributed`` rank per device:
NCCL between GPUs, gloo between CPU processes (the tests) or between ranks
that share one GPU (NCCL refuses two ranks on one device).

:class:`DistributedConfig` reads a launcher's environment: torchrun's
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, else the MPI
(``OMPI_COMM_WORLD_RANK`` / ``_SIZE``) or SLURM (``SLURM_PROCID`` /
``SLURM_NTASKS``) variables for rank and world size. Nothing in a machine's
environment names the job's address otherwise: a run started by hand passes
it (``tcp://host:port`` or a ``file://`` store).

A rank that an outside launcher started (``torchrun``, ``srun``, ``mpirun``;
on one machine or several) joins with :func:`init_distributed`, the
counterpart of JAX's, takes its GPU from :func:`local_device` and trains
with :func:`textgcn_tpu_torch.parallel.launch.run_joined`;
:func:`process_summary` describes its view of the job. JAX's
``global_mesh`` has no counterpart: the process group is the port's mesh.

:func:`all_gather_rows` and :func:`ring_shift` move tensors without
autograd, for the passes whose backward is written out (the GCN paths).
:func:`all_gather_rows_ad` and :func:`ring_shift_ad` are the same
collectives as autograd ops, with the transposes that ``shard_map``'s
autodiff gives their JAX counterparts: the all-gather's backward sums the
gathered cotangent over the ranks and keeps the rank's rows (the
reduce-scatter of ``all_gather(tiled=True)``), a shift's backward is the
opposite shift (``ppermute``'s). Every rank runs the backward's collectives
in the same order, because every rank builds the same graph.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Process-level topology, resolvable from launcher variables."""

    init_method: Optional[str] = None  # "tcp://host:port" or "file://path"
    world_size: Optional[int] = None
    rank: Optional[int] = None

    @staticmethod
    def from_env(env=None) -> "DistributedConfig":
        """Read the common launcher conventions, first hit per field:
        torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` +
        ``MASTER_PORT``, then ``OMPI_COMM_WORLD_*``, then ``SLURM_*``."""
        env = os.environ if env is None else env
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        init = f"tcp://{addr}:{port}" if addr and port else None
        size = (
            env.get("WORLD_SIZE")
            or env.get("OMPI_COMM_WORLD_SIZE")
            or env.get("SLURM_NTASKS")
        )
        rank = env.get("RANK") or env.get("OMPI_COMM_WORLD_RANK") or env.get("SLURM_PROCID")
        return DistributedConfig(
            init_method=init,
            world_size=int(size) if size is not None else None,
            rank=int(rank) if rank is not None else None,
        )

    @property
    def is_multiprocess(self) -> bool:
        """JAX's rule: more than one process, or an address to meet at."""
        return (self.world_size or 1) > 1 or self.init_method is not None


def init_process_group(
    cfg: DistributedConfig, backend: str, timeout_s: float = 600.0
) -> None:
    """Join the job described by ``cfg`` (all three fields set).
    ``timeout_s`` bounds every collective, so a rank whose peer died raises
    instead of waiting forever."""
    if cfg.init_method is None or cfg.world_size is None or cfg.rank is None:
        raise ValueError(f"incomplete distributed config {cfg}")
    dist.init_process_group(
        backend,
        init_method=cfg.init_method,
        world_size=cfg.world_size,
        rank=cfg.rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def init_distributed(
    cfg: Optional[DistributedConfig] = None, *, backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> bool:
    """Join the job that a launcher started (``cfg``, else
    :meth:`DistributedConfig.from_env`) and return True; for one process
    (JAX's ``is_multiprocess`` rule) join nothing and return False. A second
    call returns True without joining again.

    ``backend`` defaults to NCCL where CUDA is available, the rank's GPU
    (:func:`local_device`) becoming the current device first, and to gloo
    on the CPU; ``"gloo"`` asks for gloo on a GPU machine too (several ranks
    on one GPU, which NCCL refuses). ``timeout_s`` bounds every collective."""
    if dist.is_initialized():
        return True
    cfg = DistributedConfig.from_env() if cfg is None else cfg
    if not cfg.is_multiprocess:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    init_process_group(cfg, backend, timeout_s)
    return True


def local_device(env=None, *, cpu: bool = False) -> torch.device:
    """This rank's GPU, ``cuda:{local rank}``: the launcher's ``LOCAL_RANK``,
    else ``OMPI_COMM_WORLD_LOCAL_RANK``, else ``SLURM_LOCALID``. Raises when
    none is set or the machine has no such GPU; it never picks one in their
    place. ``cpu=True`` gives the CPU (gloo ranks without a GPU)."""
    if cpu:
        return torch.device("cpu")
    env = os.environ if env is None else env
    local = next(
        (env[k] for k in ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_LOCALID") if k in env),
        None,
    )
    if local is None:
        raise RuntimeError(
            "no local rank (LOCAL_RANK, OMPI_COMM_WORLD_LOCAL_RANK or SLURM_LOCALID): "
            "pass the rank's device"
        )
    n = torch.cuda.device_count()
    if not 0 <= int(local) < n:
        raise RuntimeError(f"local rank {local} has no GPU: this machine has {n}")
    return torch.device("cuda", int(local))


def process_summary(device=None) -> str:
    """One line on this process's view of the job, for example ``rank 1/2 on
    cuda:1 (nccl): 8 local / 16 global GPUs``: the rank's ``device``, and the
    GPUs of this machine and of every machine that holds a rank. ``device``
    defaults to the current CUDA device where there is one (the one
    :func:`init_distributed` made current for NCCL), else the CPU. In a
    joined group every rank calls it together (it gathers each rank's host
    name and GPU count)."""
    n_local = torch.cuda.device_count()
    if device is None:
        device = f"cuda:{torch.cuda.current_device()}" if n_local else "cpu"
    dev = str(torch.device(device))
    if not dist.is_initialized():
        return f"rank 0/1 on {dev} (no group): {n_local} local / {n_local} global GPUs"
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, (socket.gethostname(), n_local))
    n_global = sum(dict(hosts).values())
    return (f"rank {dist.get_rank()}/{dist.get_world_size()} on {dev} ({dist.get_backend()}): "
            f"{n_local} local / {n_global} global GPUs")


def all_gather_rows(x_local: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every rank's ``[rps, F]`` block in rank order: the
    all-gathered ``[n_pad, F]`` table (``jax.lax.all_gather(..., tiled=True)``)."""
    x_local = x_local.contiguous()
    world = dist.get_world_size(group)
    if world == 1:
        return x_local
    out = x_local.new_empty((world * x_local.shape[0], *x_local.shape[1:]))
    dist.all_gather(list(out.chunk(world)), x_local, group=group)
    return out


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns ``t``."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def ring_shift(t: torch.Tensor, step: int, group=None) -> torch.Tensor:
    """One step of a ring (``jax.lax.ppermute``): send ``t`` to rank ``(r +
    step) mod P`` of ``group`` and return the tensor that rank ``(r - step)
    mod P`` sent, of ``t``'s shape and type. The send and the receive are
    posted together (``batch_isend_irecv``), so no rank waits for another to
    finish its own exchange first. With one rank it returns ``t``.

    NCCL moves device tensors. gloo's point-to-point ops read and write
    host memory, so a CUDA tensor on a gloo group is staged through the
    host: one explicit copy out before the send and one back after the
    receive. That is a transport, not a fallback: whatever the caller
    computes on the tensor stays on its device."""
    world = dist.get_world_size(group)
    if world == 1:
        return t
    rank = dist.get_rank(group)
    dst, src = (rank + step) % world, (rank - step) % world
    if group is not None:
        dst, src = dist.get_global_rank(group, dst), dist.get_global_rank(group, src)
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    send = (t.cpu() if staged else t).contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group),
    ]):
        req.wait()
    return recv.to(t.device) if staged else recv


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_local, group):
        ctx.group, ctx.rows = group, x_local.shape[0]
        return all_gather_rows(x_local, group)

    @staticmethod
    def backward(ctx, g):
        # the reduce-scatter as an all-reduce and a slice: gloo has no
        # reduce_scatter to count on
        g = all_reduce_sum(g.contiguous().clone(), ctx.group)
        r0 = dist.get_rank(ctx.group) * ctx.rows
        return g[r0 : r0 + ctx.rows], None


def all_gather_rows_ad(x_local: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_gather_rows` differentiable in ``x_local``: the gradient
    of the ``[n_pad, F]`` table is summed over the ranks and each rank keeps
    its ``[rps, F]`` rows. Every rank of the group calls it, and its
    backward, together."""
    return _AllGatherRows.apply(x_local, group)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, step, group):
        ctx.step, ctx.group = step, group
        return ring_shift(t, step, group)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, -ctx.step, ctx.group), None, None


def ring_shift_ad(t: torch.Tensor, step: int, group=None) -> torch.Tensor:
    """:func:`ring_shift` differentiable in ``t``: the cotangent travels
    back the opposite way. Every rank of the group calls it, and its
    backward, together."""
    return _RingShift.apply(t, step, group)
