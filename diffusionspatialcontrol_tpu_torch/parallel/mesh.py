"""Data parallelism over processes (port of ``parallel/mesh.py``).

The JAX package is single-controller: one process sees every chip, shards
the image batch over a 1-D ``("data",)`` device mesh and lets GSPMD (or
``shard_map``, ``parallel/spmd.py``) keep the reductions global. PyTorch's
idiom is one process a GPU under ``torch.distributed`` (``torchrun``), so the
port's mesh is a process group: each rank runs its equal shard of the batch
through the same UNet and kernels, and the only collective inside sampling
is the region std's moment all-reduce (``ops.attention
.logits_std_gram_nlhd``: the reference's std is global over the whole CFG
batch, attention_modify.py:95).

Design notes:
  * Every sample draws from its own seed's generators, so a sample's noise
    is the same whatever rank it lands on or how many ranks there are.
  * Shards are contiguous blocks of samples, equal in size: every rank
    issues the same collectives in the same order.
  * CFG-doubled tensors ([uncond..., cond...]) are split by sample, each
    rank taking its rows of both halves (``shard_cfg_batch``), the
    counterpart of the JAX package's per-sample pairs layout.
  * Parameters are replicated: every rank loads the same weights (its own
    ``ModelManager`` from the same files or seeds), so a request moves no
    weight between ranks; ``replicate`` broadcasts rank 0's values of a
    tree that the ranks did not build alike.
  * Backends: NCCL when each rank has a card of its own (the default on
    CUDA), gloo on the CPU, and gloo when ranks share a card, which NCCL
    refuses ("Duplicate GPU detected"); the caller asks for it. Nothing
    switches backends silently: a CUDA mesh that cannot start raises.
  * The mesh counts the collectives it issues, by kind (``Mesh.counts``),
    the port's counterpart of ``spmd.assert_only_allreduce``.
  * Rank 0 hands requests to the other ranks through the rendezvous store
    (``send_request`` / ``wait_request``): a host-side key a request, so a
    rank that waits for work holds no collective open and no timeout runs.
    A rank that falls out of step with the others (an error between the
    first and the last collective of a request) leaves the mesh
    (``leave``), and rank 0 sends no more requests once any rank has
    (``left``).
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import pickle
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


class RankError(RuntimeError):
    """A rank failed before a step that every rank takes together; raised on
    every rank, with each failed rank's message."""


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D data-parallel mesh: this process's place in a process group.

    ``group`` None is the default group; ``device`` the rank's device;
    ``store`` the rendezvous store the requests go through (set by
    ``init_data_parallel``); ``counts`` the collectives issued, by kind."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: Optional[Any] = None
    store: Optional[Any] = None
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    requests: int = 0  # requests sent (rank 0) or taken (the other ranks)

    def rows(self, batch: int) -> slice:
        """This rank's samples of a batch of ``batch``: a contiguous block,
        equal on every rank."""
        if batch % self.world_size:
            raise ValueError(
                f"a batch of {batch} does not split into {self.world_size} "
                f"equal shards")
        n = batch // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t, group=self.group)
        self.counts["all_reduce"] += 1
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated on the leading axis, in rank
        order, on every rank."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t, group=self.group)
        self.counts["all_gather"] += 1
        return torch.cat(parts)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place; returns it."""
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast(t, src, group=self.group)
        self.counts["broadcast"] += 1
        return t

    def agree(self, error: Optional[str] = None) -> None:
        """Every rank reports its error (None: ready); if any rank has one,
        every rank raises ``RankError`` with the messages, so no rank goes
        on to a collective that another will never join."""
        errors = [None] * self.world_size
        dist.all_gather_object(errors, error, group=self.group)
        self.counts["agree"] += 1
        failed = [f"rank {r}: {e}" for r, e in enumerate(errors)
                  if e is not None]
        if failed:
            raise RankError("; ".join(failed))

    def send_request(self, message) -> None:
        """Rank 0: hand ``message`` (a picklable host object) to every other
        rank (``wait_request``)."""
        if self.rank != 0 or self.store is None:
            raise RuntimeError("requests go from rank 0 of a mesh made by "
                               "init_data_parallel")
        self.requests += 1
        self.store.set(f"request/{self.requests}", pickle.dumps(message))
        self.counts["request"] += 1

    def leave(self, reason: str) -> None:
        """This rank is out of step with the others and leaves the mesh:
        ``left`` reports it, with ``reason``, from then on."""
        if self.store is not None:
            self.store.set(f"left/{self.rank}", reason.encode())

    def left(self) -> list:
        """"rank R: reason" for each rank that has left the mesh."""
        if self.store is None:
            return []
        keys = [f"left/{r}" for r in range(self.world_size)]
        return [f"rank {r}: {self.store.get(k).decode()}"
                for r, k in enumerate(keys) if self.store.check([k])]

    def wait_request(self, poll_s: float = 0.01):
        """Ranks > 0: the next message rank 0 sends, waiting as long as it
        takes (host-side polling of the store: no collective, no timeout).
        The store's own errors, such as rank 0's store going away, raise."""
        if self.rank == 0 or self.store is None:
            raise RuntimeError("ranks > 0 of a mesh made by "
                               "init_data_parallel wait for requests")
        key = f"request/{self.requests + 1}"
        while not self.store.check([key]):
            time.sleep(poll_s)
        self.requests += 1
        message = pickle.loads(self.store.get(key))
        taken = f"taken/{self.requests}"
        if self.store.add(taken, 1) == self.world_size - 1:
            self.store.delete_key(key)  # the last rank to take it
            self.store.delete_key(taken)
        return message


def data_parallel_mesh(device=None, group=None, store=None) -> Mesh:
    """The mesh of an initialised process group (``group`` None: the
    default one) on ``device`` (the card unless the caller names the CPU;
    NCCL needs a CUDA device)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call init_data_parallel() (or "
                           "torch.distributed.init_process_group) first")
    device = resolve_device(device)
    backend = str(dist.get_backend(group))
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL mesh needs a CUDA device, got {device}")
    return Mesh(rank=dist.get_rank(group), world_size=dist.get_world_size(
        group), device=device, backend=backend, group=group, store=store)


def init_data_parallel(backend: Optional[str] = None, device=None,
                       init_method: str = "env://",
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       local_rank: Optional[int] = None,
                       timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """Start the default process group and return its mesh.

    ``rank``, ``world_size`` and ``local_rank`` default to ``torchrun``'s
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``. ``device`` "cuda" (the
    default) puts the rank on card ``LOCAL_RANK`` (modulo the cards, so that
    gloo ranks can share one) and makes it the current device; "cpu" needs
    gloo. ``backend``: NCCL by default on CUDA, which needs a card a rank
    (it raises otherwise: pass ``backend="gloo"`` for ranks that share a
    card); gloo on the CPU. ``timeout`` bounds every collective: a rank
    that stops answering fails the others, it does not hang them."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    device = resolve_device(device)
    if device.type == "cuda":
        backend = backend or "nccl"
        n_cards = torch.cuda.device_count()
        if device.index is None:
            if backend == "nccl" and local_rank >= n_cards:
                raise RuntimeError(
                    f"NCCL needs a card a rank: local rank {local_rank} of "
                    f"{n_cards} card(s); pass backend='gloo' for ranks that "
                    f"share a card")
            device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
    else:
        backend = backend or "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL mesh needs a CUDA device, got {device}")
    store, _, _ = next(dist.rendezvous(init_method, rank, world_size,
                                       timeout=timeout))
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    return data_parallel_mesh(device, store=dist.PrefixStore("dsc/", store))


def resolve_mesh(mesh, batch: int, device=None) -> Optional[Mesh]:
    """A grid's mesh: None, a ``Mesh`` (whose ranks must split ``batch``
    equally), or "auto" (the JAX package's parallel/batched.py:124-129): the
    default group's mesh on ``device`` when the group is up with more than
    one rank and ``batch`` splits equally over them, else None."""
    if mesh == "auto":
        if not (dist.is_available() and dist.is_initialized()) or \
                dist.get_world_size() == 1 or batch % dist.get_world_size():
            return None
        return data_parallel_mesh(device)
    if mesh is not None:
        mesh.rows(batch)  # raises unless the shards are equal
    return mesh


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every tensor's leading (batch) axis in ``tree``
    (tensors, or lists, tuples and dicts of them; None stays None)."""
    def rows(t):
        return t[mesh.rows(t.shape[0])]
    return _map_tensors(rows, tree)


def shard_cfg_batch(mesh: Mesh, t: torch.Tensor, batch: int) -> torch.Tensor:
    """This rank's rows of a per-sample tensor of a batch of ``batch``
    samples: with 2 ``batch`` rows, CFG-doubled as [u0..uB-1, c0..cB-1], the
    rank's rows of each half in the same layout (a plain leading-axis split
    would give rank 0 every uncond row); with ``batch`` rows, its rows."""
    r = mesh.rows(batch)
    if t.shape[0] == 2 * batch:
        return torch.cat([t[r], t[batch + r.start:batch + r.stop]])
    if t.shape[0] == batch:
        return t[r]
    raise ValueError(f"a tensor of {t.shape[0]} rows in a batch of {batch} "
                     f"samples (expected {batch} or {2 * batch})")


def replicate(mesh: Mesh, tree):
    """Rank 0's values of every tensor in ``tree`` on every rank, in place
    (one broadcast a tensor): the counterpart of the JAX package's
    replicated parameters, for a tree that the ranks did not build alike.
    Every rank calls it with a tree of the same structure. Returns
    ``tree``."""
    def bcast(t):
        dense = t.is_contiguous() or (
            t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last))
        buf = t if dense else t.contiguous()
        mesh.broadcast(buf)
        if buf is not t:
            t.copy_(buf)
        return t

    with torch.inference_mode():
        return _map_tensors(bcast, tree)


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree
