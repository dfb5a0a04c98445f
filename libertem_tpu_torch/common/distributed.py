"""Process-group helpers of a run over several processes (counterpart
of the JAX package's multi-host branch under ``jax.distributed``,
``docs/multihost.md``).

Under an initialised ``torch.distributed`` process group of more than
one process, every process builds the same global worker list
(:func:`global_workers`: each rank's local devices, concatenated in
rank order), reads and steps only its own workers' shards, and meets
the others only in the collectives of this module: the plan check
before the first read (:func:`check_agreement`) and the gathers of
the fold and of the nav collapse (:func:`gather_buffers`).  Every
process then holds the same replicated results.

The transport follows the group's backend (:func:`transport`): over
NCCL the tensors themselves travel, on this process's current CUDA
device; over gloo, which gathers host tensors only, they travel as host
copies (pinned where a card is involved) and are copied back to the
device they are asked for.  A collective that fails or times out
raises :class:`UDFException`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from .exceptions import UDFException

# byte alignment of each tensor in a packed buffer (complex128's size)
_ALIGN = 16


class GlobalWorker(NamedTuple):
    """A worker of a run: the process (``rank``) that owns it and its
    device in that process."""
    rank: int
    device: torch.device


def world() -> tuple[int, int]:
    """``(rank, world_size)`` of the initialised process group, else
    ``(0, 1)``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def transport() -> Optional[str]:
    """How tensors cross processes: ``"nccl"`` (device tensors) or
    ``"gloo"`` (host copies), from ``dist.get_backend()``; None with
    one process."""
    if world()[1] == 1:
        return None
    backend = str(dist.get_backend())
    if "nccl" in backend:
        return "nccl"
    if "gloo" in backend:
        return "gloo"
    raise UDFException(
        f"torch.distributed backend {backend!r} is not supported by the "
        "multi-process run: use 'nccl' (one card a process) or 'gloo'")


def _collective(what: str, fn, *args):
    try:
        return fn(*args)
    except RuntimeError as e:
        raise UDFException(
            f"{what} across {world()[1]} processes failed (a process "
            f"left the run or did not reach it): {e}") from e


def all_gather_objects(obj) -> list:
    """Every rank's ``obj``, in rank order."""
    out = [None] * world()[1]
    _collective("all_gather_object", dist.all_gather_object, out, obj)
    return out


def global_workers(local_devices: Sequence) -> list:
    """The run's workers across processes: each rank's
    ``local_devices`` (gathered once), concatenated in rank order, as
    :class:`GlobalWorker` entries; the same list on every rank.  With
    one process, the local devices themselves.  Ranks with unequal
    local worker counts raise on every rank (the gathers stay
    rectangular, as a JAX mesh over processes is)."""
    rank, size = world()
    local = [torch.device(d) for d in local_devices]
    if size == 1:
        return [GlobalWorker(0, d) for d in local]
    if transport() == "nccl":
        if not local or any(d.type != "cuda" for d in local):
            raise UDFException(
                "the nccl backend moves CUDA tensors only: give each "
                f"process its card (got {[str(d) for d in local]})")
        # the device of this rank's collectives
        torch.cuda.set_device(local[0])
    lists = all_gather_objects([str(d) for d in local])
    counts = [len(x) for x in lists]
    if len(set(counts)) > 1:
        raise UDFException(
            "every process of a run needs the same number of local "
            f"workers; local workers by rank: {counts}")
    return [GlobalWorker(r, torch.device(s))
            for r, devs in enumerate(lists) for s in devs]


def check_agreement(what: str, digest: dict) -> None:
    """Raise on every rank unless every rank's ``digest`` (a dict of
    plain values) is the same, naming the keys that differ."""
    digests = all_gather_objects(digest)
    keys = sorted(set().union(*digests))
    differ = [k for k in keys
              if len({repr(d.get(k)) for d in digests}) > 1]
    if differ:
        detail = "; ".join(
            f"{k}: " + ", ".join(f"rank {r} {str(d.get(k))[:80]}"
                                 for r, d in enumerate(digests))
            for k in differ)
        raise UDFException(
            f"the {what} differs between the processes ({detail}); every "
            "process must make the identical call")


def pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes in one flat uint8 tensor on their device,
    each padded to 16 bytes (:func:`unpack` reverses it)."""
    parts = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        if b.numel() % _ALIGN:
            parts.append(b.new_zeros(_ALIGN - b.numel() % _ALIGN))
    return torch.cat(parts)


def unpack(buf: torch.Tensor, like: Sequence[tuple]) -> list:
    """Views of ``buf`` as tensors of ``like``'s ``(shape, dtype)``
    pairs, in :func:`pack`'s layout."""
    out, off = [], 0
    for shape, dtype in like:
        size = 1
        for s in shape:
            size *= int(s)
        n = size * torch.empty((), dtype=dtype).element_size()
        out.append(buf[off:off + n].view(dtype).reshape(shape))
        off += n + (-n % _ALIGN)
    return out


def gather_tensors(local: Sequence[torch.Tensor], device) -> list:
    """One tensor per local worker (the same shape and dtype on every
    rank) -> one per global worker, in global worker order, on
    ``device``.  NCCL gathers on this process's current CUDA device;
    gloo gathers host copies, pinned where a card is involved."""
    device = torch.device(device)
    size = world()[1]
    if size == 1:
        return [t.to(device) for t in local]
    n = len(local)
    shape = (n,) + tuple(local[0].shape)
    dtype = local[0].dtype
    comm = None
    if transport() == "nccl":
        comm = torch.device("cuda", torch.cuda.current_device())
        send = torch.stack([t.to(comm) for t in local])
        out = [torch.empty_like(send) for _ in range(size)]
    else:
        pin = device.type == "cuda" or any(t.is_cuda for t in local)
        send = torch.empty(shape, dtype=dtype, pin_memory=pin)
        for i, t in enumerate(local):
            send[i].copy_(t)
        out = [torch.empty(shape, dtype=dtype, pin_memory=pin)
               for _ in range(size)]
    _collective("all_gather", dist.all_gather, out, send)
    if comm is not None:
        # NCCL returns once the collective is queued: wait for it here,
        # so that its time (and the other processes' lateness) is the
        # gather's
        torch.cuda.current_stream(comm).synchronize()
    # host to card from pinned memory may overlap; to the host it waits
    return [o[i].to(device, non_blocking=device.type == "cuda")
            for o in out for i in range(n)]


def gather_buffers(local: Sequence[Sequence[torch.Tensor]], device) -> list:
    """Per local worker a list of tensors (the same shapes and dtypes
    for every worker of every rank) -> per global worker that list, on
    ``device``: one packed byte tensor a worker, one gather."""
    like = [(tuple(t.shape), t.dtype) for t in local[0]]
    packed = gather_tensors([pack(ts) for ts in local], device)
    return [unpack(b, like) for b in packed]
