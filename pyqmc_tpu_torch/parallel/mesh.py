"""Walker data parallelism over a torch.distributed process group
(counterpart of pyqmc_tpu/parallel/mesh.py).

The JAX package runs one controller over a device mesh; PyTorch's idiom is
one process per device in a process group. Each rank holds a contiguous
slice of the walkers (rank r: [r n / R, (r + 1) n / R)) and runs the same
block as a lone process would on it:

  * the block averages are means over the mesh (`mean_over`: shards are
    equal in size, so the mean of the ranks' means is the global mean);
  * the DMC comb is global (method/dmc.py:branch): the weights, positions
    and wrap counts are gathered in rank order, one comb with a uniform
    that is the same on every rank resamples the whole population, and
    each rank keeps its slice;
  * the drivers return the whole population on every rank, gathered once
    at the end, and rank 0 alone writes files.

Backends: NCCL where each rank has a card of its own; gloo otherwise (the
CPU, or several ranks sharing one card: NCCL refuses two ranks on one
device). PyTorch documents gloo's collectives on CUDA tensors as
`broadcast` and `all_reduce` only, so the collectives here use those two
alone: a gather is an `all_reduce` (sum) over a zero-padded buffer in which
each rank fills its own slot. Nothing falls back: a rank without its
device, or a collective that fails, raises.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class WalkerMesh:
    """A process group of `size` ranks; this process is `rank`, its walkers
    live on `device`."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


def _default_device(backend, rank):
    """The rank's device: its own card under NCCL (LOCAL_RANK, else the rank
    modulo the cards), the card it shares under gloo where there is one,
    else the CPU."""
    if not torch.cuda.is_available():
        if backend == "nccl":
            raise RuntimeError("the NCCL backend needs a CUDA device on every rank")
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def walker_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None,
                device=None) -> WalkerMesh:
    """The walker mesh of this process.

    Where the caller has set up the default process group (torchrun, or
    torch.distributed.init_process_group), the mesh is that group:
    `n_devices`, if given, must be its size. Without one, only a mesh of
    one rank can be made here: a group of one on a FileStore in a new
    temporary directory (no network). backend: "nccl" or "gloo"; by
    default NCCL where there is a CUDA device, else gloo. device: the
    rank's device (default `_default_device`).
    """
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs a process group of {n_devices} "
                             "processes: start them with torchrun (or "
                             "torch.distributed.init_process_group) and call walker_mesh in each")
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="walker_mesh_"), "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"walker_mesh({n_devices}) in a process group of {size} ranks")
    group_backend = str(dist.get_backend())
    if backend is not None and backend != group_backend:
        raise ValueError(f"the process group runs {group_backend}, not {backend}")
    device = torch.device(device) if device is not None else _default_device(group_backend, rank)
    if device.type == "cuda":
        if group_backend == "nccl" and size > torch.cuda.device_count():
            raise ValueError(f"NCCL needs a card per rank: {size} ranks, "
                             f"{torch.cuda.device_count()} cards (ranks sharing a card use gloo)")
        torch.cuda.set_device(device)
    return WalkerMesh(group=dist.group.WORLD, rank=rank, size=size, device=device,
                      backend=group_backend)


def pad_to_devices(nconf, mesh):
    """The smallest multiple of the rank count >= nconf."""
    return ((nconf + mesh.size - 1) // mesh.size) * mesh.size


def check_divides(nconf, mesh, what="walker count"):
    """ValueError where `nconf` does not divide evenly over the ranks: the
    shards must be equal in size for the mean of their means to be the
    global mean."""
    if nconf % mesh.size != 0:
        raise ValueError(f"{what} {nconf} must divide evenly over {mesh.size} devices "
                         "(see parallel.mesh.pad_to_devices)")


def shard_walkers(mesh, *arrays):
    """This rank's contiguous slice of each array's leading walker axis, a
    copy on the rank's device; ValueError where a walker count does not
    divide evenly over the ranks."""
    out = []
    for a in arrays:
        n = a.shape[0]
        check_divides(n, mesh)
        m = n // mesh.size
        out.append(a[mesh.rank * m:(mesh.rank + 1) * m].to(mesh.device, copy=True))
    return out[0] if len(out) == 1 else tuple(out)


def _flat_groups(tensors):
    """{dtype: [indices]} of the tensors, complex ones by their real view's
    dtype, so one collective serves each dtype."""
    groups = {}
    for i, t in enumerate(tensors):
        dt = torch.view_as_real(t).dtype if t.is_complex() else t.dtype
        groups.setdefault(dt, []).append(i)
    return groups


def _real_view(t):
    return torch.view_as_real(t) if t.is_complex() else t


def _from_real(x, like):
    return torch.view_as_complex(x.contiguous()) if like.is_complex() else x


def _all_reduce_flat(mesh, tensors):
    """Sums over the mesh of each tensor, one all_reduce per dtype over
    their flattened concatenation."""
    tensors = list(tensors)
    out = [None] * len(tensors)
    for dt, idx in _flat_groups(tensors).items():
        parts = [_real_view(tensors[i]).reshape(-1) for i in idx]
        flat = torch.cat(parts).to(mesh.device)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        off = 0
        for i, p in zip(idx, parts):
            t = tensors[i]
            chunk = flat[off:off + p.numel()].reshape(_real_view(t).shape)
            out[i] = _from_real(chunk, t)
            off += p.numel()
    return out


def sum_over(mesh, tree):
    """The sum over the mesh of every tensor in `tree` (a tensor, or a dict,
    list or tuple of tensors), one all_reduce per dtype."""
    leaves, rebuild = _flatten(tree)
    return rebuild(_all_reduce_flat(mesh, leaves))


def mean_over(mesh, tree):
    """The mean over the ranks of every tensor in `tree`: sum_over divided
    by the rank count (a mean over walkers when every rank holds as many
    walkers and each tensor is a mean over its own)."""
    leaves, rebuild = _flatten(tree)
    return rebuild([t / mesh.size for t in _all_reduce_flat(mesh, leaves)])


def gather_walkers(mesh, *arrays):
    """Every rank's arrays concatenated in rank order along the leading
    walker axis, on every rank: an all_reduce of a zero-padded buffer per
    dtype, in which this rank fills its own slot (x + 0 is x, so the gather
    is exact). Every rank must hold as many walkers."""
    groups = _flat_groups(arrays)
    out = [None] * len(arrays)
    for dt, idx in groups.items():
        parts = [_real_view(arrays[i]).reshape(-1) for i in idx]
        chunk = sum(p.numel() for p in parts)
        buf = torch.zeros(mesh.size * chunk, dtype=dt, device=mesh.device)
        buf[mesh.rank * chunk:(mesh.rank + 1) * chunk] = torch.cat(parts).to(mesh.device)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        buf = buf.reshape(mesh.size, chunk)
        off = 0
        for i, p in zip(idx, parts):
            a = _real_view(arrays[i])
            whole = buf[:, off:off + p.numel()].reshape((mesh.size * a.shape[0],) + a.shape[1:])
            out[i] = _from_real(whole, arrays[i])
            off += p.numel()
    return out[0] if len(out) == 1 else tuple(out)


def replicate(mesh, tree):
    """Rank 0's copy of every tensor in `tree`, on every rank's device (a
    broadcast per dtype): what every rank must hold alike, such as the
    parameters."""
    leaves, rebuild = _flatten(tree)
    out = [None] * len(leaves)
    for dt, idx in _flat_groups(leaves).items():
        parts = [_real_view(leaves[i]).reshape(-1) for i in idx]
        flat = torch.cat(parts).to(mesh.device)
        dist.broadcast(flat, src=0, group=mesh.group)
        off = 0
        for i, p in zip(idx, parts):
            chunk = flat[off:off + p.numel()].reshape(_real_view(leaves[i]).shape)
            out[i] = _from_real(chunk, leaves[i])
            off += p.numel()
    return rebuild(out)


def _flatten(tree):
    """(leaves, rebuild) of a tensor or a dict, list or tuple of them."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = list(tree)
        subs = [_flatten(tree[k]) for k in keys]
        counts = [len(s[0]) for s in subs]

        def rebuild(xs):
            out, off = {}, 0
            for k, (_, rb), c in zip(keys, subs, counts):
                out[k] = rb(xs[off:off + c])
                off += c
            return out

        return [x for s in subs for x in s[0]], rebuild
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(t) for t in tree]
        counts = [len(s[0]) for s in subs]

        def rebuild(xs):
            out, off = [], 0
            for (_, rb), c in zip(subs, counts):
                out.append(rb(xs[off:off + c]))
                off += c
            return type(tree)(out)

        return [x for s in subs for x in s[0]], rebuild
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")
