"""The world of D ranks that multi-device training runs in.

Port of linr_pcgc_tpu/parallel/mesh.py.  JAX drives D devices from one
process through a mesh; here each device is driven by a process of its own
(parallel/launch.py), and a rank sees the mesh as a ``Group``: its rank,
the group's size, its device and the transport, with the two collectives
the trainers use (a sum ``all_reduce`` and a ``broadcast``).  The 2-D (gop
x sp) split of JAX's ``make_mesh_gop_sp`` is ``Group.split``: lanes of
``sp`` consecutive ranks, sp the minor axis as in JAX.

Device binding: rank r runs on ``cuda:r``, or on ``cuda:device_ids[r]``
where the caller gives the ids, or on the CPU where the caller asks for
it.  Asking for more ranks than visible cards raises, as JAX's
``make_mesh`` does.  The transport follows from that device list alone:
NCCL where every rank has a card of its own, gloo on the CPU and where the
caller's ids repeat (several ranks sharing one card).  It is never
switched after a failure.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..device import resolve_device


def rank_devices(n: int, device=None, device_ids=None) -> list:
    """The device of each of ``n`` ranks: all on the CPU when ``device`` is
    the CPU, else rank r on ``cuda:device_ids[r]`` (``cuda:r`` by
    default).  Raises when the ranks need more cards than are visible."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    base = resolve_device(device)
    if base.type == "cpu":
        if device_ids is not None:
            raise ValueError("device ids name cards; the CPU takes none")
        return [torch.device("cpu")] * n
    if base.type != "cuda":
        raise ValueError(f"ranks run on the CPU or on CUDA cards, not {base}")
    ids = list(range(n)) if device_ids is None else [int(i) for i in device_ids]
    if len(ids) != n:
        raise ValueError(f"{len(ids)} device ids for {n} ranks")
    have = torch.cuda.device_count()
    if max(ids) >= have or min(ids) < 0:
        need = n if device_ids is None else max(ids) + 1
        raise ValueError(f"requested {need} devices, only {have} available")
    return [torch.device("cuda", i) for i in ids]


def transport(devs: list) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class Group:
    """One rank's view of a group of ranks.  ``pg`` is the process group
    (None: the default group, the whole world); ``ranks`` are the group's
    members by global rank."""

    rank: int
    size: int
    device: torch.device
    transport: str
    ranks: tuple
    pg: object = None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place; returns it.  Over gloo a
        card's tensor goes through the host (gloo's CUDA collectives are
        not all there); the transfer is the tensor itself, 0.2 MB for the
        trainer's flat gradient."""
        if self.size == 1:
            return t
        if self.transport == "gloo" and t.device.type == "cuda":
            host = t.cpu()
            dist.all_reduce(host, group=self.pg)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.pg)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``t`` with the group's rank ``src``'s, in place."""
        if self.size == 1:
            return t
        root = self.ranks[src]
        if self.transport == "gloo" and t.device.type == "cuda":
            host = t.cpu()
            dist.broadcast(host, root, group=self.pg)
            t.copy_(host)
        else:
            dist.broadcast(t, root, group=self.pg)
        return t

    def barrier(self) -> None:
        """Wait for every rank of the group (a one-element sum)."""
        self.all_reduce_(torch.zeros(1, device=self.device))

    def gather_rows(self, row: torch.Tensor) -> torch.Tensor:
        """(n,) of this rank -> (size, n) of every rank, on every rank (a
        sum of zero-padded rows: only all_reduce is needed)."""
        out = torch.zeros((self.size, row.numel()), dtype=row.dtype, device=self.device)
        out[self.rank] = row.to(self.device)
        return self.all_reduce_(out)

    def identical(self, t: torch.Tensor) -> bool:
        """Whether ``t`` holds the same bits on every rank of the group."""
        ref = self.broadcast_(t.detach().clone())
        same = torch.tensor([float(torch.equal(ref, t.detach()))], device=self.device)
        return bool(self.all_reduce_(same).item() == self.size)

    def split(self, sp: int) -> tuple:
        """The (gop x sp) split: lanes of ``sp`` consecutive ranks.
        Returns (this rank's lane index, its lane as a Group).  Every rank
        of the world calls it with the same ``sp`` (each subgroup is made
        by all of them, in one order)."""
        if self.size % sp:
            raise ValueError(f"{sp} ranks a lane do not divide {self.size}")
        lane = self.rank // sp
        mine = None
        for a in range(0, self.size, sp):
            members = tuple(self.ranks[a: a + sp])
            pg = dist.new_group(list(members)) if sp > 1 else None
            if a // sp == lane:
                mine = Group(self.rank % sp, sp, self.device, self.transport, members, pg)
        return lane, mine
