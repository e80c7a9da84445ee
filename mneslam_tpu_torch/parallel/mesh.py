"""The (agent, ray) layout of the world's ranks and its collectives.

Port of `mneslam_tpu/parallel/mesh.py` on `torch.distributed`: one process
per shard runs the per-device body of the JAX `shard_map` programs, with
the named-axis collectives mapped one to one:

    lax.all_gather   -> all_gather_rows    (all_gather_into_tensor)
    lax.psum_scatter -> reduce_scatter_rows (reduce_scatter_tensor)
    lax.psum         -> all_reduce, all_reduce_sum (differentiable)
    lax.axis_index   -> AxisGroup.index

and, for the host loops of the agents' leaders (`parallel/fleet.py`),
`broadcast` from any index of a group and `all_gather_values`, a small
all-gather of host metadata.

Transport, chosen from the world's backend when it starts (`init_world`,
`transport_of`) and never after a failure: under NCCL the collectives take
device tensors as they are; under gloo every tensor is copied to host
memory, reduced or gathered there, and copied back (CPU tensors stay
where they are). Both transports sum bfloat16 in bfloat16.

`make_mesh` lays the world's ranks out as an (agent, ray) grid, row-major
(rank = agent * n_ray + ray), with the JAX package's clamping rule for the
agent count. Without a started world it is the one-process mesh: every
axis of size 1, every collective the identity.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# torch 2.13 deprecates the *_into_tensor / *_tensor names for *_single;
# older releases (2.11 on the H100 machine) have only the former
_all_gather_base = getattr(dist, "all_gather_single", None) or \
    getattr(dist, "all_gather_into_tensor", None)
_reduce_scatter_base = getattr(dist, "reduce_scatter_single", None) or \
    getattr(dist, "reduce_scatter_tensor", None)

TRANSPORTS = {"nccl": "device", "gloo": "host"}
# a collective that waits longer than this fails instead of hanging
DEFAULT_TIMEOUT_S = 600.0


def transport_of(backend: str) -> str:
    """"device" (NCCL: device tensors as they are) or "host" (gloo: copied
    through host memory) for a process-group backend; raises for others."""
    try:
        return TRANSPORTS[str(backend).lower()]
    except KeyError:
        raise ValueError(f"process-group backend {backend!r}: the port's "
                         f"collectives run on {sorted(TRANSPORTS)}") from None


@dataclass(frozen=True)
class AxisGroup:
    """The ranks of one mesh axis (or of several, combined) as seen from
    this rank: `pg` the process group (None: this process alone, every
    collective the identity), `size`, this rank's `index` in it, the
    global rank `src` of index 0, and the `transport`."""
    pg: Optional[object]
    size: int
    index: int
    src: int
    transport: str

    @property
    def is_local(self) -> bool:
        return self.pg is None


LOCAL = AxisGroup(None, 1, 0, 0, "device")


def _to_host(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    return x.detach().cpu() if group.transport == "host" else x.detach()


def all_gather_rows(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Concatenate every rank's `x` [B, ...] along rows, in rank order ->
    [size * B, ...] (`lax.all_gather(..., tiled=True)`)."""
    if group.is_local:
        return x
    xs = _to_host(x, group).contiguous()
    out = xs.new_empty((group.size * xs.shape[0],) + tuple(xs.shape[1:]))
    _all_gather_base(out, xs, group=group.pg)
    return out.to(x.device)


def reduce_scatter_rows(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Sum `x` [size * B, ...] over the ranks and keep this rank's block of
    B rows (`lax.psum_scatter(..., tiled=True)`)."""
    if group.is_local:
        return x
    if x.shape[0] % group.size:
        raise ValueError(f"{x.shape[0]} rows do not split over "
                         f"{group.size} ranks")
    xs = _to_host(x, group).contiguous()
    out = xs.new_empty((xs.shape[0] // group.size,) + tuple(xs.shape[1:]))
    _reduce_scatter_base(out, xs, group=group.pg)
    return out.to(x.device)


def all_reduce(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """The sum of `x` over the ranks, as a new tensor (`lax.psum`)."""
    if group.is_local:
        return x
    xs = _to_host(x, group).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(xs, group=group.pg)
    return xs.to(x.device)


def broadcast(x: torch.Tensor, group: AxisGroup,
              root: int = 0) -> torch.Tensor:
    """The `x` of the group's index `root` on every rank (the others pass
    a tensor of the same shape and dtype to receive into) -> a tensor on
    x's device."""
    if group.is_local:
        return x
    src = group.src if root == 0 else dist.get_global_rank(group.pg, root)
    xs = _to_host(x, group).clone(memory_format=torch.contiguous_format)
    dist.broadcast(xs, src=src, group=group.pg)
    return xs.to(x.device)


def all_gather_values(values: Sequence, group: AxisGroup,
                      dtype=torch.int64) -> torch.Tensor:
    """Host metadata exchange: every rank's `values` (numbers, the same
    count on every rank: flags, counts, frame ids, packed poses) -> a
    [size, n] tensor on the host, in rank order."""
    x = torch.as_tensor(values, dtype=dtype).reshape(1, -1)
    if group.transport == "device" and not group.is_local:
        x = x.to(torch.device("cuda", torch.cuda.current_device()))
    return all_gather_rows(x, group).cpu()


class _AllReduceSum(torch.autograd.Function):
    """psum with its transpose: forward and backward are both the sum over
    the ranks (as `torch.distributed.nn.functional.all_reduce`, here
    through the group's transport)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Differentiable sum over the ranks. The backward sums the
    cotangents, so differentiating a replicated global loss gives every
    rank `size` times its partial: the sharded mapper differentiates
    loss / size (`mneslam_tpu/mapping/mapper.py:444-451`)."""
    if group.is_local:
        return x
    return _AllReduceSum.apply(x, group)


# ---------------------------------------------------------------------------
# the world and the mesh
# ---------------------------------------------------------------------------

def init_world(device: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S):
    """Start the process group from `torchrun`'s environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR / MASTER_PORT) ->
    (rank, world size, this rank's device string). One process (no
    WORLD_SIZE or 1) starts no world and keeps `device`.

    NCCL with cuda:LOCAL_RANK when every local rank has a GPU of its own;
    gloo for `device` "cpu", and for more local ranks than GPUs (then rank
    r runs on cuda:(LOCAL_RANK mod GPUs): on one card every rank shares
    cuda:0, which NCCL does not allow). The choice is printed."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return (dist.get_rank() if dist.is_initialized() else 0,
                dist.get_world_size() if dist.is_initialized() else 1,
                device)
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cpu":
        backend, dev = "gloo", "cpu"
    else:
        n_gpu = torch.cuda.device_count()
        if n_gpu == 0:
            raise RuntimeError("device 'cuda' requested but no GPU is "
                               "visible; pass --device cpu")
        if n_gpu >= local_world:
            backend, dev = "nccl", f"cuda:{local}"
        else:
            backend, dev = "gloo", f"cuda:{local % n_gpu}"
        torch.cuda.set_device(torch.device(dev))
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    print(f"[rank {rank}] world of {world} ranks: backend {backend}, "
          f"transport {transport_of(backend)}, device {dev}", flush=True)
    return rank, world, dev


class Mesh:
    """(agent, ray) grid of the world's ranks (`jax.sharding.Mesh` of
    `make_mesh`): `shape` {"agent": A, "ray": R}, rank = a * R + r, and an
    `AxisGroup` for each axis and for both together (`group`), which
    holds this rank's index along it."""

    axis_names = ("agent", "ray")

    def __init__(self, n_agent: int, n_ray: int, rank: int,
                 groups: Dict[tuple, AxisGroup], transport: str):
        self.shape = {"agent": int(n_agent), "ray": int(n_ray)}
        self.rank = int(rank)
        self.transport = transport
        self._groups = groups

    @property
    def size(self) -> int:
        return self.shape["agent"] * self.shape["ray"]

    def group(self, axes: Sequence[str] = ("agent", "ray")) -> AxisGroup:
        """The ranks that differ from this one only along `axes`; the index
        combines the axes in the mesh's order, as the JAX package's
        `_dev_index` does."""
        key = tuple(a for a in self.axis_names if a in tuple(axes))
        if set(axes) - set(key) or not key:
            raise ValueError(f"axes {tuple(axes)} of mesh "
                             f"{self.axis_names}")
        return self._groups[key]

    def leaders(self) -> AxisGroup:
        """The agent slices' leaders (ray index 0 of every slice): on a
        leader, its `agent` group."""
        if self.group(("ray",)).index != 0:
            raise ValueError(f"rank {self.rank} follows its slice's leader")
        return self.group(("agent",))

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank}, {self.transport})"


def make_mesh(n_agents: int) -> Mesh:
    """(agent x ray) mesh over the world's ranks. When the rank count does
    not split into `n_agents` slices the agent axis clamps to the largest
    divisor of the rank count <= n_agents (at worst 1: every agent in one
    slice), as `mneslam_tpu/parallel/mesh.py:30-44` does. Every rank must
    call it (the axis groups are created collectively)."""
    started = dist.is_initialized()
    world = dist.get_world_size() if started else 1
    rank = dist.get_rank() if started else 0
    transport = transport_of(dist.get_backend()) if started else "device"
    n_agent = max(1, min(int(n_agents), world))
    while world % n_agent:
        n_agent -= 1
    n_ray = world // n_agent

    def whole():
        return AxisGroup(dist.group.WORLD, world, rank, 0, transport) \
            if started else LOCAL

    groups = {("agent", "ray"): whole()}
    a, r = rank // n_ray, rank % n_ray
    for axis, size, members_of, index in (
            ("agent", n_agent, lambda j: [i * n_ray + j
                                          for i in range(n_agent)], a),
            ("ray", n_ray, lambda i: [i * n_ray + j for j in range(n_ray)],
             r)):
        if size == 1:
            groups[(axis,)] = LOCAL
        elif size == world:
            groups[(axis,)] = whole()
        else:
            # every rank creates every group of the axis, in one order
            other = world // size
            mine = None
            for k in range(other):
                ranks = members_of(k)
                pg = dist.new_group(ranks)
                if rank in ranks:
                    mine = AxisGroup(pg, size, index, ranks[0], transport)
            groups[(axis,)] = mine
    return Mesh(n_agent, n_ray, rank, groups, transport)


# ---------------------------------------------------------------------------
# the row-sharded mapper's collective seam
# ---------------------------------------------------------------------------

class RowSeam:
    """`make_row_sharded_pack`'s result: `seam(x)` maps this rank's block
    x [B, C] of a plane in flat row-major layout (row y*W + x, rows of
    y >= H zero pad) to the full packed table [H*W, 4C] in the compute
    dtype, differentiably; `gather(x)` is its forward alone, and
    `consume(x, table)` returns `table` with the seam's backward
    (the pipelined seam of `mapping.shard_prefetch` and
    `mapping.shard_gather_every`)."""

    def __init__(self, group: AxisGroup, true_shape, pad_h: int,
                 compute_dtype, param_dtype, fold: str):
        C, H, W = (int(s) for s in true_shape)
        if fold not in ("after", "before"):
            raise ValueError(f"mapping.shard_fold {fold!r}: 'after' or "
                             "'before'")
        self.group, self.fold = group, fold
        self.C, self.H, self.W = C, H, W
        self.R, self.Rp = H * W, int(pad_h) * W
        n = group.size
        if self.Rp % n or (self.Rp // n) % W:
            raise ValueError(f"{pad_h} padded rows of {H} do not split "
                             f"over {n} ranks")
        self.B = self.Rp // n            # local block: whole y-rows
        self.hb = self.B // W
        self.compute_dtype, self.param_dtype = compute_dtype, param_dtype

    def _pack_local(self, x: torch.Tensor) -> torch.Tensor:
        """`pack_corners_hwc` on the local y-rows: equal to rows [dev*B,
        dev*B + B) of the full pack for every y < H. The y-shift needs the
        next block's first y-row (a halo, exchanged by one small
        all-gather) and the clamp at y == H-1, which lies inside a block
        only where the pad leaves it."""
        C, W, hb, n = self.C, self.W, self.hb, self.group.size
        dev = self.group.index
        xb = x.to(self.compute_dtype).reshape(hb, W, C)
        firsts = all_gather_rows(xb[0], self.group)          # [n*W, C]
        nxt = firsts[min(dev + 1, n - 1) * W:][:W]
        ext = torch.cat([xb, nxt.reshape(1, W, C)], dim=0)
        sx = torch.cat([ext[:, 1:], ext[:, -1:]], dim=1)
        yy = dev * hb + torch.arange(hb, device=x.device).reshape(hb, 1, 1)
        sy = torch.where(yy == self.H - 1, xb, ext[1:])
        sxy = torch.cat([sy[:, 1:], sy[:, -1:]], dim=1)
        packed = torch.cat([xb, sx[:hb], sy, sxy], dim=-1)
        return packed.reshape(self.B, 4 * C)

    @torch.no_grad()
    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Local pack, all-gather of the packed blocks, pad rows cut:
        [H*W, 4C], with no autograd."""
        return all_gather_rows(self._pack_local(x.detach()),
                               self.group)[:self.R]

    def _fold_block(self, blk: torch.Tensor) -> torch.Tensor:
        """The reduce-scattered packed cotangent block [B, 4C] -> the raw
        block [B, C], with the previous block's last `_fold_b_rows` row as
        the halo (one small all-gather)."""
        from ..ops import interp

        C, W, dev = self.C, self.W, self.group.index
        tail = interp._fold_b_rows(blk[-W:].reshape(1, W, 4 * C))
        tails = all_gather_rows(tail.reshape(W, C), self.group)
        prev = tails[(dev - 1) * W:dev * W] if dev > 0 else None
        return interp.fold_corners_rows(blk, self.H, W, y0=dev * self.hb,
                                        halo_row=prev)

    @torch.no_grad()
    def fold_cotangent(self, d_packed: torch.Tensor) -> torch.Tensor:
        """The table's cotangent [H*W, 4C] -> this rank's block of the
        plane's cotangent [B, C] in the param dtype. "after": reduce-scatter
        the packed rows, then fold the block; "before": fold the whole
        table, then reduce-scatter the raw rows (4x fewer bytes)."""
        from ..ops import interp

        d = d_packed
        if self.Rp > self.R:
            d = torch.cat([d, d.new_zeros((self.Rp - self.R, d.shape[1]))])
        if self.fold == "before":
            out = reduce_scatter_rows(
                interp.fold_corners_rows(d, self.H, self.W), self.group)
        else:
            out = self._fold_block(reduce_scatter_rows(d, self.group))
        return out.to(self.param_dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _SeamFn.apply(x, self)

    def consume(self, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """`table` (gathered earlier by `gather`) in the forward; the
        backward routes its cotangent through the seam's reduce-scatter
        and fold to `x`, and gives the table none.
        consume(x, gather(x)) == seam(x)."""
        return _ConsumeFn.apply(x, table, self)


class _SeamFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seam):
        ctx.seam = seam
        return seam.gather(x)

    @staticmethod
    def backward(ctx, d_packed):
        return ctx.seam.fold_cotangent(d_packed), None


class _ConsumeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, seam):
        ctx.seam = seam
        return table

    @staticmethod
    def backward(ctx, d_packed):
        return ctx.seam.fold_cotangent(d_packed), None, None


def make_row_sharded_pack(group: AxisGroup, true_shape, pad_h: int,
                          compute_dtype=torch.float32,
                          param_dtype=torch.float32,
                          fold: str = "after") -> RowSeam:
    """The row-sharded mapper's collective seam
    (`mneslam_tpu/parallel/mesh.py:101-258`): pack the local rows with a
    one-y-row halo, all-gather the packed blocks; backward, reduce-scatter
    and fold (`fold` "after" or "before", see `RowSeam.fold_cotangent`)."""
    return RowSeam(group, true_shape, pad_h, compute_dtype, param_dtype,
                   fold)


# ---------------------------------------------------------------------------
# agents as mesh slices
# ---------------------------------------------------------------------------

def all_gather_descriptors(local: torch.Tensor,
                           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Descriptor DB exchange: this slice's block of the [n_agents, K, D]
    stack -> the whole stack on every rank, by an all-gather over the
    `agent` axis. With no mesh, or one agent slice, `local` is the
    whole stack already."""
    if mesh is None:
        return local
    return all_gather_rows(local, mesh.group(("agent",)))


def tree_index(tree, i: int):
    """Agent i's slice of every tensor of a stacked nested dict/list."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_index(v, i) for v in tree]
    return tree[i]


def tree_stack(trees: List):
    """Identically shaped nested dicts/lists of tensors -> one tree whose
    tensors carry a new leading agent axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_stack([t[j] for t in trees]) for j in range(len(first))]
    return torch.stack([torch.as_tensor(t) for t in trees])


def fetch_agent_slice(stacked, rank: int):
    """One agent's tree from a stacked tree (the JAX package's cross-slice
    read of a peer's map parameters)."""
    return tree_index(stacked, rank)


def cosine_similarity_matrix(descs_a: torch.Tensor,
                             descs_b: torch.Tensor) -> torch.Tensor:
    """[Ka, D] x [Kb, D] -> [Ka, Kb] cosine similarities."""
    a = descs_a / torch.clamp(descs_a.norm(dim=-1, keepdim=True), min=1e-12)
    b = descs_b / torch.clamp(descs_b.norm(dim=-1, keepdim=True), min=1e-12)
    return a @ b.T


def make_multi_agent_train_step(scene):
    """One mapping step for every agent of a slice:
    step(params, optimizers, rays_o, rays_d, target_rgb, target_d,
    generators=None, us=None) with per-agent lists (or [A, ...] stacks of
    rays) -> the losses [A]. Within one slice the agents step in turn,
    which equals the JAX package's vmapped step (`:66`)."""

    def step(params, optimizers, rays_o, rays_d, target_rgb, target_d,
             generators=None, us=None):
        losses = []
        for i, (p, opt) in enumerate(zip(params, optimizers)):
            opt.zero_grad(set_to_none=True)
            ret = scene.forward(
                p, rays_o[i], rays_d[i], target_rgb[i], target_d[i],
                generator=None if generators is None else generators[i],
                u=None if us is None else us[i])
            loss = scene.get_loss_from_ret(ret)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses)

    return step
