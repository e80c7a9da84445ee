"""Agents as mesh slices: the mesh fleet (`--device_mesh`).

Port of `mneslam_tpu/parallel/fleet.py`. The JAX fleet stacks the agents'
map states on the mesh's `agent` axis and maps every agent's pending
keyframe in one sharded super-step; its host loop is one controller.

In one process (`MeshAgentFleet`) every agent sits in one slice, and the
super-step is every agent's `add_keyframe` + `optimize` in turn, which
equals the vmap: each agent draws from its own generator, as in the
sequential runner, so the fleet maps exactly what
`agents.runner.MultiAgentRunner` maps. Exchange goes through `MeshComms`:
the descriptor DB is one [n_agents, cap, D] tensor, read through
`mesh.all_gather_descriptors` with a power-of-two prefix fetch; a peer's
"checkpoint" is its live map parameters (the fleet's state of that
agent), never a copy; keyframe poses are host metadata.

On a world of several ranks the fleet is composed, agents x row groups
(the JAX `make_fleet_super_step_row_sharded`), as a multi-controller host
loop: `MeshAgentFleet` there is a `ComposedFleet`. The world is the
(agent, ray) grid of `mesh.make_mesh(n_agents)`, built once by the caller
(rank = agent * R + ray); each agent slice is one agent. The slice's ray
index 0 leads it: its `ComposedFleet` runs that agent's dataset,
tracking, backend, bookkeeping, collaboration hooks and outputs. The
slice's other ranks follow (`slam.MNESLAM.follow`): with
`mapping.shard_plane_rows` they run the row-sharded mapper's collective
`optimize` in lockstep with their leader over the slice's `ray` group
alone (`Mapper(shard_axes=("ray",))`); without it the leader maps with
the plain mapper and they wait for its release (where the JAX package
replicates the plain super-step over the slice). Agents exchange over the
leaders' `agent` group only (`LeaderComms`): every decision that gates a
collective (the round's agents, the iteration count, the end of the loop,
which peer maps are fetched) comes from an all-gather over the leaders,
so every leader, and through it every follower, makes the same sequence
of collective calls.
"""

from __future__ import annotations

import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..agents.comms import Comms
from ..agents.runner import AgentCollaboration
from ..models.droid_net import map_params
from ..models.scene_rep import param_leaves
from . import mesh as pmesh


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def composed_layout(mesh: pmesh.Mesh, n_agents: int,
                    want_rows: bool) -> bool:
    """The JAX fleet's guards (`mneslam_tpu/parallel/fleet.py:238-282`)
    for `n_agents` agents on a world's `mesh` -> whether each agent's
    mapper is row-sharded over its slice (`mapping.shard_plane_rows` and
    more than one rank a slice). Raises unless every slice holds exactly
    one agent: with row sharding JAX's error, without it the port's (a
    leader runs one agent). Every rank calls it before it builds its
    agent, so a refused layout raises on every rank."""
    n_slices, n_rows = int(mesh.shape["agent"]), int(mesh.shape["ray"])
    row_sharded = bool(want_rows) and n_rows > 1
    if n_slices != int(n_agents):
        if row_sharded:
            raise ValueError(
                f"row-sharded fleet needs exactly one agent per 'agent' "
                f"slice: {n_agents} agents on a mesh with agent axis "
                f"{n_slices} (pass a mesh with agent={n_agents}, or "
                f"disable mapping.shard_plane_rows)")
        raise ValueError(
            f"the mesh fleet over a world of ranks runs one agent per "
            f"'agent' slice: {n_agents} agents on a mesh with agent axis "
            f"{n_slices} (start a world whose rank count {n_slices * n_rows}"
            f" splits into {n_agents} slices)")
    return row_sharded


class MeshComms(Comms):
    """Comms whose descriptor DB is one [n_agents, cap, D] tensor and
    whose "checkpoints" are the fleet's live map parameters."""

    def __init__(self, mesh: Optional[pmesh.Mesh], n_agents: int,
                 desc_cap: int = 1024, device="cpu"):
        self.mesh = mesh
        self.n_agents = n_agents
        self.desc_cap = desc_cap
        self.device = torch.device(device)
        self._db: Optional[torch.Tensor] = None       # [n_agents, cap, D]
        self._kf_ids: List[List[int]] = [[] for _ in range(n_agents)]
        self._kf: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._ckpt_meta: Dict[int, Dict] = {}
        self.fleet: Optional["MeshAgentFleet"] = None  # set by the fleet

    def add_descriptor(self, entry: Dict) -> None:
        vec = torch.as_tensor(np.asarray(entry["descriptor"], np.float32)
                              .reshape(-1), device=self.device)
        if self._db is None:
            self._db = torch.zeros((self.n_agents, self.desc_cap,
                                    vec.shape[0]), device=self.device)
        r = int(entry["agent_id"])
        slot = len(self._kf_ids[r])
        if slot >= self.desc_cap:
            raise RuntimeError(f"descriptor DB full for agent {r} "
                               f"(cap {self.desc_cap})")
        self._db[r, slot] = vec
        self._kf_ids[r].append(int(entry["kf_id"]))

    def descriptors(self) -> List[Dict]:
        """Every agent's descriptors, read as the filled prefix padded to
        the next power of two (the host knows the fill counts; a fetch of
        the whole capacity per keyframe would move cap x D floats)."""
        if self._db is None:
            return []
        n_max = max(len(ids) for ids in self._kf_ids)
        if n_max == 0:
            return []
        pad = min(self.desc_cap,
                  1 << (n_max - 1).bit_length() if n_max > 1 else 1)
        gathered = pmesh.all_gather_descriptors(self._db, self.mesh)
        full = gathered[:, :pad].cpu().numpy()
        return [{"descriptor": full[r, i], "kf_id": kf, "agent_id": r}
                for r in range(self.n_agents)
                for i, kf in enumerate(self._kf_ids[r])]

    def publish_keyframes(self, rank, poses, timestamps):
        self._kf[rank] = (np.asarray(poses).copy(),
                          np.asarray(timestamps).copy())

    def get_keyframes(self, rank):
        return self._kf.get(rank)

    def publish_checkpoint(self, rank, params, meta):
        # the parameters live in the fleet's states: record the metadata
        self._ckpt_meta[rank] = dict(meta)

    def get_checkpoint(self, rank):
        if self.fleet is None or rank not in self._ckpt_meta:
            return None
        # the live parameters' storage, outside autograd
        return map_params(self.fleet.state[rank].params,
                          lambda t: t.detach()), self._ckpt_meta[rank]


def make_fleet_super_step(mapper):
    """One super-step mapping every agent's pending keyframe:
    step(states, frame_ids, frames, poses, generators, valids, iters)
    -> the metrics stacked [A] (zeros for an agent with valid False, whose
    state is left as it is). Each valid agent runs `add_keyframe` +
    `optimize` on its own state and generator, in turn."""

    def step(states, frame_ids, frames, poses, generators, valids, iters):
        out = []
        for st, fid, frame, pose, gen, valid in zip(
                states, frame_ids, frames, poses, generators, valids):
            if not valid:
                out.append({k: torch.zeros((), device=mapper.device)
                            for k in ("loss", "psnr", "rgb_loss",
                                      "depth_loss")})
                continue
            mapper.add_keyframe(st, int(fid), frame, pose, gen)
            _, metrics = mapper.optimize(st, frame, pose, gen, iters=iters)
            out.append(metrics)
        return pmesh.tree_stack(out)

    return step


class MeshAgentFleet:
    """Multi-agent runner whose every round maps all agents' pending
    keyframes in one super-step. The agents share the scene and mapper
    shapes (the same bound and resolutions; per-agent `loop_bound`s still
    drive the host-side fusion). On a world of several ranks it is the
    composed fleet (`ComposedFleet`)."""

    def __new__(cls, *args, **kwargs):
        if cls is MeshAgentFleet and _world_size() > 1:
            cls = ComposedFleet
        return super().__new__(cls)

    def __init__(self, agents: List, mesh: Optional[pmesh.Mesh] = None,
                 descriptor_fn=None, comms: Optional[MeshComms] = None):
        self.agents = agents
        n = len(agents)
        self.mesh = mesh if mesh is not None else pmesh.make_mesh(n)
        self.mapper = agents[0].mapper

        def shapes(a):
            ms = a.map_state
            return ([tuple(t.shape) for t in _leaves(ms.params)]
                    + [tuple(ms.db.rays.shape), tuple(ms.kf_poses.shape)])

        if any(shapes(a) != shapes(agents[0]) for a in agents[1:]):
            raise ValueError("mesh fleet requires identical map-state shapes "
                             "across agents (shared bound/resolution config)")
        # the agents' own states, live: agent i's view is state[i]
        self.state = [a.map_state for a in agents]
        # one descriptor slot per possible keyframe, or the config's
        # override: a "DB full" error must not be reachable mid-run
        cap = int(agents[0].config.get("loop_detection", {})
                  .get("desc_cap", 0))
        if cap <= 0:
            cap = max(len(a.dataset) for a in agents) + 1
        self.comms = comms or MeshComms(self.mesh, n, desc_cap=cap,
                                        device=agents[0].device)
        self.comms.fleet = self
        self.collabs = [AgentCollaboration(a, self.comms,
                                           descriptor_fn=descriptor_fn)
                        for a in agents]
        for a, c in zip(agents, self.collabs):
            a.collab = c
        self._super_step = make_fleet_super_step(self.mapper)

    # ------------------------------------------------------------------

    def _sync_agent_views(self):
        """Point each agent's map_state at its state in the fleet."""
        for a, st in zip(self.agents, self.state):
            a.map_state = st

    def _writeback(self, i: int, map_state):
        """An agent-local update (a distillation) back into the fleet."""
        self.state[i] = map_state

    def _round(self, sel: List[int], frame_ids: List[int], poses, iters):
        """One super-step over the agents `sel` (frames from each agent's
        dataset) -> per-agent metrics."""
        agents = self.agents
        valids = [i in sel for i in range(len(agents))]
        frames = [dict(agents[i]._frame_for_mapping(frame_ids[i])[0],
                       frame_id=frame_ids[i]) if valids[i] else None
                  for i in range(len(agents))]
        metrics = self._super_step(
            self.state, frame_ids, frames, poses,
            [a.generator for a in agents], valids, iters=iters)
        self._sync_agent_views()
        return frames, metrics

    def run_mapping_only(self):
        """Mapping-only run: every round, all agents' keyframes of that
        frame index in one super-step; then each mapped agent's
        bookkeeping (log, publish, loop detection and closure) -> the
        agents' metric logs, after the bound-overlap fusion."""
        agents = self.agents
        max_len = max(len(a.dataset) for a in agents)
        every = int(agents[0].config["mapping"]["keyframe_every"])
        for idx in range(0, max_len, every):
            sel = [i for i, a in enumerate(agents) if idx < len(a.dataset)]
            if not sel:
                continue
            firsts = [not agents[i].first_frame_mapped for i in sel]
            if any(firsts) and not all(firsts):
                raise RuntimeError("mesh fleet requires agents to bootstrap "
                                   "in the same round")
            iters = int(agents[0].config["mapping"][
                "first_iters" if firsts[0] else "iters"])
            poses = [agents[i]._frame_for_mapping(idx)[1] if i in sel
                     else None for i in range(len(agents))]
            frames, metrics = self._round(sel, [idx] * len(agents), poses,
                                          iters)
            for i in sel:
                a = agents[i]
                a.first_frame_mapped = True
                # the collaboration hook reads the raw keyframe poses
                # (`kf_poses_raw`), never the aligned map slots: under
                # loop_closure.map_aligned the closure writes the deformed
                # poses into the agent's (live) map state, and deforming
                # those again on the next publish would compound the
                # correction every round
                a._post_map_bookkeeping(idx, frames[i], poses[i],
                                        pmesh.tree_index(metrics, i))
        for a in agents:
            a._flush_metrics()
        self._final_fusion()
        return [a.metrics_log for a in agents]

    def run_slam(self):
        """Multi-agent SLAM: per-agent tracking, then one super-step per
        pass over every agent's pending keyframes, then the periodic
        global BAs; at the end the fusion and each agent's terminate."""
        agents = self.agents
        alive = [a.tracker is not None for a in agents]
        while any(alive):
            for i, a in enumerate(agents):
                if alive[i]:
                    alive[i] = a.track_step()
            self._map_pending()
            for a in agents:
                a.maybe_global_ba()
        self._map_pending()
        for a in agents:
            a._flush_metrics()
        self._final_fusion()
        return [a.terminate() for a in agents]

    def _map_pending(self):
        """Map every agent's pending keyframes in super-steps, one group
        per pass: bootstrapping agents (`first_iters`) first, then the
        others (`iters`). The group is a snapshot, so an agent
        bootstrapped in this pass does not map again off the same entry."""
        agents = self.agents
        cfg0 = agents[0].config["mapping"]
        while True:
            pend = [a.pending_keyframe() for a in agents]
            if all(p is None for p in pend):
                return
            first_sel = [i for i, p in enumerate(pend) if p is not None
                         and not agents[i].first_frame_mapped]
            sel = first_sel or [i for i, p in enumerate(pend)
                                if p is not None]
            iters = int(cfg0["first_iters" if first_sel else "iters"])
            fids = [pend[i][1] if i in sel else 0 for i in range(len(agents))]
            poses = [pend[i][2] if i in sel else None
                     for i in range(len(agents))]
            frames, metrics = self._round(sel, fids, poses, iters)
            for i in sel:
                a = agents[i]
                a.first_frame_mapped = True
                a.map_counter += 1
                a._post_map_bookkeeping(fids[i], frames[i], poses[i],
                                        pmesh.tree_index(metrics, i))

    def _final_fusion(self):
        """The bound-overlap fusion of every agent; a distillation's
        update is written back into the fleet."""
        for i, a in enumerate(self.agents):
            before = a.map_state
            a.collab.bound_based_fusion()
            if a.map_state is not before:
                self._writeback(i, a.map_state)
                self._sync_agent_views()


def _leaves(tree) -> list:
    out = []
    map_params(tree, out.append)
    return out


# ---------------------------------------------------------------------------
# the composed fleet: one agent per slice of a world of ranks
# ---------------------------------------------------------------------------

def _flat(params) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float()
                      for t in param_leaves(params)])


def _like(template, flat: torch.Tensor):
    """`flat` (`_flat` of a tree shaped as `template`) as such a tree."""
    chunks, off = {}, 0
    for t in param_leaves(template):
        chunks[id(t)] = flat[off:off + t.numel()].view_as(t).to(t.dtype)
        off += t.numel()
    return map_params(template, lambda t: chunks[id(t)])


class LeaderComms(Comms):
    """The exchange of one leader of the composed fleet. Every leader keeps
    a replica of each agent's published keyframes, bound and descriptors,
    filled once a round by collectives over the leaders' group
    (`exchange`), and the peer maps its hook loads this round, broadcast
    by their owners (`fetch`). It keeps the one-slice fleet's visibility,
    where the hooks run in agent order after the round's super-step: the
    hook of agent `me` sees this round's descriptor and keyframes of the
    agents before it, only earlier rounds' of the agents after it, and
    a peer's map as it stands after this round's step. After the last
    round (`final`) everything is visible."""

    def __init__(self, leaders: pmesh.AxisGroup, n_agents: int, me: int,
                 agent):
        self.leaders, self.n_agents, self.me = leaders, n_agents, me
        self.agent = agent
        self.round = 0
        self.final = False
        self._desc: List[List] = [[] for _ in range(n_agents)]
        self._kf: List[List] = [[] for _ in range(n_agents)]
        self._meta: Dict[int, Tuple[int, Dict]] = {}
        self._published = None        # this agent's (poses, ts, meta)
        self._peer: Dict[int, Dict] = {}
        self.maps_received = 0        # read by the chip smoke test

    def _seen(self, agent: int, rnd: int) -> bool:
        return self.final or rnd < self.round or agent < self.me

    # -- the Comms interface, read by AgentCollaboration ------------------

    def descriptors(self) -> List[Dict]:
        return [{"descriptor": d, "kf_id": kf, "agent_id": o}
                for o in range(self.n_agents)
                for rnd, kf, d in self._desc[o] if self._seen(o, rnd)]

    def publish_keyframes(self, rank, poses, timestamps):
        self._published = (np.asarray(poses, np.float32).copy(),
                           np.asarray(timestamps, np.float64).copy(), None)

    def publish_checkpoint(self, rank, params, meta):
        poses, ts, _ = self._published
        self._published = (poses, ts, dict(meta))

    def get_keyframes(self, rank):
        seen = [(p, t) for rnd, p, t in self._kf[rank]
                if rank == self.me or self._seen(rank, rnd)]
        return seen[-1] if seen else None

    def _ckpt_meta(self, rank) -> Optional[Dict]:
        rnd, meta = self._meta.get(rank, (None, None))
        if meta is None or not (rank == self.me or self._seen(rank, rnd)):
            return None
        return meta

    def get_checkpoint(self, rank):
        meta = self._ckpt_meta(rank)
        if meta is None:
            return None
        if rank == self.me:
            return map_params(self.agent.map_state.params,
                              lambda t: t.detach()), meta
        if rank not in self._peer:
            raise RuntimeError(f"agent {self.me} reads agent {rank}'s map, "
                               "which its owner did not serve this round")
        return self._peer[rank], meta

    # -- the collectives over the leaders ----------------------------------

    def exchange(self, kf_id: Optional[int], des: Optional[np.ndarray]):
        """Start a round: every agent's keyframes and bound published this
        round, and its descriptor (all-gathered over the leaders, as
        `mesh.all_gather_descriptors`), into every leader's replica.
        `kf_id` None: this agent did not map this round."""
        self.round += 1
        mine = self._published if kf_id is not None else None
        self._published = None
        n_kf = 0 if mine is None else len(mine[1])
        dim = 0 if des is None else int(np.asarray(des).size)
        head = pmesh.all_gather_values(
            [int(mine is not None), kf_id or 0, n_kf, dim], self.leaders)
        width = max(6 + 17 * int(n) for n in head[:, 2])
        pay = np.zeros(width, np.float64)
        if mine is not None:
            poses, ts, meta = mine
            parts = [np.asarray(meta["bound"], np.float64).ravel(),
                     poses.astype(np.float64).ravel(), ts]
            flat = np.concatenate(parts)
            pay[:flat.size] = flat
        pays = pmesh.all_gather_values(pay, self.leaders,
                                       dtype=torch.float64).numpy()
        dims = {int(d) for d in head[:, 3] if d > 0}
        if len(dims) > 1:
            raise ValueError(f"the agents' descriptors differ in size: "
                             f"{sorted(dims)}")
        descs = None
        if dims:
            local = torch.zeros((1, 1, dims.pop()), device=self.agent.device)
            if des is not None:
                local[0, 0] = torch.as_tensor(
                    np.asarray(des, np.float32).reshape(-1))
            descs = pmesh.all_gather_rows(local, self.leaders).cpu().numpy()
        for o in range(self.n_agents):
            valid, kf, n, dim = (int(v) for v in head[o])
            if not valid:
                continue
            row = pays[o]
            bound = row[:6].reshape(3, 2).astype(np.float32)
            poses = row[6:6 + 16 * n].reshape(n, 4, 4).astype(np.float32)
            ts = row[6 + 16 * n:6 + 17 * n].copy()
            # the last earlier round's and this round's are all it reads
            self._kf[o] = self._kf[o][-1:] + [(self.round, poses, ts)]
            if o not in self._meta:
                self._meta[o] = (self.round, {"bound": bound})
            if dim:
                self._desc[o].append((self.round, kf, descs[o, 0].copy()))

    def fetch(self, need: Optional[int]):
        """Each agent's map that another agent's hook loads this round
        (`need`: this agent's, from `AgentCollaboration.peer_needed`, or
        None), broadcast over the leaders by its owner, in agent order."""
        want = need if (need is not None and need != self.me
                        and self._ckpt_meta(need) is not None) else -1
        req = pmesh.all_gather_values([want], self.leaders)[:, 0].tolist()
        self.serve(sorted({o for o in req if o >= 0}), keep=want >= 0)

    def serve(self, owners: List[int], keep: bool):
        """The maps of `owners`, in that order, each broadcast over the
        leaders by its owner as it stands now; with `keep` this leader
        keeps the ones it receives (`_peer`, read by `get_checkpoint`)."""
        self._peer = {}
        params = self.agent.map_state.params
        size = sum(t.numel() for t in param_leaves(params))
        for o in owners:
            if o == self.me:
                pmesh.broadcast(_flat(params), self.leaders, root=o)
                continue
            got = pmesh.broadcast(
                torch.empty(size, device=self.agent.device), self.leaders,
                root=o)
            if keep:
                self._peer[o] = _like(params, got)
                self.maps_received += 1


class ComposedFleet(MeshAgentFleet):
    """The mesh fleet on a world of ranks, as run by one slice's leader
    for its one agent (`agents` = [it]; `n_agents` the fleet's agents;
    `mesh` the world's, which the agent was built with). Its rounds are
    the one-slice fleet's: the same agents map in the same rounds with the
    same iteration counts, and their hooks see what the one-slice fleet's
    hooks see (`LeaderComms`). The super-step is this leader's
    `add_keyframe` + collective `optimize` with its followers (skipped in
    a round its agent has nothing to map: they get no map call then)."""

    def __init__(self, agents: List, mesh: Optional[pmesh.Mesh] = None,
                 descriptor_fn=None, comms: Optional[LeaderComms] = None,
                 n_agents: Optional[int] = None):
        if mesh is None:
            raise ValueError("the composed fleet runs on the mesh its agent "
                             "was built with (`mesh.make_mesh`, once)")
        n = int(n_agents or len(agents))
        want_rows = bool(agents[0].config["mapping"].get(
            "shard_plane_rows", False))
        self.row_sharded = composed_layout(mesh, n, want_rows)
        if want_rows and not self.row_sharded:
            print("[fleet] mapper mesh ignored under the mesh fleet "
                  "(no spare devices for a per-agent row group)")
        self.mesh, self.n = mesh, n
        self.me = mesh.rank // int(mesh.shape["ray"])
        if len(agents) != 1 or agents[0].rank != self.me \
                or agents[0].follower:
            raise ValueError(f"rank {mesh.rank} leads agent {self.me}: the "
                             f"fleet takes that one agent, built as its "
                             f"slice's leader")
        self.leaders = mesh.leaders()
        self.agent = a = agents[0]
        sig = self._gather([len(a.dataset)] + _shape_signature(a))
        if (sig[:, 1:] != sig[:1, 1:]).any():
            raise ValueError("mesh fleet requires identical map-state shapes "
                             "across agents (shared bound/resolution config)")
        self.lengths = sig[:, 0].tolist()
        mp = a.config["mapping"]
        # agent 0's schedule, as the one-slice fleet reads it
        self.schedule = self._gather([int(mp["keyframe_every"]),
                                      int(mp["first_iters"]),
                                      int(mp["iters"])])[0].tolist()
        self.comms = comms or LeaderComms(self.leaders, n, self.me, a)
        self.collab = AgentCollaboration(a, self.comms,
                                         descriptor_fn=descriptor_fn)
        self.collabs = [self.collab]
        a.collab = self.collab

    def _gather(self, values) -> np.ndarray:
        return pmesh.all_gather_values(values, self.leaders).numpy()

    # ------------------------------------------------------------------

    def _step(self, frame_id: int, frame: Dict, pose, iters: int):
        """This agent's part of the super-step: `add_keyframe` + the
        collective `optimize`, its followers led through the call."""
        a = self.agent
        a.mapper.add_keyframe(a.map_state, int(frame_id), frame, pose,
                              a.generator)
        a._lead(frame, pose, iters)
        _, metrics = a.mapper.optimize(a.map_state, frame, pose,
                                       a.generator, iters=iters)
        return metrics

    def _map(self, frame_id: int, frame: Dict, pose, iters: int):
        """Map this agent's keyframe and run its bookkeeping with the
        collaboration hook held back -> the hook's arguments."""
        a = self.agent
        frame = dict(frame, frame_id=frame_id)
        metrics = self._step(frame_id, frame, pose, iters)
        a.first_frame_mapped = True
        held = []
        a.collab = types.SimpleNamespace(
            on_keyframe_mapped=lambda *args: held.append(args))
        try:
            a._post_map_bookkeeping(frame_id, frame, pose, metrics)
        finally:
            a.collab = self.collab
        return held[0]

    def _hooks(self, held):
        """The round's collaboration hooks (every leader; `held` None when
        this agent did not map): publish and describe, the exchange, the
        match against the DB as this agent sees it, the peer maps that the
        matches load, then the loop closure."""
        c, comms = self.collab, self.comms
        des = info = need = None
        if held is not None:
            kf_id, rgb, cur_c2w, kf_poses, kf_ts = held
            c.publish(kf_poses, kf_ts)
            if c.enable_loop_detect:
                des = c.loop_detector.describe(rgb)
        comms.exchange(None if held is None else int(kf_id), des)
        if des is not None:
            info = c.loop_detector.match(des, kf_id, self.me)
            if info is not None:
                need = c.peer_needed(info, kf_id)
        comms.fetch(need)
        if info is not None:
            c.handle_loop_closure(info, kf_id, cur_c2w, kf_poses, kf_ts)

    # ------------------------------------------------------------------

    def run_mapping_only(self):
        """The one-slice fleet's mapping-only rounds, this agent's part ->
        [its metrics log], after the bound-overlap fusion."""
        a = self.agent
        every, first_iters, iters = self.schedule
        for idx in range(0, max(self.lengths), every):
            valid = idx < len(a.dataset)
            flags = self._gather([int(valid), int(not a.first_frame_mapped)])
            firsts = [bool(f) for v, f in flags if v]
            if not firsts:
                continue
            if any(firsts) and not all(firsts):
                raise RuntimeError("mesh fleet requires agents to bootstrap "
                                   "in the same round")
            held = None
            if valid:
                frame, pose = a._frame_for_mapping(idx)
                held = self._map(idx, frame, pose,
                                 first_iters if firsts[0] else iters)
            self._hooks(held)
        a._flush_metrics()
        self._final_fusion()
        return [a.metrics_log]

    def run_slam(self):
        """The one-slice fleet's SLAM loop, this agent's part: track, map
        the pending keyframes in passes, the periodic global BA, until no
        agent is alive; then the fusion and the terminate -> [its
        result]."""
        a = self.agent
        alive = a.tracker is not None
        while self._gather([int(alive)])[:, 0].any():
            if alive:
                alive = a.track_step()
            self._map_pending()
            a.maybe_global_ba()
        self._map_pending()
        a._flush_metrics()
        self._final_fusion()
        return [a.terminate()]

    def _map_pending(self):
        """Passes over the agents' pending keyframes, grouped as the
        one-slice fleet groups them (bootstrapping agents first)."""
        a = self.agent
        _, first_iters, iters = self.schedule
        while True:
            pend = a.pending_keyframe()
            flags = self._gather([int(pend is not None),
                                  int(not a.first_frame_mapped)])
            if not flags[:, 0].any():
                return
            first_sel = [i for i, (p, f) in enumerate(flags) if p and f]
            sel = first_sel or [i for i, (p, _) in enumerate(flags) if p]
            held = None
            if self.me in sel:
                _, fid, pose = pend
                frame, _ = a._frame_for_mapping(fid)
                held = self._map(fid, frame, pose,
                                 first_iters if first_sel else iters)
                a.map_counter += 1
            self._hooks(held)

    def _final_fusion(self):
        """The bound-overlap fusion in agent order, as the one-slice fleet
        runs it: agent i distils from the maps of its plan, each as it
        stands when i's turn comes (distilled already if its agent comes
        before i). The followers are released first: no map call
        follows."""
        self.agent.release_followers()
        comms = self.comms
        comms.final = True
        mine = [o for o, _ in self.collab.fusion_plan()
                if comms._ckpt_meta(o) is not None]
        plans = self._gather([int(o in mine) for o in range(self.n)])
        for i in range(self.n):
            comms.serve([o for o in range(self.n) if plans[i][o]],
                        keep=i == self.me)
            if i == self.me:
                self.collab.bound_based_fusion()


def _shape_signature(agent) -> List[int]:
    """The map state's shapes as a few integers (the leaves' count and
    sizes, the keyframe DB and pose slots)."""
    ms = agent.map_state
    sizes = [t.numel() for t in param_leaves(ms.params)]
    return ([len(sizes), sum(sizes),
             sum((k + 1) * n for k, n in enumerate(sizes))]
            + list(ms.db.rays.shape) + [ms.kf_poses.shape[0]])
