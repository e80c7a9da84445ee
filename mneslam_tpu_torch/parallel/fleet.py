"""Agents as mesh slices: the mesh fleet (`--device_mesh`).

Port of `mneslam_tpu/parallel/fleet.py` at one agent slice. The JAX fleet
stacks the agents' map states on the mesh's `agent` axis and maps every
agent's pending keyframe in one sharded super-step. On one device (or on
a mesh whose agent axis clamps to 1, `mesh.make_mesh`) every agent sits in
one slice, and there the super-step is every agent's `add_keyframe` +
`optimize` in turn, which equals the vmap: each agent draws from its own
generator, as in the sequential runner, so the fleet maps exactly what
`agents.runner.MultiAgentRunner` maps.

Exchange goes through `MeshComms`: the descriptor DB is one
[n_agents, cap, D] tensor, read through `mesh.all_gather_descriptors`
with a power-of-two prefix fetch; a peer's "checkpoint" is its live map
parameters (the fleet's state of that agent), never a copy;
keyframe poses are host metadata.

The composed fleet, agents x row groups over several ranks (the JAX
`make_fleet_super_step_row_sharded`), needs a multi-controller host loop
(tracking results, descriptors and peer maps broadcast between the
slices): not ported. `MeshAgentFleet` on a world of more than one rank
raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..agents.comms import Comms
from ..agents.runner import AgentCollaboration
from ..models.droid_net import map_params
from . import mesh as pmesh

COMPOSED_ITEM = ("the mesh fleet over several ranks (agents x row groups, "
                 "the composed fleet) is not ported: ROADMAP.md Queue 1 "
                 "item 4b")


def require_one_slice():
    """Raise unless this process is a world of its own (the fleet's one
    agent slice)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(COMPOSED_ITEM)


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
    drive the host-side fusion)."""

    def __init__(self, agents: List, mesh: Optional[pmesh.Mesh] = None,
                 descriptor_fn=None, comms: Optional[MeshComms] = None):
        require_one_slice()
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
