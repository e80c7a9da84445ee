"""Factor graph: a host-managed edge table and the per-update device step.

Port of `mneslam_tpu/tracking/graph.py`. Edge bookkeeping (dedup, age-based
eviction, NMS proximity selection, keyframe index remapping) is
O(window^2) host work in numpy; everything per pixel (reprojection,
correlation lookup, ConvGRU, damping aggregation, the dense BA) runs over a
fixed-capacity padded edge table, with no host readback:

- `update_step`: the GRU half (`gru_chunk_step`) over the whole table,
  then the BA half (`ba_step`): the windowed dense BA, or with Schur pairs
  the full-buffer sparse-Schur BA;
- `update_chunked_step`: the memory-bounded update of long graphs (the
  reference's `update_lowmem`): the GRU half one chunk of edges at a time,
  a host loop that writes each chunk's hidden state, target and weight
  into the tables in place, then one BA half over all edges.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import droid_net
from ..ops import ba_sparse, correlation, projective
from . import video as video_lib


def _add_factors_step(state: video_lib.VideoState, intrinsics: torch.Tensor,
                      net_buf: torch.Tensor, target_buf: torch.Tensor,
                      weight_buf: torch.Tensor, ii: torch.Tensor,
                      jj: torch.Tensor, n0: int):
    """Device half of add_factors (factor_graph.py:110-133): hidden state,
    reprojection target and zero weight of the new edges at slots
    [n0, n0 + len(ii)), in place. Slot writes do not clamp, so the caller
    keeps n0 + len(ii) <= capacity."""
    n = ii.shape[0]
    if n0 + n > net_buf.shape[0]:
        raise ValueError(f"edge slots [{n0}, {n0 + n}) exceed the capacity "
                         f"{net_buf.shape[0]}")
    target, _ = video_lib.reproject(state, intrinsics, ii, jj)
    net_buf[n0:n0 + n] = state.nets[ii].to(net_buf.dtype)
    target_buf[n0:n0 + n] = target
    weight_buf[n0:n0 + n] = 0.0
    return net_buf, target_buf, weight_buf


def gru_chunk_step(state: video_lib.VideoState, params: Dict,
                   intrinsics: torch.Tensor, ii: torch.Tensor,
                   jj: torch.Tensor, mask: torch.Tensor, net: torch.Tensor,
                   target: torch.Tensor, update_fn=None, agg_fn=None):
    """The correlate -> ConvGRU half of an update over one set of edges
    (factor_graph.py:224-277 / 280-346): reproject, correlation lookup,
    ConvGRU, new targets and weights, and the per-frame damping scattered
    into the state. ii / jj / mask [n] (padded), net [n, 128, h, w], target
    [n, h, w, 2]. `update_fn` / `agg_fn` replace the DROID heads (the
    oracle tests). Returns (state, net, target, weight, upmask)."""
    B = state.poses.shape[0]
    ht, wd = state.disps.shape[1:]
    coords0 = projective.coords_grid(ht, wd, device=state.poses.device)

    coords1, _ = video_lib.reproject(state, intrinsics, ii, jj)
    motion = torch.cat([coords1 - coords0, target - coords1], dim=-1)
    motion = motion.clamp(-64.0, 64.0).permute(0, 3, 1, 2)

    corr = correlation.alt_corr(state.fmaps, ii, jj, coords1, mask=mask)

    if update_fn is None:
        new_net, delta, weight = droid_net.update_apply(
            params["update"], net, state.inps[ii], corr, motion)
    else:
        new_net, delta, weight = update_fn(params, state, ii, jj, net, corr,
                                           motion, coords1)
    if agg_fn is None:
        eta, upmask = droid_net.agg_apply(params["update"]["agg"], new_net,
                                          ii, mask, B)
    else:
        eta, upmask = agg_fn(params, new_net, ii, mask, B)

    # per-frame damping; padded edges write to a trash row B. Edges of one
    # frame carry equal eta, so whichever duplicate lands is right.
    ii_scatter = torch.where(mask > 0, ii, torch.full_like(ii, B))
    damping = torch.cat([state.damping, state.damping.new_zeros((1, ht, wd))])
    damping[ii_scatter] = eta.to(damping.dtype)
    state = state._replace(damping=damping[:B])
    return state, new_net, coords1 + delta, weight, upmask


def ba_step(state: video_lib.VideoState, intrinsics: torch.Tensor,
            ii: torch.Tensor, jj: torch.Tensor, mask: torch.Tensor,
            target: torch.Tensor, weight: torch.Tensor, t0: int, t1: int,
            window: int, iters: int = 2, motion_only: bool = False,
            lm: float = 1e-4, ep: float = 0.1,
            pairs: Optional[ba_sparse.SchurPairs] = None):
    """The BA half over the GRU-updated edge table: the full-buffer
    sparse-Schur BA when `pairs` are given, else the windowed dense BA."""
    if pairs is not None:
        return video_lib.full_ba(state, intrinsics, target, weight, ii, jj,
                                 mask, pairs, t0=t0, t1=t1, iters=iters,
                                 lm=lm, ep=ep, motion_only=motion_only)
    return video_lib.windowed_ba(state, intrinsics, target, weight, ii, jj,
                                 mask, t0=t0, t1=t1, window=window,
                                 iters=iters, lm=lm, ep=ep,
                                 motion_only=motion_only)


def update_step(state: video_lib.VideoState, params: Dict,
                intrinsics: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor,
                mask: torch.Tensor, net: torch.Tensor, target: torch.Tensor,
                ii_inac: torch.Tensor, jj_inac: torch.Tensor,
                mask_inac: torch.Tensor, target_inac: torch.Tensor,
                weight_inac: torch.Tensor, t0: int, t1: int, window: int,
                iters: int = 2, motion_only: bool = False, lm: float = 1e-4,
                ep: float = 0.1, update_fn=None, agg_fn=None, pairs=None):
    """One tracker update (factor_graph.py:224-277): reproject -> correlate
    -> ConvGRU -> new targets / weights / damping -> dense BA over the
    active and the given inactive edges.

    ii / jj / mask [cap] (padded), net [cap, 128, h, w], target
    [cap, h, w, 2], the inactive edges likewise; t0 / t1 host ints.
    Returns (state, net, target, weight, upmask)."""
    state, new_net, new_target, weight, upmask = gru_chunk_step(
        state, params, intrinsics, ii, jj, mask, net, target,
        update_fn=update_fn, agg_fn=agg_fn)
    state = ba_step(
        state, intrinsics, torch.cat([ii, ii_inac]), torch.cat([jj, jj_inac]),
        torch.cat([mask, mask_inac]), torch.cat([new_target, target_inac]),
        torch.cat([weight, weight_inac]), t0=t0, t1=t1, window=window,
        iters=iters, motion_only=motion_only, lm=lm, ep=ep, pairs=pairs)
    return state, new_net, new_target, weight, upmask


def update_chunked_step(state: video_lib.VideoState, params: Dict,
                        intrinsics: torch.Tensor, ii: torch.Tensor,
                        jj: torch.Tensor, mask: torch.Tensor,
                        net: torch.Tensor, target: torch.Tensor,
                        ii_inac: torch.Tensor, jj_inac: torch.Tensor,
                        mask_inac: torch.Tensor, target_inac: torch.Tensor,
                        weight_inac: torch.Tensor, t0: int, t1: int,
                        n_chunks: int, window: int, chunk: int,
                        iters: int = 2, motion_only: bool = False,
                        lm: float = 1e-4, ep: float = 0.1, update_fn=None,
                        agg_fn=None, pairs=None):
    """The memory-bounded update (the reference's `update_lowmem`,
    factor_graph.py:280-346): the GRU half over `n_chunks` chunks of
    `chunk` edges (the correlation volume and GRU activations exist only
    at chunk size), then one BA half over the whole table. The damping
    carries from chunk to chunk. `net` and `target` [cap] (cap a multiple
    of `chunk`) are updated in place, slice by slice: each chunk's outputs
    are new tensors computed before its slice is written. Chunks past
    `n_chunks` keep their net / target and get zero weight. Returns (state,
    net, target, weight, upmask) with chunk 0's upsample mask (the JAX
    function's choice)."""
    weight = torch.zeros_like(target)
    upmask = None
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        state, net_c, tgt_c, w_c, up_c = gru_chunk_step(
            state, params, intrinsics, ii[sl], jj[sl], mask[sl], net[sl],
            target[sl], update_fn=update_fn, agg_fn=agg_fn)
        net[sl] = net_c
        target[sl] = tgt_c
        weight[sl] = w_c
        if c == 0:
            upmask = up_c
    state = ba_step(
        state, intrinsics, torch.cat([ii, ii_inac]), torch.cat([jj, jj_inac]),
        torch.cat([mask, mask_inac]), torch.cat([target, target_inac]),
        torch.cat([weight, weight_inac]), t0=t0, t1=t1, window=window,
        iters=iters, motion_only=motion_only, lm=lm, ep=ep, pairs=pairs)
    return state, net, target, weight, upmask


class FactorGraph:
    """Host wrapper owning the padded edge table.

    `sparse_ba`: BA over the whole buffer with the sparse Schur assembly
    (backend graphs that span more history than the dense window holds).
    `corr_chunk`: run the GRU half in chunks of that many edges once the
    capacity (rounded up to a multiple of it) exceeds one chunk."""

    def __init__(self, buffer: int, ht: int, wd: int, capacity: int,
                 params: Dict, intrinsics: torch.Tensor, window: int = 32,
                 max_factors: int = -1, inac_capacity: Optional[int] = None,
                 update_fn=None, agg_fn=None, sparse_ba: bool = False,
                 corr_chunk: Optional[int] = None):
        self.sparse_ba = sparse_ba
        self.corr_chunk = corr_chunk
        if corr_chunk is not None:
            capacity = (capacity + corr_chunk - 1) // corr_chunk * corr_chunk
        self.update_fn = update_fn
        self.agg_fn = agg_fn
        self.buffer = buffer
        self.ht, self.wd = ht, wd
        self.capacity = capacity
        self.params = params
        self.intrinsics = intrinsics
        self.device = intrinsics.device
        self.window = window
        self.max_factors = max_factors if max_factors > 0 else capacity

        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.age = np.zeros(0, np.int64)

        # the hidden-state table has the tracker nets' dtype
        dev = self.device
        self.net = torch.zeros((capacity, 128, ht, wd),
                               dtype=droid_net.params_dtype(params),
                               device=dev)
        self.target = torch.zeros((capacity, ht, wd, 2), device=dev)
        self.weight = torch.zeros((capacity, ht, wd, 2), device=dev)

        self.cap_inac = (inac_capacity if inac_capacity is not None
                         else 2 * capacity)
        self.ii_inac = np.zeros(0, np.int64)
        self.jj_inac = np.zeros(0, np.int64)
        self.target_inac = torch.zeros((self.cap_inac, ht, wd, 2), device=dev)
        self.weight_inac = torch.zeros((self.cap_inac, ht, wd, 2), device=dev)

        self.ii_bad = np.zeros(0, np.int64)
        self.jj_bad = np.zeros(0, np.int64)
        self._upmask = None
        # Schur-pair cache: the backend runs `update` several times over
        # one edge set, and build_pairs is a host loop. Keyed on a version
        # that every index mutation bumps (add_factors, rm_factors,
        # rm_keyframe, Backend._copy_graph).
        self._edges_version = 0
        self._pairs_key = None
        self._pairs = None
        # which branches the updates took: correlation lookups (one per
        # update, or one per chunk), sparse-Schur BAs, chunked updates
        self.updates = 0
        self.lookups = 0
        self.sparse_updates = 0
        self.chunked_updates = 0

    # ------------------------------------------------------------------

    @property
    def n_active(self) -> int:
        return len(self.ii)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """Host index array -> device tensor. To a GPU it goes through
        pinned memory without blocking: a copy from pageable memory would
        wait for all queued work, once per array and update."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _padded_indices_np(self) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
        """Host copies of the active edges padded to capacity: ii, jj
        (int64), mask (fp32); `update` keeps them for the pair build."""
        ii = np.zeros(self.capacity, np.int64)
        jj = np.zeros(self.capacity, np.int64)
        m = np.zeros(self.capacity, np.float32)
        n = self.n_active
        ii[:n], jj[:n], m[:n] = self.ii, self.jj, 1.0
        return ii, jj, m

    def _padded_indices(self) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """The active edges padded to capacity on the device."""
        return tuple(self._to_dev(a) for a in self._padded_indices_np())

    def _padded_inactive_np(self, t0: int):
        """The retained inactive edges with both ends at or after t0 - 3,
        padded to cap_inac, as host (ii, jj, mask), and their stored
        targets / weights gathered to the front slots on the device."""
        ii = np.zeros(self.cap_inac, np.int64)
        jj = np.zeros(self.cap_inac, np.int64)
        m = np.zeros(self.cap_inac, np.float32)
        target, weight = self.target_inac, self.weight_inac
        if len(self.ii_inac):
            sel = (self.ii_inac >= t0 - 3) & (self.jj_inac >= t0 - 3)
            idx = np.nonzero(sel)[0][:self.cap_inac]
            k = len(idx)
            ii[:k], jj[:k], m[:k] = self.ii_inac[idx], self.jj_inac[idx], 1.0
            gather = np.zeros(self.cap_inac, np.int64)
            gather[:k] = idx
            g = self._to_dev(gather)
            target, weight = target[g], weight[g]
        return ii, jj, m, target, weight

    # ------------------------------------------------------------------

    def add_factors(self, state: video_lib.VideoState, ii, jj,
                    remove: bool = False):
        """Add deduplicated edges (factor_graph.py:88-133)."""
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        existing = set(zip(self.ii.tolist(), self.jj.tolist())) | set(
            zip(self.ii_inac.tolist(), self.jj_inac.tolist()))
        keep = np.asarray([(i, j) not in existing for i, j in zip(ii, jj)],
                          bool)
        ii, jj = ii[keep], jj[keep]
        if len(ii) == 0:
            return

        # capacity limit: evict the oldest (factor_graph.py:103-106)
        limit = min(self.max_factors, self.capacity)
        if self.n_active + len(ii) > limit and remove:
            n_evict = self.n_active + len(ii) - limit
            order = np.argsort(-self.age)
            evict = np.zeros(self.n_active, bool)
            evict[order[:n_evict]] = True
            self.rm_factors(evict, store=True)
        n_new = min(len(ii), self.capacity - self.n_active)
        ii, jj = ii[:n_new], jj[:n_new]
        if n_new == 0:
            return
        self.net, self.target, self.weight = _add_factors_step(
            state, self.intrinsics, self.net, self.target, self.weight,
            self._to_dev(ii), self._to_dev(jj), self.n_active)
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(n_new, np.int64)])
        self._edges_version += 1

    def rm_factors(self, mask: np.ndarray, store: bool = False):
        """Drop active edges; optionally archive them as inactive
        (factor_graph.py:136-160)."""
        mask = np.asarray(mask, bool)
        if mask.sum() == 0:
            return
        self._edges_version += 1
        drop = np.nonzero(mask)[0]
        keep = np.nonzero(~mask)[0]
        if store:
            n_i = len(self.ii_inac)
            k = min(len(drop), self.cap_inac - n_i)
            if k > 0:
                sel = self._to_dev(drop[:k])
                self.target_inac[n_i:n_i + k] = self.target[sel]
                self.weight_inac[n_i:n_i + k] = self.weight[sel]
                self.ii_inac = np.concatenate([self.ii_inac, self.ii[drop[:k]]])
                self.jj_inac = np.concatenate([self.jj_inac, self.jj[drop[:k]]])

        # compact the device tables (keepers to the front); skipped when
        # the permutation is the identity
        perm = np.concatenate([keep, drop])
        if not np.array_equal(perm, np.arange(len(perm))):
            p = self._to_dev(np.concatenate(
                [perm, np.arange(len(self.ii), self.capacity)]))
            self.net = self.net[p]
            self.target = self.target[p]
            self.weight = self.weight[p]
        self.ii = self.ii[keep]
        self.jj = self.jj[keep]
        self.age = self.age[keep]

    def rm_keyframe(self, state: video_lib.VideoState,
                    ix: int) -> video_lib.VideoState:
        """Remove keyframe ix: compact the buffer, remap edge indices
        (factor_graph.py:163-221)."""
        state = video_lib.remove_keyframe(state, ix)
        self._edges_version += 1  # indices renumber even when none drop
        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac = np.where(self.ii_inac >= ix, self.ii_inac - 1,
                                self.ii_inac)
        self.jj_inac = np.where(self.jj_inac >= ix, self.jj_inac - 1,
                                self.jj_inac)
        if m.any():
            keep = np.nonzero(~m)[0]
            pad = np.arange(len(m), self.cap_inac)
            perm = self._to_dev(np.concatenate([keep, np.nonzero(m)[0], pad]))
            self.target_inac = self.target_inac[perm]
            self.weight_inac = self.weight_inac[perm]
            self.ii_inac = self.ii_inac[keep]
            self.jj_inac = self.jj_inac[keep]

        m = (self.ii == ix) | (self.jj == ix)
        self.ii = np.where(self.ii >= ix, self.ii - 1, self.ii)
        self.jj = np.where(self.jj >= ix, self.jj - 1, self.jj)
        self.rm_factors(m, store=False)
        return state

    def clear_edges(self):
        self.rm_factors(np.ones(self.n_active, bool), store=False)

    # ------------------------------------------------------------------

    def update(self, state: video_lib.VideoState, t0: Optional[int] = None,
               t1: Optional[int] = None, iters: int = 2,
               use_inactive: bool = False, motion_only: bool = False,
               lm: float = 1e-4, ep: float = 0.1) -> video_lib.VideoState:
        if self.n_active == 0:
            return state
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        t0 = max(1, t0)
        if t1 is None:
            t1 = int(max(self.ii.max(), self.jj.max())) + 1

        ii_np, jj_np, m_np = self._padded_indices_np()
        ii, jj, mask = (self._to_dev(a) for a in (ii_np, jj_np, m_np))
        dev = self.device
        if use_inactive:
            ii_i_np, jj_i_np, m_i_np, tgt_i, w_i = self._padded_inactive_np(t0)
            ii_i, jj_i, m_i = (self._to_dev(a)
                               for a in (ii_i_np, jj_i_np, m_i_np))
        else:
            # no inactive edges: the BA gets the active table alone (the
            # JAX package appends cap_inac masked slots, which add zeros)
            ii_i_np = jj_i_np = np.zeros(0, np.int64)
            m_i_np = np.zeros(0, np.float32)
            ii_i = jj_i = torch.zeros(0, dtype=torch.long, device=dev)
            m_i = torch.zeros(0, device=dev)
            tgt_i, w_i = self.target_inac[:0], self.weight_inac[:0]

        pairs = None
        if self.sparse_ba:
            key = (self._edges_version, use_inactive,
                   t0 if use_inactive else None)
            if self._pairs_key != key:
                comb_ii = np.concatenate([ii_np, ii_i_np])
                comb_jj = np.concatenate([jj_np, jj_i_np])
                comb_m = np.concatenate([m_np, m_i_np]) > 0
                raw = ba_sparse.build_pairs(comb_ii, comb_jj, comb_m)
                cap = 1 << max(int(np.ceil(np.log2(max(raw.n_pairs, 1)))), 6)
                self._pairs = ba_sparse.build_pairs(
                    comb_ii, comb_jj, comb_m, capacity=cap, device=dev)
                self._pairs_key = key
            pairs = self._pairs
            self.sparse_updates += 1

        if self.corr_chunk is not None and self.capacity > self.corr_chunk:
            S = self.corr_chunk
            n_chunks = max((self.n_active + S - 1) // S, 1)
            state, net, target, weight, self._upmask = update_chunked_step(
                state, self.params, self.intrinsics, ii, jj, mask, self.net,
                self.target, ii_i, jj_i, m_i, tgt_i, w_i, t0, t1, n_chunks,
                window=self.window, chunk=S, iters=iters,
                motion_only=motion_only, lm=lm, ep=ep,
                update_fn=self.update_fn, agg_fn=self.agg_fn, pairs=pairs)
            self.chunked_updates += 1
            self.lookups += n_chunks
        else:
            state, net, target, weight, self._upmask = update_step(
                state, self.params, self.intrinsics, ii, jj, mask, self.net,
                self.target, ii_i, jj_i, m_i, tgt_i, w_i, t0, t1,
                window=self.window, iters=iters, motion_only=motion_only,
                lm=lm, ep=ep, update_fn=self.update_fn, agg_fn=self.agg_fn,
                pairs=pairs)
            self.lookups += 1
        # the tables are written in place later: own dense copies
        self.net = net.contiguous()
        self.target = target.contiguous()
        self.weight = weight.contiguous()
        self.age += 1
        self.updates += 1
        return state

    # ------------------------------------------------------------------
    # edge proposal (host side, O(window^2))
    # ------------------------------------------------------------------

    def add_neighborhood_factors(self, state, t0: int, t1: int, r: int = 3):
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1),
                             indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        keep = (np.abs(ii - jj) > 0) & (np.abs(ii - jj) <= r)
        self.add_factors(state, ii[keep], jj[keep])

    def add_proximity_factors(self, state, t: int, t0: int = 0, t1: int = 0,
                              rad: int = 2, nms: int = 2, beta: float = 0.25,
                              thresh: float = 16.0, remove: bool = False):
        """Greedy distance-sorted edge proposal with NMS
        (factor_graph.py:409-471); `t` = the keyframe count."""
        ilen, jlen = t - t0, t - t1
        if ilen <= 0 or jlen <= 0:
            return
        ii, jj = np.meshgrid(np.arange(t0, t), np.arange(t1, t),
                             indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)

        d = video_lib.frame_distance_padded(state, self.intrinsics, ii, jj,
                                            beta=beta)
        d[ii - rad < jj] = np.inf
        d[d > 100] = np.inf
        d = d.reshape(ilen, jlen)

        # suppress around existing edges
        ii1 = np.concatenate([self.ii, self.ii_bad, self.ii_inac])
        jj1 = np.concatenate([self.jj, self.jj_bad, self.jj_inac])
        for i, j in zip(ii1, jj1):
            if (t0 <= i < t) and (t1 <= j < t):
                di, dj = int(i) - t0, int(j) - t1
                d[max(0, di - nms):di + nms + 1,
                  max(0, dj - nms):dj + nms + 1] = np.inf

        es = []
        for i in range(t0, t):
            for j in range(max(i - rad, 0), i):
                es.append((i, j))
                es.append((j, i))
                di, dj = i - t0, j - t1
                if 0 <= dj < jlen:
                    d[max(0, di - nms):di + nms + 1,
                      max(0, dj - nms):dj + nms + 1] = np.inf

        flat = d.reshape(-1)
        for k in np.argsort(flat):
            if not np.isfinite(flat[k]) or flat[k] > thresh:
                break
            if len(es) > self.max_factors:
                break
            di, dj = k // jlen, k % jlen
            if d[di, dj] > thresh:
                continue
            i, j = int(ii[k]), int(jj[k])
            es += [(i, j), (j, i)]
            d[max(0, di - nms):di + nms + 1,
              max(0, dj - nms):dj + nms + 1] = np.inf

        if es:
            es = np.asarray(es)
            self.add_factors(state, es[:, 0], es[:, 1], remove)
