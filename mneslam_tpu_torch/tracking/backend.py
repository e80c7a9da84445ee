"""Tracking backend: dense and loop bundle adjustment over keyframe history.

Port of `mneslam_tpu/tracking/backend.py`: edges proposed greedily by
sorted frame distance with radius / NMS suppression (the loop variant adds
a cluster test), then `steps` GRU / BA updates over a fresh factor graph.
Spans of more than SPARSE_BA_THRESHOLD frames solve with the full-buffer
sparse-Schur BA (`ops/ba_sparse.py`); graphs of more than `corr_chunk`
edge slots run the chunked update.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import video as video_lib
from .dist_cache import FrameDistanceCache
from .graph import FactorGraph


class Backend:
    # beyond this many frames the windowed dense solver's memory grows as
    # N * N * 6 * HW: switch to the sparse-Schur path
    SPARSE_BA_THRESHOLD = 64

    def __init__(self, params, intrinsics, config, buffer: int, ht: int,
                 wd: int, update_fn=None, agg_fn=None):
        be = config["tracking"]["backend"]
        self.params = params
        self.intrinsics = intrinsics
        self.buffer = buffer
        self.ht, self.wd = ht, wd
        self.beta = config["tracking"]["beta"]
        self.thresh = be["thresh"]
        self.radius = be["radius"]
        self.nms = be["nms"]
        self.loop_window = be["loop_window"]
        self.loop_thresh = be["loop_thresh"]
        self.loop_radius = be["loop_radius"]
        self.loop_nms = be["loop_nms"]
        # edges per GRU pass of a long graph (the reference's update_lowmem
        # memory bound, in edges)
        self.corr_chunk = int(be.get("corr_chunk", 256))
        self.update_fn = update_fn
        self.agg_fn = agg_fn
        cc = be.get("dist_cache", {})
        self.dist_cache = None
        if bool(cc.get("enabled", True)):
            self.dist_cache = FrameDistanceCache(
                buffer, pose_tol=float(cc.get("pose_tol", 1e-4)),
                disp_tol=float(cc.get("disp_tol", 1e-3)), beta=self.beta)
        # what the calls did: BAs run, and their graphs' updates summed by
        # branch (FactorGraph's counters of the same names)
        self.dense_bas = 0
        self.loop_bas = 0
        self.updates = 0
        self.lookups = 0
        self.sparse_updates = 0
        self.chunked_updates = 0

    def _make_graph(self, max_factors: int, window: int) -> FactorGraph:
        window_cap = int(2 ** np.ceil(np.log2(max(window + 8, 16))))
        window_cap = min(window_cap, self.buffer)
        return FactorGraph(
            self.buffer, self.ht, self.wd, capacity=max_factors + 16,
            params=self.params, intrinsics=self.intrinsics,
            window=window_cap, max_factors=max_factors,
            update_fn=self.update_fn, agg_fn=self.agg_fn,
            sparse_ba=window > self.SPARSE_BA_THRESHOLD,
            corr_chunk=(self.corr_chunk
                        if max_factors + 16 > self.corr_chunk else None))

    def _propose_edges(self, state, t_start: int, t_end: int,
                       t_start_loop: int, radius: int, nms: int,
                       thresh: float, max_factors: int,
                       loop: bool) -> np.ndarray:
        """backend.py:25-99: greedy distance-sorted proposal -> [n, 2]."""
        ilen, jlen = t_end - t_start_loop, t_end - t_start
        if ilen <= 0 or jlen <= 0:
            return np.zeros((0, 2), np.int64)
        ii, jj = np.meshgrid(np.arange(t_start_loop, t_end),
                             np.arange(t_start, t_end), indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)

        if self.dist_cache is not None:
            d = self.dist_cache.distance_grid(state, self.intrinsics, ii, jj,
                                              t_end)
        else:
            d = video_lib.frame_distance_padded(
                state, self.intrinsics, ii, jj,
                beta=self.beta).astype(np.float64)
        rawd = d.copy().reshape(ilen, jlen)
        d[ii - radius < jj] = np.inf
        d[d > thresh] = np.inf
        d = d.reshape(ilen, jlen)

        es = []
        for i in range(t_start_loop, t_end):
            for j in range(max(i - radius, t_start_loop), i):
                es.append((i, j))
                es.append((j, i))
                di, dj = i - t_start_loop, j - t_start
                d[max(0, di - nms):di + nms + 1,
                  max(0, dj - nms):dj + nms + 1] = np.inf

        flat = d.reshape(-1)
        n_neighboring = 1
        for k in np.argsort(flat):
            if not np.isfinite(flat[k]) or flat[k] > thresh:
                break
            if len(es) > max_factors:
                break
            di, dj = k // jlen, k % jlen
            if d[di, dj] > thresh:
                continue
            i, j = int(ii[k]), int(jj[k])
            if loop:
                # a cluster of nearby consistent pairs (backend.py:79-89)
                sub_es, num_loop = [], 0
                for si in range(max(i - n_neighboring, t_start_loop),
                                min(i + n_neighboring + 1, t_end)):
                    for sj in range(max(j - n_neighboring, t_start),
                                    min(j + n_neighboring + 1, t_end)):
                        if rawd[si - t_start_loop, sj - t_start] <= thresh:
                            num_loop += 1
                            if si != sj:
                                sub_es.append((si, sj))
                if num_loop > int(((n_neighboring * 2 + 1) ** 2) * 0.5):
                    es += sub_es
            else:
                es += [(i, j), (j, i)]
            d[max(0, di - nms):di + nms + 1,
              max(0, dj - nms):dj + nms + 1] = np.inf

        return np.asarray(es, np.int64).reshape(-1, 2)

    def _run(self, state, graph: FactorGraph, es: np.ndarray, t0: int,
             t1: int, steps: int, motion_only: bool, loop: bool):
        if len(es) < 3:
            return state, 0
        graph.add_factors(state, es[:, 0], es[:, 1], remove=True)
        n_edges = graph.n_active
        lm, ep = (1e-4, 1e-1) if loop else (1e-5, 1e-2)  # factor_graph.py:338
        for _ in range(steps):
            state = graph.update(state, t0=t0, t1=t1, iters=2,
                                 motion_only=motion_only, lm=lm, ep=ep)
        graph.clear_edges()
        for name in ("updates", "lookups", "sparse_updates",
                     "chunked_updates"):
            setattr(self, name, getattr(self, name) + getattr(graph, name))
        return state, n_edges

    def dense_ba(self, state, counter: int, t_start: int = 0,
                 t_end: Optional[int] = None, steps: int = 6,
                 motion_only: bool = False):
        """Full-history BA (backend.py:126-139) -> (state, n, n_edges)."""
        if t_end is None:
            t_end = counter
        n = t_end - t_start
        max_factors = (self.radius + 2) * 2 * n
        graph = self._make_graph(max_factors, window=n)
        es = self._propose_edges(state, t_start, t_end, t_start, self.radius,
                                 self.nms, self.thresh, max_factors,
                                 loop=False)
        state, n_edges = self._run(state, graph, es, t_start + 1, t_end,
                                   steps, motion_only, loop=False)
        self.dense_bas += 1
        return state, n, n_edges

    def loop_ba(self, state, counter: int, t_start: int, t_end: int,
                steps: int = 6, motion_only: bool = False,
                local_graph: Optional[FactorGraph] = None):
        """Windowed loop BA (backend.py:143-164): poses move inside
        [t_end - loop_window, t_end), but loop edges may anchor at any older
        frame, so the graph spans [t_start, t_end) (sparse-Schur once that
        span passes SPARSE_BA_THRESHOLD) -> (state, n, n_edges)."""
        max_factors = 8 * self.loop_window
        t_start_loop = max(0, t_end - self.loop_window)
        graph = self._make_graph(max_factors, window=t_end - t_start)
        if local_graph is not None:
            self._copy_graph(graph, local_graph)
        left = max_factors - graph.n_active
        es = self._propose_edges(state, t_start, t_end, t_start_loop,
                                 self.loop_radius, self.loop_nms,
                                 self.loop_thresh, left, loop=True)
        state, n_edges = self._run(state, graph, es, t_start_loop + 1, t_end,
                                   steps, motion_only, loop=True)
        self.loop_bas += 1
        return state, t_end - t_start_loop, n_edges

    @staticmethod
    def _copy_graph(dst: FactorGraph, src: FactorGraph):
        """Seed a backend graph with the frontend's active edges
        (backend.py:152-157); the hidden states take dst's dtype."""
        n = min(src.n_active, dst.capacity)
        if n == 0:
            return
        dst.ii = src.ii[:n].copy()
        dst.jj = src.jj[:n].copy()
        dst.age = src.age[:n].copy()
        dst._edges_version += 1  # invalidate any sparse-pair cache
        with torch.no_grad():
            dst.net[:n] = src.net[:n].to(dst.net.dtype)
            dst.target[:n] = src.target[:n]
            dst.weight[:n] = src.weight[:n]
