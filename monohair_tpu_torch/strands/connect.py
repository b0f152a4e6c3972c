"""Strand segment connection and scalp attachment (port of
monohair_tpu/strands/connect.py, host code: numpy, scipy and C++).

Mirror of the reference's host-side connection logic (HairGrow.py:303-784):
- `find_connect_info` / `connect_all_segments`: link segment roots/tips whose
  endpoint directions agree, chain-connect them, validate against the occupancy
  grid with jitter retries.
- `connect_to_scalp`: iterative rounds attaching rootless strands to scalp-rooted
  "good" strands with progressively relaxed distance/angle thresholds. It runs
  the port's copy of the host C++ (csrc/connect.cpp), built with g++ at first
  use; a failed build raises with g++'s output. `connect_to_scalp_plain` is the
  same algorithm in Python, the plain version the tests hold the C++ against.

This phase is irregular (data-dependent recursion over KD-tree queries) and runs
on the host in the reference as well; scipy cKDTree replaces KDTree and
per-strand trees are built lazily. Strand coordinates: world units for segment
connection, voxel units for scalp attachment (exactly as the reference stages
them).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.interpolate import CubicHermiteSpline
from scipy.spatial import cKDTree

from ..ops import _build


def cubic_interp(p1, p2, n1, n2, num_interp: int):
    """Hermite bridge between two points with end tangents (HairGrow.py:13-19)."""
    spline = CubicHermiteSpline(np.linspace(0, 1, 2), [p1, p2],
                                [n1 * num_interp, n2 * num_interp])
    u = np.linspace(0, 1, num_interp + 1, endpoint=True)
    return spline(u)


def compute_similar(a, b):
    """Clamped cosine (Utils.py compute_similar) — for voxel-scale vectors only;
    the 1e-4 denominator floor would zero out millimeter-scale world deltas."""
    return (np.sum(a * b, -1)
            / np.maximum(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-4))


def cosine(a, b):
    """Unclamped cosine (HairGrow.py:552-553 find_best_connect_strands)."""
    return (np.sum(a * b, -1)
            / np.maximum(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12))


def strand_occupancy_stats(strand_voxel: np.ndarray, occ: np.ndarray,
                           ori_voxel: np.ndarray) -> Tuple[float, float, bool]:
    """(in_ratio, direction similarity, in_bounds) of a voxel-space strand
    against the grids (PMVO_utils.py:596-616 compute_strands_confidence)."""
    res = np.array(occ.shape)
    idx = np.round(strand_voxel).astype(np.int64)
    if (idx >= res).any() or (idx < 0).any():
        idx = np.clip(idx, 0, res - 1)
        in_bounds = False
    else:
        in_bounds = True
    s_occ = occ[idx[:, 0], idx[:, 1], idx[:, 2]]
    s_ori = ori_voxel[idx[:, 0], idx[:, 1], idx[:, 2]]
    d = np.concatenate([strand_voxel[1:] - strand_voxel[:-1],
                        strand_voxel[-1:] - strand_voxel[-2:-1]], 0)
    sim = np.abs(compute_similar(s_ori, d))
    in_ratio = float(s_occ.sum() / max(len(s_occ), 1))
    sim_score = float(sim.sum() / max(s_occ.sum(), 1e-6))
    return in_ratio, sim_score, in_bounds


def _translate_join(base_end: np.ndarray, other: np.ndarray) -> np.ndarray:
    """Append `other`'s shape after base_end by translating its deltas
    (connect_strands push_back branch, HairGrow.py:353-381, weight=0 path)."""
    deltas = other[1:] - other[:-1]
    return base_end + np.cumsum(deltas, 0)


class SegmentConnector:
    """find_connect_info + connect_segments (HairGrow.py:303-587)."""

    def __init__(self, strands: Sequence[np.ndarray], connect_threshold: float,
                 connect_dot_threshold: float, max_joined_points: int = 80):
        self.strands = [np.asarray(s, np.float64) for s in strands]
        self.thr = connect_threshold
        self.dot_thr = connect_dot_threshold
        self.max_joined = max_joined_points
        self._trees: Dict[int, cKDTree] = {}

    def _tree(self, i: int) -> cKDTree:
        t = self._trees.get(i)
        if t is None:
            t = cKDTree(self.strands[i])
            self._trees[i] = t
        return t

    def _query(self, point, tree, k, i):
        dist, idx = tree.query(point, k=k, distance_upper_bound=self.thr)
        dist, idx = np.atleast_1d(dist), np.atleast_1d(idx)
        keep = np.isfinite(dist) & (idx != i)
        return dist[keep], idx[keep]

    def _best_connect(self, end_ori, nei_oris, strand, dists, nei_idx, kind):
        """find_best_connect_strands (HairGrow.py:550-587)."""
        if len(nei_idx) == 0:
            return None
        sim = cosine(np.repeat(end_ori, len(nei_oris), 0), nei_oris)
        if kind in ("root2root", "tip2tip"):
            ok = sim < -self.dot_thr
        else:
            ok = sim > self.dot_thr
        if not ok.any():
            return None
        keep = np.ones(len(nei_idx), bool)
        slen = np.linalg.norm(strand[0] - strand[-1])
        for j, ni in enumerate(nei_idx):
            if strand.shape[0] + self.strands[ni].shape[0] >= self.max_joined:
                keep[j] = False
                continue
            d, _ = self._tree(ni).query(strand, 1)
            if strand.shape[0] < 6:
                keep[j] = np.sum(d < 0.005) < 4
            else:
                keep[j] = np.sum(d < 0.01) <= 6
            if d[0] < slen * 2 / 3 and d[-1] < slen * 2 / 3 and len(strand) > 20:
                keep[j] = False
        ok = ok & keep
        if not ok.any():
            return None
        loss = dists[ok] * (1 - np.abs(sim[ok]))
        return int(nei_idx[ok][np.argmin(loss)])

    def find_connect_info(self) -> List[dict]:
        roots = np.stack([s[0] for s in self.strands])
        tips = np.stack([s[-1] for s in self.strands])
        root_oris = np.stack([s[1] - s[0] for s in self.strands])
        tip_oris = np.stack([s[-1] - s[-2] for s in self.strands])
        roots_tree = cKDTree(roots)
        tips_tree = cKDTree(tips)

        infos = []
        for i, strand in enumerate(self.strands):
            info = {}
            r_ori = root_oris[i:i + 1]
            t_ori = tip_oris[i:i + 1]
            d, idx = self._query(strand[0], roots_tree, 50, i)
            best = self._best_connect(r_ori, root_oris[idx], strand, d, idx, "root2root")
            if best is None:
                d, idx = self._query(strand[0], tips_tree, 50, i)
                best = self._best_connect(r_ori, tip_oris[idx], strand, d, idx, "root2tip")
                info["root"] = None if best is None else [best, "tip"]
            else:
                info["root"] = [best, "root"]
            d, idx = self._query(strand[-1], roots_tree, 50, i)
            best = self._best_connect(t_ori, root_oris[idx], strand, d, idx, "tip2root")
            if best is None:
                d, idx = self._query(strand[-1], tips_tree, 50, i)
                best = self._best_connect(t_ori, tip_oris[idx], strand, d, idx, "tip2tip")
                info["tip"] = None if best is None else [best, "tip"]
            else:
                info["tip"] = [best, "root"]
            infos.append(info)
        return infos

    def chain(self, infos: List[dict], i: int) -> np.ndarray:
        """connect_segments (HairGrow.py:303-346): follow root/tip chains,
        joining each linked strand by translated deltas."""
        flip = {"tip": "root", "root": "tip"}
        visited = {i}
        parts = [self.strands[i]]

        def follow(at_root: bool):
            key = "root" if at_root else "tip"
            info = infos[i].get(key)
            while info is not None:
                j, end_kind = info
                if j in visited:
                    break
                visited.add(j)
                s = self.strands[j]
                if at_root:
                    seg = s[::-1] if end_kind == "root" else s
                    joined = _translate_join(parts[0][0], seg[::-1])[::-1]
                    parts.insert(0, joined)
                else:
                    seg = s if end_kind == "root" else s[::-1]
                    joined = _translate_join(parts[-1][-1], seg)
                    parts.append(joined)
                info = infos[j].get(flip[end_kind])

        follow(True)
        follow(False)
        return np.concatenate(parts, 0)


def world_to_voxel_np(points: np.ndarray, voxel_min, voxel_size) -> np.ndarray:
    flipped = points * np.array([1.0, -1.0, -1.0])
    return (flipped - voxel_min) / voxel_size


def connect_all_segments(strands: Sequence[np.ndarray], occ: np.ndarray,
                         ori_voxel: np.ndarray, connect_threshold: float,
                         connect_dot_threshold: float, voxel_min, voxel_size,
                         in_ratio_threshold: float = 0.8, max_jitter_tries: int = 50,
                         rng: Optional[np.random.Generator] = None
                         ) -> List[np.ndarray]:
    """Full segment-connection pass (HairGrow.py:436-546): link, chain, validate
    each joined strand against occupancy with up to 50 global jitter retries."""
    rng = rng or np.random.default_rng(0)
    conn = SegmentConnector(strands, connect_threshold, connect_dot_threshold)
    infos = conn.find_connect_info()
    out = []
    fails = 0
    for i in range(len(strands)):
        strand = conn.chain(infos, i)
        cand = strand.copy()
        ok = False
        for _ in range(max_jitter_tries):
            v = world_to_voxel_np(cand, voxel_min, voxel_size)
            in_ratio, _, in_bounds = strand_occupancy_stats(v, occ, ori_voxel)
            if not in_bounds:
                break
            if in_ratio > in_ratio_threshold:
                strand = cand
                ok = True
                break
            cand = strand + rng.random(3) * 0.005
        if not ok:
            fails += 1
        out.append(strand)
    return out


def connect_to_scalp_plain(strands: List[np.ndarray], num_root: int, occ: np.ndarray,
                           ori_voxel: np.ndarray, out_ratio_threshold: float = 0.5,
                           thr_dist: float = 0.5, thr_dot: float = 0.9,
                           max_thr_dist: float = 2.0, min_thr_dot: float = 0.6,
                           jitter_retries: int = 2,
                           rng: Optional[np.random.Generator] = None) -> List[np.ndarray]:
    """Attach rootless strands to scalp-rooted strands (HairGrow.py:606-784),
    in Python: the plain version of `connect_to_scalp`.

    Strands are in VOXEL coordinates. Rounds relax thr_dist (+0.25 up to
    max_thr_dist) and thr_dot (-0.075 down to min_thr_dot) whenever progress
    stalls; a strand attaches at the nearest point of a good strand when the
    connection direction agrees, then the grafted *prefix* is
    occupancy-validated (random_move_strands checks strand[:index] only,
    PMVO_utils.py:618-658 / HairGrow.py:754); a failed validation retries up to
    `jitter_retries` whole-strand jitters of ~half a voxel (the reference's
    intended retry — its loop is written to jitter but breaks after one pass).
    Out-of-volume attachments are kept but marked. Returns attached strands only.
    The jitter draws come from `rng` (numpy), the C++ version's from its own
    generator, so the two agree only where no validation fails.
    """
    rng = rng or np.random.default_rng(0)
    strands = [np.asarray(s, np.float64) for s in strands]
    n = len(strands)
    root_flag = np.zeros(n, bool)
    root_flag[:num_root] = True
    out_root_flag = np.zeros(n, bool)
    out_ratio = np.zeros(n)
    trees = [None] * n

    def tree(i):
        if trees[i] is None:
            trees[i] = cKDTree(strands[i])
        return trees[i]

    progress_quota = max((n - num_root) // 500, 0)
    rounds = 0
    while True:
        num_good = root_flag.sum()
        core_pts, core_info = [], []
        for i in range(n):
            if root_flag[i]:
                core_pts.append(strands[i])
                core_info.extend([i] * strands[i].shape[0])
        if not core_pts:
            break
        core_tree = cKDTree(np.concatenate(core_pts, 0))
        core_info = np.array(core_info)

        # one batched neighbor query for every pending root (the per-strand
        # query was the round's hot spot at 100k strands)
        pending = [i for i in range(n) if not (root_flag[i] or out_root_flag[i])]
        if not pending:
            break
        pending_roots = np.stack([strands[i][0] for i in pending])
        nei_lists = core_tree.query_ball_point(pending_roots, thr_dist,
                                               workers=-1)

        for i, nei_index in zip(pending, nei_lists):
            strand = strands[i]
            if len(nei_index) == 0:
                continue
            nei_strands = core_info[nei_index]

            # orient the strand root-first against its closest good strand
            closest = nei_strands[0]
            d_all, idx_all = tree(closest).query(strand, 1)
            ss = strands[closest]
            ib, ie = idx_all[0], idx_all[-1]
            t1 = (ss[ib] - ss[ib - 1]) if ib == ss.shape[0] - 1 else (ss[min(ib + 1, len(ss) - 1)] - ss[ib])
            t2 = strand[1] - strand[0]
            if compute_similar(t1, t2) < 0 and ib > ie and np.mean(d_all) < 5:
                strands[i] = strand[::-1].copy()
                strand = strands[i]
                trees[i] = None

            best_loss, best_j, best_pt_idx = np.inf, None, None
            seen = set()
            for nj in nei_strands:
                if nj in seen:
                    continue
                seen.add(nj)
                if len(seen) > 30:
                    break
                nei = strands[nj]
                _, pt_idx = tree(nj).query(strand[0], 1)
                d5, _ = tree(nj).query(strand[:5], 1)
                if np.mean(d5) < 1:
                    continue
                if len(strand) > 60 and len(strand) + pt_idx > 150:
                    continue
                if pt_idx <= 1:
                    continue
                nei_ori = nei[pt_idx] - nei[pt_idx - 1]
                tan = strand[1] - strand[0]
                dist = np.linalg.norm(nei[pt_idx] - strand[0])
                if compute_similar(nei_ori, tan) > thr_dot and dist < thr_dist:
                    conn_dir = compute_similar(strand[0] - nei[pt_idx], tan)
                    loss = (1 - conn_dir) + 0.1 * thr_dist + out_ratio[nj]
                    if loss < best_loss:
                        best_loss, best_j, best_pt_idx = loss, nj, int(pt_idx)

            if best_j is None or best_pt_idx <= 1:
                continue
            ss = strands[best_j]
            mid = strand[0] * 0.95 + ss[best_pt_idx] * 0.05
            prefix = _translate_join(mid, ss[:best_pt_idx + 1][::-1])[::-1]
            joined = np.concatenate([prefix, mid[None], strand], 0)

            # validate the grafted prefix only (random_move_strands index arg)
            plen = best_pt_idx + 2
            in_ratio, sim, in_bounds = strand_occupancy_stats(joined[:plen],
                                                              occ, ori_voxel)
            ok = in_bounds and in_ratio > out_ratio_threshold and sim > 0.3
            if not ok and in_bounds:
                for _ in range(jitter_retries):
                    cand = joined + rng.random(3) * 0.5
                    r2, s2, b2 = strand_occupancy_stats(cand[:plen], occ,
                                                        ori_voxel)
                    if b2 and r2 > out_ratio_threshold and s2 > 0.3:
                        joined, in_ratio, ok = cand, r2, True
                        break
            out_ratio[i] = 1 - in_ratio
            strands[i] = joined
            trees[i] = None
            if ok:
                root_flag[i] = True
            else:
                out_root_flag[i] = True

        rounds += 1
        if root_flag.sum() - num_good > progress_quota:
            continue
        if thr_dist >= max_thr_dist and thr_dot <= min_thr_dot:
            break
        thr_dist = min(thr_dist + 0.25, max_thr_dist)
        thr_dot = max(thr_dot - 0.075, min_thr_dot)

    return [strands[i] for i in range(n) if root_flag[i] or out_root_flag[i]]


SOURCE = "connect.cpp"
_LIB = None


def _lib() -> ctypes.CDLL:
    """The C++ library, built with g++ at first use, with its C signatures set."""
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        c_dp = ctypes.POINTER(ctypes.c_double)
        c_fp = ctypes.POINTER(ctypes.c_float)
        c_ip = ctypes.POINTER(ctypes.c_int64)
        c_up = ctypes.POINTER(ctypes.c_uint8)
        lib.cts_run.restype = ctypes.c_void_p
        lib.cts_run.argtypes = [
            c_dp, c_ip, ctypes.c_int64, ctypes.c_int64, c_fp, c_fp,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int64,
            ctypes.c_uint64, c_ip, c_ip]
        lib.cts_fetch.restype = None
        lib.cts_fetch.argtypes = [ctypes.c_void_p, c_dp, c_ip, c_up]
        lib.cts_free.restype = None
        lib.cts_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def connect_to_scalp(strands: List[np.ndarray], num_root: int, occ: np.ndarray,
                     ori_voxel: np.ndarray, out_ratio_threshold: float = 0.5,
                     thr_dist: float = 0.5, thr_dot: float = 0.9,
                     max_thr_dist: float = 2.0, min_thr_dot: float = 0.6,
                     jitter_retries: int = 2, seed: int = 0) -> List[np.ndarray]:
    """connect_to_scalp_plain in C++ (csrc/connect.cpp): same semantics,
    ~30x faster at 100k strands, the same result under any OMP_NUM_THREADS.
    Its jitter generator is seeded from `seed` per (strand, round). Returns
    the attached strands (float64, voxel coordinates)."""
    if not strands:
        return []
    pts = np.ascontiguousarray(
        np.concatenate([np.asarray(s, np.float64) for s in strands], 0))
    offsets = np.zeros(len(strands) + 1, np.int64)
    np.cumsum([len(s) for s in strands], out=offsets[1:])
    occ_c = np.ascontiguousarray(occ, np.float32)
    ori_c = np.ascontiguousarray(ori_voxel, np.float32)
    if ori_c.shape != occ_c.shape + (3,):
        raise ValueError(f"ori_voxel {ori_c.shape} does not match occ {occ_c.shape}")
    lib = _lib()
    n_out = ctypes.c_int64(0)
    p_out = ctypes.c_int64(0)
    handle = lib.cts_run(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(strands), num_root,
        occ_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ori_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        *map(ctypes.c_int64, occ_c.shape),
        out_ratio_threshold, thr_dist, thr_dot, max_thr_dist, min_thr_dot,
        jitter_retries, seed, ctypes.byref(n_out), ctypes.byref(p_out))
    if not handle:
        raise RuntimeError("connect_to_scalp: the C++ kernel returned no result")
    try:
        out_pts = np.empty((p_out.value, 3), np.float64)
        out_off = np.empty(n_out.value + 1, np.int64)
        out_flag = np.empty(n_out.value, np.uint8)
        lib.cts_fetch(handle,
                      out_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                      out_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                      out_flag.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    finally:
        lib.cts_free(handle)
    return [out_pts[out_off[i]:out_off[i + 1]].copy() for i in range(n_out.value)]


def attach_roots_to_scalp(strands: List[np.ndarray], scalp_points: np.ndarray,
                          scalp_normals: np.ndarray) -> List[np.ndarray]:
    """Hermite-bridge each strand root to its nearest scalp point
    (_connect_to_scalp, HairGrow.py:593-603)."""
    tree = cKDTree(scalp_points)
    out = []
    for strand in strands:
        beg = strand[0]
        beg_tan = strand[1] - strand[0]
        _, ni = tree.query(beg, 1)
        root, nrm = scalp_points[ni], scalp_normals[ni]
        num = int(np.linalg.norm(beg - root))
        if num >= 1:
            bridge = cubic_interp(root, beg, nrm, beg_tan, num)
            strand = np.concatenate([bridge, strand], 0)
        out.append(strand)
    return out
