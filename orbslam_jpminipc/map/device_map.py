"""Device-resident mirror of the map SoA + the mapping-stage kernels.

The per-keyframe mapping stages (triangulation, fusion, local BA) consume
multi-megabyte slices of the keyframe/point arrays. Shipping those slices
host->device on every stage call would dwarf the kernels. But the
underlying data barely changes:

  * a keyframe's features (descriptors, keypoints, angles, levels,
    validity) are IMMUTABLE after insertion (KeyFrame.cc never rewrites
    them) — upload each row once, at insertion;
  * keyframe poses change only at BA/loop events — 12 KB to re-upload;
  * point attributes change per mapping stage, but only for the touched
    ids — a small packed row upload.

So the mirror keeps `kf_desc/kf_xy/kf_angle/kf_level/kf_feat_valid/
kf_R/kf_t` and `mp_xyz/mp_desc/mp_normal/mp_min_dist/mp_max_dist/
mp_valid` resident on device, and every stage kernel takes only INDICES
(a few hundred KB at most) from the host, gathering its operands on
device. Replaces the packed-transfer path that shipped the operands
themselves (10+ MB per keyframe).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.pack import packed_call


class DeviceMap:
    """Host handle on the device-resident map mirror."""

    def __init__(self, max_kf: int, n_feat: int, max_mp: int):
        self.max_kf = max_kf
        self.n_feat = n_feat
        self.max_mp = max_mp
        # bumped on every sync; consumers (the tracker's slice refresh)
        # skip rebuilding when nothing changed
        self.version = 0
        self.kf_desc = jnp.zeros((max_kf, n_feat, 32), jnp.uint8)
        self.kf_xy = jnp.zeros((max_kf, n_feat, 2), jnp.float32)
        self.kf_angle = jnp.zeros((max_kf, n_feat), jnp.float32)
        self.kf_level = jnp.zeros((max_kf, n_feat), jnp.int32)
        self.kf_feat_valid = jnp.zeros((max_kf, n_feat), bool)
        self.kf_R = jnp.tile(jnp.eye(3, dtype=jnp.float32)[None], (max_kf, 1, 1))
        self.kf_t = jnp.zeros((max_kf, 3), jnp.float32)
        self.mp_xyz = jnp.zeros((max_mp, 3), jnp.float32)
        self.mp_desc = jnp.zeros((max_mp, 32), jnp.uint8)
        self.mp_normal = jnp.zeros((max_mp, 3), jnp.float32)
        self.mp_min_dist = jnp.zeros((max_mp,), jnp.float32)
        self.mp_max_dist = jnp.zeros((max_mp,), jnp.float32)
        self.mp_valid = jnp.zeros((max_mp,), bool)

    # --- host -> device sync ------------------------------------------

    def sync_keyframe(self, st, k: int):
        """Upload one keyframe's immutable feature row + pose (~150 KB,
        async) at insertion time."""
        self.version += 1
        k = int(k)
        self.kf_desc = self.kf_desc.at[k].set(jnp.asarray(st.kf_desc[k]))
        self.kf_xy = self.kf_xy.at[k].set(jnp.asarray(st.kf_xy[k]))
        self.kf_angle = self.kf_angle.at[k].set(jnp.asarray(st.kf_angle[k]))
        self.kf_level = self.kf_level.at[k].set(jnp.asarray(st.kf_level[k]))
        self.kf_feat_valid = self.kf_feat_valid.at[k].set(
            jnp.asarray(st.kf_feat_valid[k]))
        self.sync_poses(st)

    def sync_poses(self, st):
        """Upload ALL keyframe poses (12 KB) — after BA / corrections."""
        self.version += 1
        self.kf_R = jnp.asarray(st.kf_R)
        self.kf_t = jnp.asarray(st.kf_t)

    def sync_points(self, st, ids: np.ndarray):
        """Upload the touched point rows (packed: one transfer)."""
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[(ids >= 0) & (ids < self.max_mp)]
        if len(ids) == 0:
            return
        self.version += 1
        # coarse size buckets so the scatter program compiles at most three
        # times (same policy as update_point_attributes)
        n = len(ids)
        cap = (256 if n <= 256
               else 2048 if n <= 2048
               else 1 << int(np.ceil(np.log2(n))))
        idp = np.concatenate([ids, np.full(cap - n, ids[0], np.int64)])
        rows = [
            idp.astype(np.int32),
            st.mp_xyz[idp].astype(np.float32),
            st.mp_desc[idp],
            st.mp_normal[idp].astype(np.float32),
            st.mp_min_dist[idp].astype(np.float32),
            np.where(np.isfinite(st.mp_max_dist[idp]),
                     st.mp_max_dist[idp], 0.0).astype(np.float32),
            st.mp_valid[idp],
        ]
        buf = np.concatenate(
            [np.ascontiguousarray(r).view(np.uint8).reshape(-1) for r in rows]
        )
        spec = tuple((r.shape, r.dtype.str) for r in rows)
        (self.mp_xyz, self.mp_desc, self.mp_normal,
         self.mp_min_dist, self.mp_max_dist, self.mp_valid) = _scatter_points(
            self.mp_xyz, self.mp_desc, self.mp_normal, self.mp_min_dist,
            self.mp_max_dist, self.mp_valid, jnp.asarray(buf), spec=spec,
        )

    def sync_all(self, st):
        """Full refresh — after loop corrections / global BA / reset."""
        self.version += 1
        self.kf_desc = jnp.asarray(st.kf_desc)
        self.kf_xy = jnp.asarray(st.kf_xy)
        self.kf_angle = jnp.asarray(st.kf_angle)
        self.kf_level = jnp.asarray(st.kf_level)
        self.kf_feat_valid = jnp.asarray(st.kf_feat_valid)
        self.sync_poses(st)
        self.mp_xyz = jnp.asarray(st.mp_xyz)
        self.mp_desc = jnp.asarray(st.mp_desc)
        self.mp_normal = jnp.asarray(st.mp_normal)
        self.mp_min_dist = jnp.asarray(st.mp_min_dist)
        self.mp_max_dist = jnp.asarray(
            np.where(np.isfinite(st.mp_max_dist), st.mp_max_dist, 0.0)
            .astype(np.float32))
        self.mp_valid = jnp.asarray(st.mp_valid)


@functools.partial(jax.jit, static_argnames=("spec",))
def _scatter_points(mxyz, mdesc, mnormal, mmin, mmax, mvalid, buf, spec):
    """One fused scatter of the touched point rows into the mirror; the
    row data arrives as a single packed transfer."""
    from ..utils.pack import _unpack

    ids, xyz, desc, normal, mind, maxd, valid = _unpack(buf, spec)
    return (
        mxyz.at[ids].set(xyz),
        mdesc.at[ids].set(desc),
        mnormal.at[ids].set(normal),
        mmin.at[ids].set(mind),
        mmax.at[ids].set(maxd),
        mvalid.at[ids].set(valid),
    )


# ---------------------------------------------------------------------------
# Mapping-stage kernels over the mirror: operands gathered ON DEVICE, only
# indices/masks ship from the host.
# ---------------------------------------------------------------------------

from ..utils.pack import mirror_call  # noqa: E402
from ..geometry import epipolar, triangulate  # noqa: E402
from ..ops import matching  # noqa: E402


@mirror_call(11)
def fuse_kernel(kf_desc, kf_xy, kf_level, kf_feat_valid, kf_R, kf_t,
                mp_xyz, mp_desc, mp_min, mp_max, mp_valid,
                q_point, q_row_valid, dst_idx, K4, scale_factors):
    """Batched ORBmatcher::Fuse (ORBmatcher.cc:1016-1134) over the mirror.

    q_point: (T, F) int32 — map-point slot per query-row feature (-1 none);
    dst_idx: (T,) int32 — target keyframe per row. Everything else gathers
    from the device mirror; the transfer is ~300 KB of indices instead of
    ~5 MB of operands.
    """
    M = mp_xyz.shape[0]
    qid = jnp.clip(q_point, 0, M - 1)
    q_valid = (q_point >= 0) & mp_valid[qid] & q_row_valid
    q_desc = mp_desc[qid]
    q_xyz = mp_xyz[qid]
    q_min = mp_min[qid]
    q_max = mp_max[qid]
    t_desc = kf_desc[dst_idx]
    t_xy = kf_xy[dst_idx]
    t_level = kf_level[dst_idx]
    t_valid = kf_feat_valid[dst_idx]
    Rs = kf_R[dst_idx]
    ts = kf_t[dst_idx]

    n_levels = scale_factors.shape[0]
    log_sf = jnp.log(scale_factors[1])

    def per_target(qd, qx, qmin, qmax, qv, td, txy, tl, tv, R, t):
        xc = qx @ R.T + t
        z = xc[:, 2]
        uv = jnp.stack([
            K4[0] * xc[:, 0] / jnp.maximum(z, 1e-9) + K4[2],
            K4[1] * xc[:, 1] / jnp.maximum(z, 1e-9) + K4[3],
        ], axis=1)
        O = -R.T @ t
        dist = jnp.linalg.norm(qx - O, axis=-1)
        valid = qv & (z > 0)
        valid &= (dist >= 0.8 * qmin) & (dist <= 1.2 * qmax)
        ratio = jnp.maximum(qmax, 1e-9) / jnp.maximum(dist, 1e-9)
        pred = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / log_sf)
        pred = jnp.clip(pred, 0, n_levels - 1).astype(jnp.int32)
        return matching.fuse_search(
            qd, uv, pred, valid, td, txy, tl, tv, scale_factors
        )

    m = jax.vmap(per_target)(
        q_desc, q_xyz, q_min, q_max, q_valid,
        t_desc, t_xy, t_level, t_valid, Rs, ts,
    )
    # compact per row: (cnt, source feature, target feature) of the matched
    # entries only — ~70 KB pulled instead of ~1.25 MB
    order = jax.vmap(lambda mk: jnp.argsort(~mk, stable=True)[:FUSE_CANDS])(m.mask)
    cnt = jnp.sum(m.mask, axis=1, dtype=jnp.int32)
    dst = jnp.take_along_axis(m.idx, order, axis=1)
    return cnt, order.astype(jnp.int16), dst.astype(jnp.int16)


@mirror_call(7)
def tri_kernel(kf_desc, kf_xy, kf_angle, kf_level, kf_feat_valid, kf_R, kf_t,
               kf1, sel, has1, has2, valid2_extra, K4, sigma2, scale_factors):
    """CreateNewMapPoints' epipolar search + DLT + validity gates
    (LocalMapping.cc:227-393) over the mirror: per-call transfer is the
    neighbor index list + has-point masks (~90 KB)."""
    k1 = kf1[0]
    desc1 = kf_desc[k1]
    xy1 = kf_xy[k1]
    angle1 = kf_angle[k1]
    level1 = kf_level[k1]
    valid1 = kf_feat_valid[k1]
    R1 = kf_R[k1]
    t1 = kf_t[k1]
    descs2 = kf_desc[sel]
    xys2 = kf_xy[sel]
    angles2 = kf_angle[sel]
    levels2 = kf_level[sel]
    valids2 = kf_feat_valid[sel] & valid2_extra
    Rs2 = kf_R[sel]
    ts2 = kf_t[sel]

    O1 = -R1.T @ t1
    ratio_factor = 1.5 * scale_factors[1]
    n_levels = sigma2.shape[0]

    def per_neighbor(desc2, xy2, angle2, level2, h2, v2, R2, t2):
        F12 = epipolar.fundamental_from_poses(R1, t1, R2, t2, K4)
        O2 = -R2.T @ t2
        xc_e = R2 @ O1 + t2
        ep = jnp.stack([
            K4[0] * xc_e[0] / jnp.maximum(xc_e[2], 1e-9) + K4[2],
            K4[1] * xc_e[1] / jnp.maximum(xc_e[2], 1e-9) + K4[3],
        ])
        m = matching.search_for_triangulation(
            desc1, xy1, angle1, level1, has1, valid1,
            desc2, xy2, angle2, level2, h2, v2,
            F12, sigma2, ep, scale_factors,
        )
        uv1, uv2 = xy1, xy2[m.idx]
        P1 = triangulate.projection_matrix(R1, t1, K4)
        P2 = triangulate.projection_matrix(R2, t2, K4)
        xw, ok_dlt = triangulate.triangulate_dlt(uv1, uv2, P1, P2)
        ok = m.mask & ok_dlt
        e1, pos1 = triangulate.reprojection_error2(xw, uv1, R1, t1, K4)
        e2, pos2 = triangulate.reprojection_error2(xw, uv2, R2, t2, K4)
        ok &= pos1 & pos2
        ok &= triangulate.parallax_cos(xw, O1, O2) < 0.9998
        s1 = sigma2[jnp.clip(level1, 0, n_levels - 1)]
        s2 = sigma2[jnp.clip(level2[m.idx], 0, n_levels - 1)]
        ok &= (e1 < 5.991 * s1) & (e2 < 5.991 * s2)
        d1 = jnp.linalg.norm(xw - O1, axis=-1)
        d2 = jnp.linalg.norm(xw - O2, axis=-1)
        ratio_dist = d2 / jnp.maximum(d1, 1e-9)
        sf1 = scale_factors[jnp.clip(level1, 0, n_levels - 1)]
        sf2 = scale_factors[jnp.clip(level2[m.idx], 0, n_levels - 1)]
        ratio_octave = sf1 / sf2
        ok &= (ratio_dist < ratio_octave * ratio_factor) & (
            ratio_dist * ratio_factor > ratio_octave
        )
        # compact: the merge needs only the surviving candidates, so pull
        # (cnt, feat1, feat2, xw) rows instead of three dense (F,) arrays —
        # the pull drops from ~680 KB to ~80 KB. A stable argsort on ~ok
        # keeps feature order, so the
        # host's sequential-claim semantics are unchanged. Neighbors
        # yielding > TRI_CANDS matches lose the tail (cnt reports the true
        # count; TRI_CANDS=512 is ~3x the most ever seen per pair).
        order = jnp.argsort(~ok, stable=True)[:TRI_CANDS]
        return (jnp.sum(ok, dtype=jnp.int32),
                order.astype(jnp.int16),
                m.idx[order].astype(jnp.int16),
                xw[order])

    return jax.vmap(per_neighbor)(
        descs2, xys2, angles2, levels2, has2, valids2, Rs2, ts2
    )


TRI_CANDS = 512   # per-neighbor triangulation candidate capacity (pull rows)
FUSE_CANDS = 256  # per-target fuse match capacity (pull rows)


@mirror_call(2)
def local_ba_kernel(kf_xy, kf_level,
                    kf_R, kf_t, kf_fixed, points, point_valid,
                    obs_kf, obs_pt, obs_feat, obs_src_kf, obs_valid,
                    K4, inv_sigma2, iterations: int = 5):
    """ONE local-BA LM stage with observation pixels/weights gathered from
    the mirror (obs_uv = kf_xy[src_kf, feat]): the transfer is the index
    lists + the (K,·) pose block + (P,3) points — ~350 KB instead of
    ~1.3 MB. The reference's 5 -> erase -> 10 schedule (Optimizer.cc:
    450-494) runs as two calls with the host erase between them, so a
    newly arriving keyframe can abort the second stage exactly where
    g2o's force-stop flag would (LocalMapping.cc:541-544)."""
    from ..solvers import ba

    n_levels = inv_sigma2.shape[0]
    obs_uv = kf_xy[obs_src_kf, obs_feat]
    lv = jnp.clip(kf_level[obs_src_kf, obs_feat], 0, n_levels - 1)
    obs_w = inv_sigma2[lv]
    prob = ba.BAProblem(
        kf_R=kf_R, kf_t=kf_t, kf_fixed=kf_fixed,
        points=points, point_valid=point_valid,
        obs_kf=obs_kf, obs_pt=obs_pt, obs_uv=obs_uv, obs_w=obs_w,
        obs_valid=obs_valid, K4=K4,
    )
    return ba.bundle_adjust(prob, iterations=iterations)


@mirror_call(4)
def attrs_kernel(kf_desc, kf_level, kf_R, kf_t,
                 obs_kf, obs_feat, xyz, ref_slot, scale_factors):
    """Point-attribute refresh with observations gathered from the mirror
    (MapPoint::ComputeDistinctiveDescriptors + UpdateNormalAndDepth,
    MapPoint.cc:185-312): the upload is the (n, O) observation index lists
    (~0.3 MB) instead of the gathered descriptors/centers (~3 MB)."""
    from .map_state import attrs_math

    max_kf = kf_R.shape[0]
    obs_kf = obs_kf.astype(jnp.int32)
    obs_feat = obs_feat.astype(jnp.int32)
    valid = obs_kf >= 0
    kf_safe = jnp.clip(obs_kf, 0, max_kf - 1)
    descs = kf_desc[kf_safe, obs_feat]              # (n, O, 32)
    levels = kf_level[kf_safe, obs_feat]
    R = kf_R[kf_safe]                               # (n, O, 3, 3)
    t = kf_t[kf_safe]
    centers = -jnp.einsum("noji,noj->noi", R, t)
    return attrs_math(descs, valid, xyz, centers, levels, ref_slot,
                      scale_factors)


@mirror_call(6)
def slice_kernel(mp_xyz, mp_desc, mp_normal, mp_min, mp_max, mp_valid,
                 ids, row_valid, n_obs):
    """Build the fused tracker's (M, 17) local-map slice on device from
    the mirror — the refresh transfer drops from ~280 KB to ~50 KB of ids."""
    M = ids.shape[0]
    mid = jnp.clip(ids, 0, mp_xyz.shape[0] - 1)
    valid = row_valid & mp_valid[mid]
    maxd = jnp.where(valid, jnp.maximum(mp_max[mid], 1e-6), 0.0)
    desc_f32 = jax.lax.bitcast_convert_type(
        mp_desc[mid].reshape(M, 8, 4), jnp.float32
    )
    return jnp.concatenate([
        mp_xyz[mid],
        mp_normal[mid],
        mp_min[mid][:, None],
        maxd[:, None],
        desc_f32,
        n_obs[:, None],
    ], axis=1)
