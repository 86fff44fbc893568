"""The reference's ray casts: every ray against the world-space soup.

Plain PyTorch, no acceleration structure the program has: the soup is cut
into runs of `GROUP` consecutive triangles (an instance's triangles are
consecutive, so a run is a patch of one mesh), each run gets its box, and
a ray tests the triangles of every run whose box it enters within its
window. Rays go in blocks of `BLOCK`, so memory stays bounded. Scenes of
at most `SMALL` triangles skip the boxes and test every triangle.

Hits: the Moeller-Trumbore test as the program's dense sweep has it
(`t_min <= t < t_max`, |det| >= 1e-10, back faces for det > -1e-10); the
closest of a ray's hits wins, the lower soup row on an exact tie. The
alpha test follows the program's documented semantics: the opaque side
is cast once, and the maybe-transparent side (`RefScene.world_masked`)
through the recast loop below the opaque hit, with the loop's origin
advance and pass bound.
"""

import torch

from .core.constants import INSTANCE_FLAG_OPAQUE, INSTANCE_MATERIAL_OVERRIDE_NONE
from .integrator.common import sample_texture_atlas

GROUP = 64
BLOCK = 4096
SMALL = 4096
ALPHA_MAX_PASSES = 64
ALPHA_ADVANCE = 4e-4


def _moeller(o, d, t_min, t_max, v0, v1, v2):
    """Broadcast Moeller-Trumbore: (t, u, v, backface, hit)."""
    e1, e2 = v1 - v0, v2 - v0
    p = torch.linalg.cross(d.expand_as(e2), e2, dim=-1)
    det = (e1 * p).sum(-1)
    det_ok = det.abs() >= 1e-10
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    tv = o - v0
    u = (tv * p).sum(-1) * inv
    q = torch.linalg.cross(tv, e1, dim=-1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    hit = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= t_min) & (t < t_max))
    return t, u, v, det > -1e-10, hit


class Soup:
    """One side of the soup (all rows, the opaque ones or the masked
    ones): its rows and, for large sides, the boxes of runs of GROUP."""

    def __init__(self, scene, rows):
        self.rows = rows
        self.v0 = scene.world_v0[rows]
        self.v1 = scene.world_v1[rows]
        self.v2 = scene.world_v2[rows]
        n = rows.shape[0]
        self.n = n
        if n > SMALL:
            pad = (-n) % GROUP
            idx = torch.cat([torch.arange(n, device=rows.device),
                             torch.full((pad,), n - 1, device=rows.device)])
            self.group_idx = idx.reshape(-1, GROUP)
            corners = torch.stack([self.v0[idx], self.v1[idx],
                                   self.v2[idx]], 1).reshape(-1, GROUP * 3, 3)
            self.lo = corners.amin(1)
            self.hi = corners.amax(1)

    def _pairs(self, o, d, t_min, t_max):
        """(ray, row) candidate pairs of a block: runs whose box the ray
        enters in [t_min, t_max), expanded to their rows."""
        r = o.shape[0]
        if self.n <= SMALL:
            ray = torch.arange(r, device=o.device).repeat_interleave(self.n)
            row = torch.arange(self.n, device=o.device).repeat(r)
            return ray, row
        inv = 1.0 / torch.where(d.abs() < 1e-30,
                                torch.where(d >= 0, 1e-30, -1e-30), d)
        ta = (self.lo[None] - o[:, None]) * inv[:, None]
        tb = (self.hi[None] - o[:, None]) * inv[:, None]
        t0 = torch.minimum(ta, tb).amax(-1)
        t1 = torch.maximum(ta, tb).amin(-1)
        enter = (t0 <= t1 * (1 + 1e-5) + 1e-6) & (t1 >= t_min[:, None]) \
            & (t0 < t_max[:, None])
        ray, grp = torch.nonzero(enter, as_tuple=True)
        row = self.group_idx[grp].reshape(-1)
        return ray.repeat_interleave(GROUP), row

    def closest(self, o, d, t_min, t_max):
        """Closest hit per ray in [t_min, t_max): (t, soup row, u, v,
        back); t = +inf and row -1 on a miss."""
        r, dev = o.shape[0], o.device
        t_min = torch.broadcast_to(torch.as_tensor(t_min, dtype=o.dtype,
                                                   device=dev), (r,))
        t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=o.dtype,
                                                   device=dev), (r,))
        out_t = torch.full((r,), float("inf"), dtype=o.dtype, device=dev)
        out_row = torch.full((r,), -1, dtype=torch.long, device=dev)
        out_u = torch.zeros(r, dtype=o.dtype, device=dev)
        out_v = torch.zeros_like(out_u)
        out_b = torch.zeros(r, dtype=torch.bool, device=dev)
        if self.n == 0:
            return out_t, out_row, out_u, out_v, out_b
        for s in range(0, r, BLOCK):
            sl = slice(s, min(s + BLOCK, r))
            ray, row = self._pairs(o[sl], d[sl], t_min[sl], t_max[sl])
            if not ray.numel():
                continue
            t, u, v, back, hit = _moeller(
                o[sl][ray], d[sl][ray], t_min[sl][ray], t_max[sl][ray],
                self.v0[row], self.v1[row], self.v2[row])
            ray, row, t, u, v, back = (x[hit] for x in (ray, row, t, u, v,
                                                        back))
            best = torch.full((sl.stop - s,), float("inf"), dtype=o.dtype,
                              device=dev).scatter_reduce(0, ray, t, "amin")
            win = t == best[ray]
            ray, row, u, v, back = (x[win] for x in (ray, row, u, v, back))
            first = torch.full((sl.stop - s,), self.n, dtype=torch.long,
                               device=dev).scatter_reduce(0, ray, row, "amin")
            pick = row == first[ray]
            ray = ray[pick] + s
            out_t[ray] = best[ray - s]
            out_row[ray] = self.rows[row[pick]]
            out_u[ray], out_v[ray], out_b[ray] = u[pick], v[pick], back[pick]
        return out_t, out_row, out_u, out_v, out_b

    def any(self, o, d, t_min, t_max):
        """(R,) bool: some row hit in [t_min, t_max)."""
        t = self.closest(o, d, t_min, t_max)[0]
        return torch.isfinite(t)


class Caster:
    """The scene's casts: all rows, and on alpha-tested scenes the opaque
    and the maybe-transparent rows apart."""

    def __init__(self, scene, alpha_textures):
        self.scene = scene
        self.alpha_textures = alpha_textures
        dev = scene.world_v0.device
        all_rows = torch.arange(scene.world_v0.shape[0], device=dev)
        self.all = Soup(scene, all_rows)
        m = scene.world_masked
        self.split = bool(m.any()) and bool((~m).any())
        if self.split:
            self.opaque = Soup(scene, all_rows[~m])
            self.masked = Soup(scene, all_rows[m])

    def _hitinfo(self, t, row, u, v, back):
        s = self.scene
        r = row.clamp_min(0)
        return (t, u, v, s.world_tri[r], s.world_inst[r], back)

    def _opacity(self, tri, inst, u, v):
        """The alpha test's opacity and the instance's OPAQUE flag."""
        s = self.scene
        opaque = (s.instance_flags[inst] & INSTANCE_FLAG_OPAQUE) != 0
        override = s.instance_material_overrides[inst]
        has_ov = override != INSTANCE_MATERIAL_OVERRIDE_NONE
        last = s.mat_table.shape[0] - 1
        opac = torch.where(has_ov, s.mat_table[override.clamp(0, last), 9],
                           s.tri_opacity[tri])
        if self.alpha_textures:
            mrow = s.mat_table[torch.where(has_ov, override,
                                           s.material_ids[tri]).clamp(0, last)]
            otex = mrow[:, 12].long()
            c0, c1, c2 = (s.vtx_table[s.triangles[tri, k], 9:11]
                          for k in range(3))
            uvh = (c0 + (c1 - c0) * u[..., None] + (c2 - c0) * v[..., None]) \
                * mrow[:, 7:9]
            tex = sample_texture_atlas(s.textures, s.texture_sizes, otex,
                                       uvh)[..., 0]
            opac = opac * torch.where(otex >= 0, tex, 1.0)
        return opac, opaque

    def _recast(self, soup, o, d, t_min, opacity_u, t_max):
        """The recast loop over soup: (t, row, u, v, back) of the first
        hit that the ray's opacity sample accepts below t_max."""
        r, dev = o.shape[0], o.device
        t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=o.dtype,
                                                   device=dev), (r,))
        out = [torch.full((r,), float("inf"), dtype=o.dtype, device=dev),
               torch.full((r,), -1, dtype=torch.long, device=dev),
               torch.zeros(r, dtype=o.dtype, device=dev),
               torch.zeros(r, dtype=o.dtype, device=dev),
               torch.zeros(r, dtype=torch.bool, device=dev)]
        live = torch.nonzero(t_max > 0.0)[:, 0]
        cur_o, t_base = o.clone(), torch.zeros(r, dtype=o.dtype, device=dev)
        for k in range(ALPHA_MAX_PASSES):
            if not live.numel():
                break
            lo, ld, tb = cur_o[live], d[live], t_base[live]
            cap = torch.clamp_min(t_max[live] - tb, 0.0)
            t, row, u, v, back = soup.closest(lo, ld, t_min if k == 0
                                              else 0.0, cap)
            hit = torch.isfinite(t)
            _, _, _, tri, inst, _ = self._hitinfo(t, row, u, v, back)
            opac, opaque = self._opacity(tri, inst, u, v)
            accept = opaque | (opacity_u[live] < opac)
            t_tot = tb + t
            beyond = t_tot >= t_max[live]
            take = hit & accept & ~beyond
            ends = ~hit | accept | beyond
            for i, new in enumerate((t_tot, row, u, v, back)):
                out[i][live] = torch.where(take, new, out[i][live])
            reject = hit & ~accept
            adv = t * (1.0 + ALPHA_ADVANCE) + 1e-5
            cur_o[live] = torch.where(reject[:, None], lo + adv[:, None] * ld,
                                      lo)
            t_base[live] = torch.where(reject, tb + adv, tb)
            live = live[~ends]
        return out

    def closest(self, o, d, t_min=0.0, opacity_u=None):
        """(t, u, v, tri, inst, back) of the closest accepted hit."""
        if opacity_u is None:
            return self._hitinfo(*self.all.closest(o, d, t_min,
                                                   float("inf")))
        if not self.split:
            return self._hitinfo(*self._recast(self.all, o, d, t_min,
                                               opacity_u, float("inf")))
        base = self.opaque.closest(o, d, t_min, float("inf"))
        masked = self._recast(self.masked, o, d, t_min, opacity_u, base[0])
        m = torch.isfinite(masked[0]) & (masked[0] < base[0])
        return self._hitinfo(*(torch.where(m, a, b)
                               for a, b in zip(masked, base)))

    def occluded(self, o, d, t_max, t_min=0.0, opacity_u=None):
        """(R,) bool: an accepted hit in [t_min, t_max)."""
        if opacity_u is None:
            return self.all.any(o, d, t_min, t_max)
        if not self.split:
            return torch.isfinite(self._recast(self.all, o, d, t_min,
                                               opacity_u, t_max)[0])
        occ = self.opaque.any(o, d, t_min, t_max)
        t_rest = torch.where(occ, 0.0, torch.broadcast_to(
            torch.as_tensor(t_max, dtype=o.dtype, device=o.device),
            occ.shape))
        return occ | torch.isfinite(self._recast(self.masked, o, d, t_min,
                                                 opacity_u, t_rest)[0])
