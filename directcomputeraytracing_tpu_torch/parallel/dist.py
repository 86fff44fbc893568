"""Multi-rank rendering: a ("spp", "tile") grid of ranks, raster row
bands, summed sample replicas, and the filtered film across band seams.

Counterpart of `directcomputeraytracing_tpu.parallel.dist` on
torch.distributed. The reference drives all its devices from one process
through a `jax.sharding.Mesh` and `shard_map`; here each rank is one
process of a process group (NCCL for CUDA tensors, gloo on the CPU) and
runs the single-device sample functions on its own share of the frame:

  * "tile": the frame splits into contiguous raster row bands, one per
    tile index. A rank traces its band in 32x32 tiles (`_band_tile_perm`;
    the work-list traversal wants compact ray blocks) and puts the
    results back in raster order before the film.
  * "spp": the ranks of one tile index trace the same band with seeds
    `base_seed + spp_index * spp_batch` and sum their contributions with
    an `all_reduce` over their subgroup (the reference's psum).

A non-box filter convolves each band with `hr` rows of its neighbours'
samples on either side (the reference's `ppermute` halo), so the film is
exact across seams. Gloo takes CUDA tensors only in `all_reduce` and
`broadcast`, so the halo and the image's gather work alike on both
backends: each rank writes its rows into its own slot of a zeroed buffer
of one slot per tile index, and an `all_reduce(SUM)` over the tile
subgroup fills every slot. A sum with zeros is exact, so the rows
arrive bit for bit.

Every rank builds the scene tensors, LUTs and camera from the same scene
on its own device; only the film is split. Every rank of a mesh takes
part in each step and in `image()`, which are collectives.
"""

import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..film.filters import FilterParams, convolve_sample_pass
from ..integrator.megakernel import render_samples
from ..integrator.renderer import _pixel_chunks
from ..integrator.wavefront import render_samples_wavefront

# sample positions of the halo rows past the frame's top and bottom: far
# outside every filter's radius, so their weight is 0
_FAR = 1e9


class Mesh(NamedTuple):
    """A rank's place in the ("spp", "tile") grid of its process group:
    the grid's shape, the rank's coordinates and device, and the two
    subgroups it reduces over."""
    shape: dict             # {"spp": s, "tile": t}
    spp_index: int
    tile_index: int
    device: torch.device
    spp_group: object       # the ranks of this tile index (one band)
    tile_group: object      # the ranks of this spp index (all bands)


def make_mesh(n_devices=None, spp_parallel=1, devices=None):
    """Lay the ranks of the initialized default process group out as
    (spp_parallel, tile), row-major: rank r has spp index r // tile and
    tile index r % tile. spp_parallel ranks trace the same pixels with
    different seeds; the rest of the factor splits the frame into bands.

    Every rank must call this, in the same order as its other group
    creations: each call creates every subgroup of the grid. n_devices
    must equal the world size (one rank a device). devices, one per rank
    (rank r takes devices[r]), defaults to cuda:{rank % device_count};
    pass CPU devices explicitly."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(initialize_distributed, or "
                           "torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices on a world of "
                         f"{world} ranks: the port runs one rank a device")
    if n_devices % spp_parallel != 0:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"spp_parallel={spp_parallel}")
    tile = n_devices // spp_parallel
    spp_group, _ = dist.new_subgroups_by_enumeration(
        [[s * tile + t for s in range(spp_parallel)] for t in range(tile)])
    tile_group, _ = dist.new_subgroups_by_enumeration(
        [[s * tile + t for t in range(tile)] for s in range(spp_parallel)])
    if devices is not None:
        device = torch.device(devices[rank])
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass make_mesh devices")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh({"spp": spp_parallel, "tile": tile}, rank // tile,
                rank % tile, device, spp_group, tile_group)


def band_rows(cfg, mesh):
    """Rows per device band (frame height padded to a tile multiple)."""
    t = mesh.shape["tile"]
    return (cfg.height + t - 1) // t


def _band_tile_perm(hb, w, device, tile_h=32, tile_w=32):
    """The band-local square-tile permutation of an (hb, w) band: int64
    (perm, inv) on device with band_raster[perm] = tile order and
    tile_order[inv] = raster order; ragged band edges clip the tile."""
    perm = torch.cat([
        (torch.arange(ty, min(ty + tile_h, hb))[:, None] * w
         + torch.arange(tx, min(tx + tile_w, w))[None, :]).reshape(-1)
        for ty in range(0, hb, tile_h) for tx in range(0, w, tile_w)])
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(hb * w)
    return perm.to(device), inv.to(device)


def _filter_halo_rows(fp: FilterParams):
    """Rows of neighbor samples a band needs for an exact convolution
    at its seams (0 for the box fast path)."""
    if fp.kind == "box" and fp.radius <= 0.5:
        return 0
    return max(1, int(math.ceil(fp.radius + 0.5)))


def _halo(x, hr, fill, mesh):
    """An (hb, w, C) band with hr rows of the previous band above it and
    hr of the next below; the frame's first band gets `fill` rows (a
    (C,) tensor) above, the last below (no wraparound). One slotted
    all_reduce over the tile subgroup carries every band's edge rows."""
    t, ti = mesh.shape["tile"], mesh.tile_index
    slots = torch.zeros((t, 2) + x[:hr].shape, dtype=x.dtype,
                        device=x.device)
    slots[ti, 0] = x[:hr]
    slots[ti, 1] = x[-hr:]
    dist.all_reduce(slots, group=mesh.tile_group)
    edge = fill.expand_as(x[:hr])
    prev = slots[ti - 1, 1] if ti > 0 else edge
    nxt = slots[ti + 1, 0] if ti < t - 1 else edge
    return torch.cat([prev, x, nxt])


def distributed_render_step(mesh, cfg, integrator="megakernel",
                            filter_params=None, tile_order=True,
                            spp_batch=1):
    """The rank's progressive step for a static config.

    Returned fn: (scene, luts, cam, pixel_x, pixel_y, valid, base_seed,
                  film_value, film_weight) -> (film_value, film_weight)

    pixel_x / pixel_y / valid: the rank's band, (hb * w,) int64 raster
    order (rows past the frame clamped to its last row and not valid);
    the film is the band's (hb * w, 3) value and (hb * w,) weight in the
    same order. The rank traces with seed base_seed + spp_index *
    spp_batch; the contributions sum over the spp subgroup.

    spp_batch (wavefront and box filter only) traces S samples per pixel
    in each rank's pool pass, seeds base_seed + spp_index * spp_batch + s:
    one step then adds spp * spp_batch samples."""
    fp = filter_params or FilterParams(kind=cfg.filter_type,
                                       radius=cfg.filter_radius)
    n_spp = mesh.shape["spp"]
    hb = band_rows(cfg, mesh)
    w = cfg.width
    hr = min(_filter_halo_rows(fp), hb)
    if spp_batch > 1 and (integrator != "wavefront" or hr != 0):
        raise ValueError("spp_batch needs the wavefront integrator "
                         "and a box filter (per-sample film positions "
                         "collide)")
    perm, inv = (_band_tile_perm(hb, w, mesh.device) if tile_order
                 else (None, None))
    seed_offset = mesh.spp_index * spp_batch
    fill = torch.tensor([_FAR, _FAR, 0.0, 0.0, 0.0], device=mesh.device)

    def render(scene, luts, cam, px, py, seed):
        if integrator == "wavefront":
            return render_samples_wavefront(scene, luts, cam, cfg, px, py,
                                            seed, spp_batch=spp_batch)
        parts = [render_samples(scene, luts, cam, cfg, cx, cy, seed)
                 for cx, cy in _pixel_chunks(px, py)]
        return (torch.cat([p for p, _ in parts]),
                torch.cat([v for _, v in parts]))

    def step(scene, luts, cam, px, py, valid, base_seed, film_v, film_w):
        seed = base_seed + seed_offset
        if perm is not None:
            pos, values = render(scene, luts, cam, px[perm], py[perm], seed)
            pos, values = pos[inv], values[inv]
        else:
            pos, values = render(scene, luts, cam, px, py, seed)

        if hr == 0:
            # box fast path: every sample lands in its own pixel
            values = torch.where(valid[:, None], values, 0.0)
            dist.all_reduce(values, group=mesh.spp_group)
            return film_v + values, film_w + float(n_spp * spp_batch)

        # filtered path: convolve the band with its neighbours' edge
        # rows (the reference's filter gathers neighbours within its
        # radius, SampleConvolution.hlsl); padded lanes get weight 0
        pos = torch.where(valid[:, None], pos, _FAR)
        band = torch.cat([pos, values], 1).reshape(hb, w, 5)
        ext = _halo(band, hr, fill, mesh)
        v_ext, w_ext = convolve_sample_pass(ext[..., :2], ext[..., 2:], fp)
        part = torch.cat([v_ext[hr:hr + hb].reshape(-1, 3),
                          w_ext[hr:hr + hb].reshape(-1, 1)], 1)
        dist.all_reduce(part, group=mesh.spp_group)
        return film_v + part[:, :3], film_w + part[:, 3]

    return step


class DistributedRenderer:
    """Progressive multi-rank renderer: the film split by raster band
    ("tile"), samples summed over the "spp" replicas each step. Both
    integrators, band-local tile-order tracing, and the exact filtered
    film across seams (the halo). Each rank holds its band's padded film;
    the replicas of a band hold equal copies."""

    def __init__(self, mesh, arrays, luts, cam, cfg,
                 integrator="megakernel", filter_params=None,
                 tile_order=True, spp_batch=1):
        self.mesh = mesh
        self.arrays = arrays
        self.luts = luts
        self.cam = cam
        self.cfg = cfg
        self.spp_batch = spp_batch
        self._step = distributed_render_step(
            mesh, cfg, integrator=integrator,
            filter_params=filter_params, tile_order=tile_order,
            spp_batch=spp_batch)

        hb = band_rows(cfg, mesh)
        dev = mesh.device
        ys, xs = torch.meshgrid(
            mesh.tile_index * hb + torch.arange(hb, device=dev),
            torch.arange(cfg.width, device=dev), indexing="ij")
        self.n_rays = cfg.width * cfg.height
        self.px = xs.reshape(-1)
        self.py = torch.clamp(ys, max=cfg.height - 1).reshape(-1)
        self.valid = (ys < cfg.height).reshape(-1)
        self.film_v = torch.zeros((hb * cfg.width, 3), dtype=torch.float32,
                                  device=dev)
        self.film_w = torch.zeros(hb * cfg.width, dtype=torch.float32,
                                  device=dev)
        self.spp = 0

    def render_step(self, base_seed=None):
        """One progressive step = mesh.shape['spp'] * spp_batch samples
        per pixel; base_seed defaults to the samples so far."""
        seed = self.spp if base_seed is None else base_seed
        self.film_v, self.film_w = self._step(
            self.arrays, self.luts, self.cam, self.px, self.py,
            self.valid, seed, self.film_v, self.film_w)
        self.spp += self.mesh.shape["spp"] * self.spp_batch

    def image(self):
        """The whole (H, W, 3) numpy image, on every rank: the bands
        gathered over the tile subgroup, the padded rows dropped."""
        part = torch.cat([self.film_v, self.film_w[:, None]], 1)
        slots = torch.zeros((self.mesh.shape["tile"],) + part.shape,
                            dtype=part.dtype, device=part.device)
        slots[self.mesh.tile_index] = part
        dist.all_reduce(slots, group=self.mesh.tile_group)
        film = slots.reshape(-1, 4)[: self.n_rays].cpu().numpy()
        img = film[:, :3] / np.maximum(film[:, 3:], 1e-10)
        return img.reshape(self.cfg.height, self.cfg.width, 3)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device="cuda"):
    """Multi-process bring-up: `torch.distributed.init_process_group`
    over tcp://coordinator_address (NCCL for device "cuda", gloo for
    "cpu"), with the environment's DCRT_COORDINATOR, DCRT_NUM_PROCESSES
    and DCRT_PROCESS_ID as fallbacks. A no-op when a group is already
    initialized or no address is given (one process)."""
    if dist.is_initialized():
        return
    addr = coordinator_address or os.environ.get("DCRT_COORDINATOR")
    if addr is None:
        return
    if num_processes is None:
        num_processes = int(os.environ.get("DCRT_NUM_PROCESSES", "1"))
    if process_id is None:   # NOT `or`: process 0 is falsy but explicit
        process_id = int(os.environ.get("DCRT_PROCESS_ID", "0"))
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=num_processes, rank=process_id)
