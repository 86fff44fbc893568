"""The port's distributed renderer (`parallel/dist.py`) on the CPU: one
4-rank gloo world, spawned once for the module, renders every case; the
images are held against the port's single-process `Renderer` and
against the reference's `DistributedRenderer` on the forced 8-device CPU
mesh (`tests/conftest.py`). Cornell (area light) at 16x16, max_bounce 2,
as `tests/test_dist.py` renders it.

Tolerances (those of `tests/test_dist.py` where it has the case):
- distributed vs one process, box film, either integrator: rtol 1e-5,
  atol 1e-6 (the same paths; the replicas' sum adds the samples in
  another order);
- the Gaussian film across band seams: rtol 1e-4, atol 1e-5 (the halo
  convolves each band on its own);
- tile order on vs off: rtol 1e-6, atol 1e-7;
- the wavefront's spp_batch vs sequential samples: rtol 2e-5, atol 2e-6;
- vs the reference's DistributedRenderer: rtol 1e-4, atol 1e-5. The
  port's `render_samples` agrees with the reference's within 2e-5
  relative on Cornell, and the filter sums in another order.

The ranks import torch and the port only: this module imports the
reference inside its tests, never at the top. The `cuda` case (a world of
one on NCCL) runs on the card: `python -m pytest --noconftest -m cuda
tests/test_torch_dist.py`.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from directcomputeraytracing_tpu_torch.entry import (
    dryrun_multichip,
    run_gloo_world,
)
from directcomputeraytracing_tpu_torch.film.filters import FilterParams
from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
from directcomputeraytracing_tpu_torch.parallel.dist import (
    DistributedRenderer,
    Mesh,
    band_rows,
    distributed_render_step,
    initialize_distributed,
    make_mesh,
)
from directcomputeraytracing_tpu_torch.scene.presets import cornell_box

CPU = torch.device("cpu")
W = H = 16
RANKS = 4
GAUSS = FilterParams(kind="gaussian", radius=1.5)


def _single(**kw):
    scene, cam = cornell_box(light="area")
    gauss = kw.pop("gauss", False)
    if gauss:
        kw.update(filter_type="gaussian", filter_radius=1.5,
                  filter_params=GAUSS)
    return Renderer(scene, cam, W, H, max_bounce=2, device=CPU, **kw)


def _rank_cases(out):
    """Every case on one rank of the 4-rank world; rank 0 writes the
    images (`<case>.npy`) and the sample counts, every rank its mesh
    coordinates."""
    torch.set_num_threads(1)
    rank = dist.get_rank()
    cpus = [CPU] * RANKS
    box, wave, gauss = _single(), _single(integrator="wavefront"), \
        _single(gauss=True)
    spp = {}

    def case(name, r, spp_parallel, steps=1, **kw):
        mesh = make_mesh(RANKS, spp_parallel, devices=cpus)
        dr = DistributedRenderer(mesh, r.arrays, r.luts, r.camera, r.cfg,
                                 **kw)
        for _ in range(steps):
            dr.render_step()
        img = dr.image()
        spp[name] = dr.spp
        if rank == 0:
            np.save(os.path.join(out, f"{name}.npy"), img)
        return mesh

    for s in (1, 2, 4):
        case(f"box_spp{s}", box, s, steps=4 // s)
    case("wavefront", wave, 2, integrator="wavefront")
    case("gauss_tile2", gauss, 2, filter_params=GAUSS)
    case("gauss_tile4", gauss, 1, steps=2, filter_params=GAUSS)
    case("order_on", box, 2, tile_order=True)
    case("order_off", box, 2, tile_order=False)
    mesh = case("spp_batch", wave, 2, integrator="wavefront", spp_batch=2)

    class _Cfg:
        height = 18
        width = 16

    refused = []
    for n, s in ((3, 1), (4, 3)):
        try:
            make_mesh(n, s, devices=cpus)
        except ValueError:
            refused.append([n, s])
    tile4 = make_mesh(RANKS, 1, devices=cpus)
    rep = dict(shape=mesh.shape, spp_index=mesh.spp_index,
               tile_index=mesh.tile_index, device=str(mesh.device),
               tile4_shape=tile4.shape, tile4_index=tile4.tile_index,
               band_rows_18_tile4=band_rows(_Cfg, tile4), refused=refused,
               spp=spp)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist"))
    run_gloo_world(RANKS, _rank_cases, out)

    def load(name):
        if name.startswith("rank"):
            with open(os.path.join(out, f"{name}.json")) as f:
                return json.load(f)
        return np.load(os.path.join(out, f"{name}.npy"))

    return load


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process keeps parallel pytest workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def single_box():
    return _single().render(spp=4, samples_per_dispatch=1)


@pytest.mark.parametrize("spp_parallel", [1, 2, 4])
def test_distributed_matches_single_device(world, single_box, spp_parallel):
    np.testing.assert_allclose(world(f"box_spp{spp_parallel}"), single_box,
                               rtol=1e-5, atol=1e-6)
    assert world("rank0")["spp"][f"box_spp{spp_parallel}"] == 4


def test_distributed_wavefront_matches_single_device(world):
    """Each band drains its own pool: the single-process wavefront's
    image."""
    want = _single(integrator="wavefront").render(spp=2,
                                                  samples_per_dispatch=1)
    np.testing.assert_allclose(world("wavefront"), want, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("tile", [2, 4])
def test_distributed_filtered_film_matches_single_device(world, tile):
    """The halo's convolution reproduces the single-process filtered film
    across the band seams (bands of 8 and of 4 rows)."""
    want = _single(gauss=True).render(spp=2)
    np.testing.assert_allclose(world(f"gauss_tile{tile}"), want, rtol=1e-4,
                               atol=1e-5)
    assert world("rank0")["spp"][f"gauss_tile{tile}"] == 2


def test_distributed_tile_order_identical(world):
    """The band-local tile permutation does not change the image."""
    np.testing.assert_allclose(world("order_on"), world("order_off"),
                               rtol=1e-6, atol=1e-7)


def test_mesh_shapes(world):
    """Ranks lie row-major in the (spp, tile) grid; a 4-rank mesh refuses
    3 devices (one rank a device) and spp_parallel 3."""
    for rank in range(RANKS):
        rep = world(f"rank{rank}")
        assert rep["shape"] == {"spp": 2, "tile": 2}
        assert (rep["spp_index"], rep["tile_index"]) == divmod(rank, 2)
        assert rep["tile4_shape"] == {"spp": 1, "tile": 4}
        assert rep["tile4_index"] == rank and rep["device"] == "cpu"
        assert rep["band_rows_18_tile4"] == 5
        assert rep["refused"] == [[3, 1], [4, 3]]


def test_initialize_distributed_routing(monkeypatch):
    """Argument and environment routing: a no-op without an address,
    explicit arguments win, an explicit 0 wins over DCRT_PROCESS_ID, the
    environment's fallbacks apply, the backend follows the device (the
    call itself needs a coordinator, so init_process_group is stubbed)."""
    calls = []
    monkeypatch.setattr(
        dist, "init_process_group",
        lambda backend, init_method, world_size, rank:
        calls.append((backend, init_method, world_size, rank)))
    for k in ("DCRT_COORDINATOR", "DCRT_NUM_PROCESSES", "DCRT_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)

    initialize_distributed()                   # one process: no-op
    assert calls == []

    initialize_distributed("10.0.0.1:1234", 4, 2)
    assert calls[-1] == ("nccl", "tcp://10.0.0.1:1234", 4, 2)

    monkeypatch.setenv("DCRT_PROCESS_ID", "7")
    initialize_distributed("10.0.0.1:1234", 4, 0, device="cpu")
    assert calls[-1] == ("gloo", "tcp://10.0.0.1:1234", 4, 0)  # 0 wins
    monkeypatch.delenv("DCRT_PROCESS_ID")

    monkeypatch.setenv("DCRT_COORDINATOR", "10.0.0.9:99")
    monkeypatch.setenv("DCRT_NUM_PROCESSES", "8")
    monkeypatch.setenv("DCRT_PROCESS_ID", "3")
    initialize_distributed()
    assert calls[-1] == ("nccl", "tcp://10.0.0.9:99", 8, 3)

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    initialize_distributed("10.0.0.1:1234", 4, 2)   # already initialized
    assert len(calls) == 3


def test_distributed_wavefront_spp_batch_matches_single(world):
    """An (spp=2, tile=2) step with spp_batch=2 equals 4 sequential
    single-process samples (replica r, sample s: seed r * 2 + s)."""
    assert world("rank0")["spp"]["spp_batch"] == 4
    r = _single(integrator="wavefront")
    for s in range(4):
        r.render_sample(s)
    np.testing.assert_allclose(world("spp_batch"), r.image(), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("integrator,fp", [
    ("wavefront", GAUSS), ("megakernel", FilterParams("box", 0.5))])
def test_spp_batch_needs_wavefront_and_box_film(integrator, fp):
    mesh = Mesh({"spp": 2, "tile": 2}, 0, 0, CPU, None, None)
    with pytest.raises(ValueError, match="spp_batch"):
        distributed_render_step(mesh, _single().cfg, integrator=integrator,
                                filter_params=fp, spp_batch=2)


def test_distributed_matches_the_reference(world):
    """The reference's DistributedRenderer on make_mesh(4, spp_parallel=2)
    of the virtual CPU mesh, the same Cornell, Gaussian film and seeds."""
    import jax

    from directcomputeraytracing_tpu.film.filters import (
        FilterParams as RefFilterParams,
    )
    from directcomputeraytracing_tpu.integrator.renderer import (
        Renderer as RefRenderer,
    )
    from directcomputeraytracing_tpu.parallel import dist as ref_dist
    from directcomputeraytracing_tpu.scene.presets import (
        cornell_box as ref_cornell_box,
    )

    if len(jax.devices()) < RANKS:
        pytest.skip("needs the virtual CPU mesh")
    fp = RefFilterParams(kind="gaussian", radius=1.5)
    scene, cam = ref_cornell_box(light="area")
    r = RefRenderer(scene, cam, width=W, height=H, max_bounce=2,
                    filter_type="gaussian", filter_radius=1.5,
                    filter_params=fp)
    mesh = ref_dist.make_mesh(n_devices=RANKS, spp_parallel=2)
    dr = ref_dist.DistributedRenderer(mesh, r.arrays, r.luts, r.camera,
                                      r.cfg, filter_params=fp)
    dr.render_step()
    np.testing.assert_allclose(world("gauss_tile2"), dr.image(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip(n):
    """Even n: spp_parallel 2; odd n: 1. Both integrators."""
    dryrun_multichip(n, "cpu")


def test_dryrun_multichip_raises_a_rank_failure():
    """A rank's exception reaches the caller: here every rank fails on a
    device string torch does not know."""
    with pytest.raises(Exception, match="device"):
        dryrun_multichip(2, "no-such-device")


@pytest.mark.cuda
def test_cuda_world_of_one_matches_single_device(tmp_path):
    """A world of one on NCCL renders Cornell as one process does, the
    box and the Gaussian film (one band with both halos at the frame's
    edges)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert mesh.shape == {"spp": 1, "tile": 1} and mesh.device == \
            torch.device("cuda", 0)
        scene, cam = cornell_box("area", "glossy")
        for fp in (FilterParams("box", 0.5), FilterParams("gaussian", 2.0)):
            r = Renderer(scene, cam, 64, 48, max_bounce=4, device=dev,
                         filter_params=fp)
            dr = DistributedRenderer(mesh, r.arrays, r.luts, r.camera,
                                     r.cfg, filter_params=fp)
            for _ in range(2):
                dr.render_step()
            want = r.render(2, samples_per_dispatch=1)
            np.testing.assert_allclose(dr.image(), want, rtol=1e-5,
                                       atol=1e-6)
    finally:
        dist.destroy_process_group()
