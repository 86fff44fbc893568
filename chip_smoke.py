"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc
(CUDA_HOME, PATH or /usr/local/cuda). It imports no jax. Phases, in order;
any failure exits non-zero:

1. setup: print the card's name and power limit, build the dense-sweep,
   work-list, clustered, pair, ray-prep and probe kernels
   (csrc/brute_sweep.cu, csrc/worklist.cu, csrc/clustered.cu,
   csrc/pairsweep.cu, csrc/prep.cu, csrc/probes.cu; the six nvcc runs in
   parallel, and beside them g++ on the host's BVH builder,
   ops/native/bvh_builder.cpp) and print the build times and ptxas
   reports, then the
   warp-walk sweeps' (grouped, per-ray and instanced, closest and
   any-hit) registers, shared memory and spills (ptxas, `warp-ptxas`)
   and their resident blocks per SM (`warp-resources`), and the same of
   the work list's cull and refine (`cull-ptxas`, `cull-resources`), of
   the dense sweep (`brute-ptxas`, `brute-resources`: resident blocks
   per SM with a full 2048-row table), of the clustered cull and sweeps
   (`cluster-resources`) and of the pair kernels (`pair-ptxas`,
   `pair-resources`: the emission and both sweeps);
2. dense-sweep kernels against their PyTorch twins on the card, Moeller
   and watertight, closest and any-hit, on `tools/brute_ab.py`'s sets:
   (a) the Cornell soup (32 triangles) with 1,048,576 camera rays plus
   1,048,576 random rays from inside the box, (b) a seeded 2048-triangle
   random soup with 1,048,576 random rays, (c) the adversarial set (each
   triangle cast alone: u, v and u + v at their limits, det at +-1e-10,
   products that underflow, t at t_min and t_max, degenerate triangles,
   axis and near-axis rays); mismatch counts, max errors and the rays
   whose bits differ per field (all 0, or the phase fails); CUDA-event
   and profiler (kernel) times and twin times on the Cornell camera rays
   and the soup's, at 2^20 rays and at a 2^18 pool;
2b. work-list kernels (cull, refine, closest and any-hit sweeps) against
   their twins on sphere_grid(12, 12) (211,972 triangles), Baldwin-Weber
   and watertight: 1,048,576 tiled camera rays, 1,048,576 random rays
   from inside the scene box, 1,048,576 shadow rays towards the lamp with
   per-ray t_max; mismatch counts of the casts against the plain casts
   (every step in PyTorch; on the whole camera set and on 64 ray blocks
   spread over the random and shadow sets), `iters` equality, the kernels' item lists
   equal to the plain phases', the closest sweep against its twin (on
   the plain prep and phases) in every field of the sweep state and the
   any-hit cast's occlusion equal to the plain cast's on every ray,
   kernel and twin times at the camera rays (CUDA events) and the
   any-hit sweep's on the shadow rays, items per block and mean clusters
   swept per ray; the censuses of the per-ray sweeps' warp walks,
   counted by walking the twins' steps (`tools/worklist_ab.py`
   `ray_census` and `any_census`, which give the twins' results):
   closest, the shares of (item, warp) pairs that pass the block vote of
   the first per-ray kernel, the warp vote and the super-box admission,
   fine-cull slab tests per ray against the block walk's, items entered
   per ray (`ray-census` lines); any-hit, the shares of pairs visited (a
   ray of the warp not yet done) and admitted, the same tests and items
   (`any-census` lines); the cull and the refine against their twins
   bit for bit (the sign of a zero included) on every set, and their
   times and bounds on the shadow rays and on the random set sorted by
   `ray_sort_key` (the megakernel's sorted bounce casts) beside the
   camera rays' (`worklist timing culls` lines);
2c. grouped work-list kernels (closest and any-hit) against their twins
   and against the per-ray sweeps on the three 1M-ray sets of 2b plus the
   random set sorted by `ray_sort_key` (like a permuted pool) and a
   pool-sized (2^18) sorted set, Baldwin-Weber and watertight: mismatch
   counts of every field, `iters` equality against the twin; the twins
   run on 16 ray blocks spread over each 1M-ray set (the camera set's
   are tiles), where a 1M-ray twin cast would take minutes, and on the
   whole pool-sized set; CUDA-event
   times of grouped and per-ray kernels, clusters swept per ray; the
   census of the grouped walk on the twins' rays, counted by walking the
   twins' steps (`tools/worklist_ab.py`; the walks are the twins: their
   states are what the kernels are held to): items per block, the shares
   of (item, warp) pairs that pass the block vote, the warp vote and the
   super-box admission (any-hit: of the warps not
   yet occluded), fine-cull slab tests per ray of the grouped walk and
   of a walk by blocks, beside the clusters swept per ray of the grouped
   and per-ray sweeps on the whole set;
2d. instanced work-list kernels (closest and any-hit sweeps) against their
   twins on sphere_grid(27, 27) (1,073,092 world triangles from 1,476
   local ones, in the instanced tables), Baldwin-Weber and watertight:
   1,048,576 tiled camera rays, 1,048,576 shadow rays towards the lamp,
   1,048,576 random rays from inside the box sorted by `ray_sort_key`,
   and a pool-sized (2^18) sorted set. The twins run on 16 blocks spread
   over each set (16,384 rays; a 1M-ray twin cast takes minutes), where
   kernel and twin must agree in every field of the sweep state and the
   kernels' item lists must equal the twins'; the censuses of the
   closest and any-hit sweeps' warp walks on those rays (as in 2b; the
   twins' results come from them) and on the whole camera set;
   CUDA-event times, bounds and the item census (items per block,
   clusters swept per ray) on the whole sets, beside the soup's census
   of 2b; the hyper cull (183 hypers: chunks of 64 boxes, the last one
   partial) and the refine (16 members) against their twins bit for bit
   on each whole set, with the closest and the any-hit casts' t_max
   (`instanced cull-and-refine-vs-twin`);
2e. instanced against soup: sphere_grid(12, 12) flattened twice, as the
   world soup and forced onto the instanced tables (SOUP_MAX_TRIS
   lowered): on 1,048,576 camera rays, watertight and Baldwin-Weber,
   equal hit masks, t within rtol 3e-5, triangle and instance ids equal
   except at near-ties (2^-12), but for rays the two roundings of the
   geometry part: watertight, a nearer hit within 1e-4 (barycentric) of
   an edge; Baldwin-Weber, a crack of that test, where the nearer hit is
   the watertight one (counted and listed); then both rendered at
   256x256, 4 spp, within the CPU-vs-card gates;
2f. clustered kernels (cull, closest and any-hit sweeps) on
   sphere_grid(12, 12), Moeller and watertight: 1,048,576 tiled camera
   rays, 1,048,576 shadow rays towards the lamp, 1,048,576 random rays
   from inside the box sorted by `ray_sort_key`, and a pool-sized (2^18)
   sorted set. The cull kernel's masks must equal its twin's on every
   set, and contain the exact per-ray masks on 16 blocks spread over it;
   the sweeps must equal their twins in every bit of every field on those
   16 blocks, and the dense sweep over the world soup on the whole set
   (`tools/clustered_ab.py` `graze_diffs`): hits, t, and u, v and side of
   the same triangle equal, ids equal but at exact-t ties (counted),
   except edge grazes: a ray whose dense hit lies in a cluster whose box
   its own slab test misses, which the warp admission may leave out
   (listed, explained, and no other difference allowed); CUDA-event
   times, the bounds of the warp walks and of the first block walk, and
   the census of the warp walks (`admission_census`: clusters and groups
   entered per block, group boxes and clusters admitted per warp, votes
   and triangle tests per ray; no cluster admitted in a group whose box
   its warp does not enter);
2g. pair kernels (emission, closest and any-hit pair sweeps) against
   their twins on sphere_grid(12, 12), Baldwin-Weber and watertight:
   1,048,576 shadow rays towards the lamp, 1,048,576 random rays sorted
   by `ray_sort_key`, and the pool-sized (2^18) sorted set. The emission
   grid must equal its twin's on the whole set, the sweeps their twins
   in every per-pair field on the pairs of 64 spread blocks (the closest
   sweep also `tools/pair_ab.py` `closest_replay`, the model of its
   dealt tests and replay), and the pair casts `worklist_closest` / `worklist_any` in every hit field on
   the whole set (`iters` at least the work list's); CUDA-event times of
   each step (emission, `nonzero`, the pair list, the sweep, the
   reduction) and of the whole pair, work-list and grouped casts, the
   profiler's kernel times of the emission and the sweeps, the peak
   memory of a pair cast, bounds, and the census (items, cells, pairs
   per ray, pairs per chunk, clusters swept per pair; `pair-census`
   lines, `tools/pair_ab.py` `pair_census`: items per ray block, set
   cells, full chunks, clusters a pair enters, a warp's longest lane and
   union, the closest walks' clusters swept per pair, longest walk per
   warp and the rounds and tests of the closest sweep's two schedules,
   and the any-hit walks' clusters and rows per pair);
2h. the ray-prep kernel against `prep_rays_torch` on the three 1M-ray
   sets of 2b, the random set in `ray_sort_key` order and a 1M-ray set
   with NaN, inf, zero, +-1e-31, -0.0 and denormal components injected,
   each without and with a per-ray t_max: od and tm bit-equal; CUDA-event
   times of the kernel and the twin's route on the camera rays;
2i. the probes through the port's tools (`tools/probe_worklist.py`,
   `tools/prof_prep.py`), their launches counted from 0: the item-list
   kernel at the reference probe's four capacities (64 blocks, 4096
   slabs, 1,024 to 262,144 items) and on `crafted_inputs` (lanes at
   +-0, NaN and +-inf, a NaN slab entry, -0 and +0 sums in one block),
   equal to its twin bit for bit (a NaN equal to any NaN), CUDA-event
   and profiler ms and ns per item beside `sweep_closest`'s cost per
   item on 2b's camera rays, its split (CUDA blocks a ray block) and
   resident blocks per SM, its two bounds (`item-list bounds`); the
   (2^20, 16) transpose bit-equal to `.T.contiguous()` (the library
   call, timed) and to its twin, beside the layout routes (the twin's
   cat-and-transpose prep, the prep kernel, a 36 MB copy);
3. the main path: Cornell glossy 1024x1024, 16 spp, max_bounce 4 through
   `Renderer.render`, with the kernels' launch counts checked against
   spp * (max_bounce + 2) * chunks (closest) and spp * (max_bounce + 1) *
   chunks (any-hit);
3b. the main path on a clustered scene: sphere_grid(12, 12) 1024x1024,
   16 spp, max_bounce 4. Closest sweeps plus closest casts with an empty
   item list must equal spp * (max_bounce + 2) * chunks, any-hit sweeps
   plus empty any-hit casts spp * (max_bounce + 1) * chunks; one cull per
   cast, one refine per cast whose hyper cull admitted something; no
   dense-sweep launch;
3c. the wavefront path: sphere_grid(12, 12) at 1920x1080, max_bounce 4,
   `Renderer(..., integrator="wavefront").render(8)` (one fused pool pass
   of 8 samples) after a two-sample warm-up; ms/spp, peak memory, `LAST_STATS`; the
   bundle sweeps launch 0 times, grouped sweeps plus empty casts equal
   the pool casts `LAST_STATS` counted, one cull per cast; then the same
   pass without slab marching (slab_march=0.0) and with it again, in the
   order off, on (with the render: on, off, on), its image held to the
   render's (RMSE <= 1e-3); then a pass of 2 samples through the
   three pool backends in turns (the grouped default, "pallas_wl",
   "pallas_pair"; grouped, wl, pair, pair, wl, grouped, after a
   one-sample warm-up pass of the last two); then one timed pass with a
   2^20-path pool;
3d. the wavefront against the megakernel on the card (sphere_grid(12,
   12), 256x256, 4 spp, same seeds): RMSE <= 1e-3;
3e. the main path on the instanced scene: sphere_grid(27, 27) 1024x1024,
   16 spp, max_bounce 4, after a warm-up; the launch rule of 3b with the
   instanced sweeps, and no soup, grouped or dense sweep;
3f. the wavefront on the instanced scene: 1920x1080, 4 spp, max_bounce
   4, default pool and slab marching, after a warm-up; the rule of 3c
   with the instanced sweeps;
3g. the main path through traversal_backend="pallas_cluster":
   sphere_grid(12, 12) 1024x1024, max_bounce 4, after a one-sample
   warm-up; culls, closest sweeps and any-hit sweeps each one per cast
   (spp * (max_bounce + 2) closest and spp * (max_bounce + 1) any-hit
   casts), no other kernel launched;
3h. the wavefront through "pallas_cluster": sphere_grid(12, 12) at
   1920x1080, max_bounce 4, one pool pass, after a warm-up; ms/spp,
   `LAST_STATS`, peak memory; launches one per pool cast that
   `LAST_STATS` counts, and no slab phase;
3i. the main path through traversal_backend="pallas_pair":
   sphere_grid(12, 12) 1024x1024, 4 spp, max_bounce 4, after a one-sample
   warm-up: one cull per cast (one refine where the hyper cull admitted
   something), one emission per cast with items, one pair sweep per cast
   with pairs; pair sweeps plus empty casts equal spp * (max_bounce + 2)
   closest and spp * (max_bounce + 1) any-hit casts; no other sweep;
3j. the wavefront with pool_backend="pallas_pair": sphere_grid(12, 12) at
   1920x1080, 4 spp in one pool pass, max_bounce 4, default slabs, after
   a warm-up: ms/spp, `LAST_STATS`, peak memory, the launch rule of 3i
   over the pool casts `LAST_STATS` counts (slab phases included), and
   the image against the grouped sweep's pass at the same seed (timed
   beside it), RMSE <= 1e-3;
3k. the alpha-tested main path: `alpha_sphere_grid(12, 12)` (the spheres
   of override 1 at opacity 0.4: the opaque/masked split, 8,192 clusters
   a side) 1024x1024, 4 spp, max_bounce 4, after a one-sample warm-up:
   ms/spp, peak memory, recast passes per cast, and the rule of 3b where
   every cast is one opaque cast and one recast loop (`alpha_calls`) and
   every recast pass (`alpha_passes`) one more closest cast: prep
   launches equal the work-list casts made, recast passes and opaque
   split casts included;
3l. the wavefront on the same scene, 1920x1080, 2 spp, one pool pass
   after a warm-up: `LAST_STATS` and the rule of 3k over the pool casts;
3m. the textured variant (opacity 1, the dot-grid mask over the
   spheres' UVs), megakernel 1024x1024, 2 spp: the rule of 3k;
3n. the headline stand-in through the wavefront: `write_standin_scene`
   (144 OBJ spheres of 1472 triangles, 211,972 world triangles with the
   two rectangles, the whole BSDF mix, a `mask` BSDF with a bitmap
   opacity) into a temporary directory, `load_mitsuba_xml`, then
   `Renderer(..., 1920, 1080, max_bounce=4, integrator="wavefront",
   filter_params=FilterParams("gaussian", radius=2.0))`; one untimed
   `render(2)`, then one timed `render(8)`: one fused pool pass with
   per-sample slots and 8 Gaussian convolutions. Prints the host seconds
   to write, load and flatten, ms/spp, the film's seconds (the slots'
   gather to raster order and the convolutions, host clock between
   synchronisations) and share, `LAST_STATS`, the alpha recast counts,
   the slot buffers' bytes, peak memory and launches per sample; the rule
   of 3l over the pool casts; the image must be finite and non-zero;
3o. the same scene, film, seeds and 8 spp through the megakernel (one
   sample a pass, 2 pixel chunks), after a one-sample warm-up: ms/spp,
   the rule of 3k, and the image against 3n's within rtol 1e-5,
   atol 1e-6 (the two integrators trace the same paths; the film
   convolves each sample alike);
3p. the stack walker at real size: `walker_grid(129, 128)` (a 64-triangle
   sphere on a 129 x 128 grid, 1,056,768 world triangles: the node table
   alone, no soup, no work-list tables) through `Renderer` (megakernel,
   512x512, max_bounce 4, 1 spp after a one-sample warm-up): host
   seconds of the flatten and of its two-level build (the C++ TLAS
   over 16,512 instances; and `sphere_grid(27, 27)`'s flatten beside its
   deferred node-table build, which 3n prints for the stand-in), node
   count, stack size, bytes of the tables
   on the card, ms/spp, peak memory, the walks made (spp * (2 max_bounce
   + 3), no kernel launched) and their steps; then a 262,144-ray camera
   cast with the done check every `WALK_CHECK_EVERY` steps and every
   step, in turns (ms, steps, host reads; the results equal), its
   iterations a ray (mean, max); 4,096 of its rays against the port's
   CPU walker on the same tables (integer fields bit for bit, t within
   1e-5 (1 + t)) and 256 against `trace_ray` (hit and triangle equal);
3q. the CLI on the card, in subprocesses (`python -X importtime -m
   directcomputeraytracing_tpu_torch.cli.render`: rc 0, its JSON line,
   no jax module imported): the stand-in XML at its own 1920x1080
   Gaussian film, 2 spp, megakernel, with its checkpoint's film finite
   and non-zero (the wall seconds); then, run at once,
   `preset:cornell-glossy` 512x512 at 4 spp with --checkpoint and again
   at 8 spp (it resumes at 4), `--aov iteration_count` and `--aov normal`
   on Cornell (the walker) and `preset:spheres-12` (the work list), and
   `--output-bvh` on Cornell (the dump parses and equals the port's CPU
   dump); the resumed film against an in-process 8-sample
   `render_sample` loop on the card within rtol 1e-6, weights equal;
3r. `bake_luts(seed=0, quality=1.0)` on the card: seconds, and each table
   against the committed bake within the noise gate of
   `tests/test_torch_lut_bake.py` (twice the reference's seed-to-seed
   spread at quality 0.25);
3s. scene edits and the preview on 3n's stand-in at 1920x1080 through
   the megakernel (max_bounce 4, 3n's film): the median host ms
   (synchronised) of EDIT_REPEATS edits of each kind through the
   renderer's `set_*`: an albedo and then an opacity of EDIT_MATERIAL
   (an untextured opaque material turned masked, which drops the
   opaque/masked split over the 211,972 triangles) and the emitter's
   radiance, each printed with the card's name and power limit; one
   fixed-seed sample after the albedo edits against a fresh Renderer of
   the edited scene (rtol 1e-5, atol 1e-6, as 3o), and one after the
   opacity edits, through the full recast path, against a fresh Renderer
   that has the split (phase 4's gate; both timed after an untimed
   sample); the launch rule of 3k (without
   the split: one recast loop a cast, every pass one closest cast);
   `cluster_bbox`, `inst_rows`, `world_tris` and `cluster_tris` the
   renderer's own tensors after the edits (no traversal table rebuilt);
   then `preview(spp=1, scale=PREVIEW_SCALE)` at 480x270, three timed
   calls, its launches, the film left as it was;
3t. the editor: `tools/editor.py` `EditorSession` on Cornell glossy at
   960x540 served on 127.0.0.1 (port 0): GET /state, a material POST
   /edit, GET /preview?spp=1 twice (host ms; the PNG's shape, the dense
   sweep's launches), a POST /camera move, /state and /preview again;
3u. the single-sample entry: `entry("cuda")`, one call of its fn timed
   after an untimed one, its launches, its values against
   `entry("cpu")` under phase 4's gate (jitter positions equal);
3v. the distributed renderer (`parallel/dist.py`): a world of one on NCCL
   (a file store in a temporary directory) renders 3n's stand-in at
   1920x1080 through the megakernel and 3n's film, one band with both
   halos at the frame's edges, two steps: the second step's host ms
   (synchronised) beside the one-process `render(2)`'s ms/spp, 3o's
   ms/spp and the card's name and power limit,
   its launches (2 pixel chunks, the rule of 3k), and the image after
   both steps against that Renderer's `render(2)` (rtol 1e-5, atol 1e-6,
   as 3o); then two gloo ranks spawned on the card (`entry.
   run_gloo_world`) render Cornell glossy at 256x256, max_bounce 4:
   spp_parallel 2 (one band, box film, one step) and spp_parallel 1 (two
   bands, the Gaussian film of radius 2 across the seam, two steps),
   each against a one-process Renderer at the same seeds under the same
   gate, each rank's dense-sweep launches by the rule; then
   `entry.dryrun_multichip(2)` on the card (both integrators, 32x32).
   One card: NCCL runs a world of one, and the two gloo ranks share it;
3w. the BVH builders (`ops/native`, C++ built with g++ in phase 1, the
   default of every other phase's flatten; and the numpy builder of
   `accel/build.py`): `walker_grid(129, 128)` flattened through
   `Renderer` with DCRT_NATIVE_BVH=0 and =1, the host seconds of each
   flatten, of its BLAS builds, of its two-level build and of the TLAS
   build inside that (16,512 instance boxes), and the node tables and
   leaf-ordered triangles bit for bit; then the BLAS of one
   `uv_sphere(*BUILDER_MESH)` (97,792 triangles) by each builder: host
   seconds, every array of the `BVH` bit for bit. Printed with the
   card's name and power limit; any difference fails the phase;
4. the card's render against the port's CPU render, Cornell (64x64,
   4 spp), 4b. sphere_grid(3, 3, stacks=12, slices=16) (64x64, 4 spp),
   4c. the same small grid through the wavefront, 4d. the same small
   grid forced onto the instanced tables (megakernel), 4e. the same
   small grid through "pallas_cluster" (megakernel), 4f. the same small
   grid through the wavefront with pool_backend="pallas_pair", 4g. the
   same small grid through the megakernel with slab_march=0.03, 4h. the
   alpha-tested panel (the dense sweep, megakernel), 4i. the small grid
   with alpha through the wavefront and 4j. its textured variant
   (megakernel), 4k. the small stand-in (`write_standin_scene(d, nx=2,
   nz=2, stacks=8, slices=12)`, 676 triangles, the dense sweep) through
   the wavefront with the Gaussian film of 3n, 64x36, 2 spp, 4l.
   `walker_grid(6, 6)` (2,304 world triangles from 64) with
   SOUP_MAX_TRIS lowered to FORCED_SOUP_MAX: the node table alone, the
   walker, 32x32, 1 spp, 4m. 3s's albedo and opacity edits on 4k's
   small stand-in (megakernel, 64x36, 2 spp): the edited tables bit for
   bit, the images under the gate;
5. one JSON line listing the nineteen kernels, then the contract line,
   last. `ms` is CUDA events around runs of wrapper calls; rows 1-3 and
   15-17 also give `kernel_ms`, the kernels' own time by the profiler
   (a short cast is timed by events with the host's gaps between its
   launches).

The seeded ray sets of the sphere grids (2b-2h) come from
`tools/common.py` `grid_ray_sets`, each phase with its own seed.
Phases 2b-2d and 2f hold the casts of the camera set to their twins
under both triangle tests, the default and the watertight one, and those
of the other sets under the default test (`_tests`): the sets differ in
how the walks go, and the walks are the same code under either test.
A render's warm-up is one fused pass of WARM_SPP samples, the timed
call's code path (3g, 3i, 3k, 3m, 3o and 3p warm up with one sample).

Tolerances (kernel vs twin): the kernels are built without FMA
contraction, so they round like the twins; the dense sweep must equal its
twins bit for bit in every field (phase 2); a hit/miss or occlusion
disagreement is allowed only where the twin's t lies within 1e-5 (1 + t)
of t_min or t_max, a triangle-id disagreement only between hits within
that bound of each other (a near-tie; for the work list also within
2^-12 relative, twice the packed argmin's truncation quantum), and t, u,
v of same-triangle hits must agree within 1e-5 (relative to 1 + t for
t). Work-list `iters` must be equal, the per-ray closest sweep its
twin in every field of the sweep state, and the per-ray any-hit casts
their twins' occlusion on every ray. The grouped kernels must equal
their twins in every field, and the per-ray sweeps in every hit field. The
grouped any-hit sweep's plain version is the per-ray twin
`sweep_any_torch`, whose answer the grouped walk must give (its
`plain_ms` in the kernels line times that twin). The instanced kernels
must equal their twins in every field, `iters` included, and so must
the clustered kernels (every bit), whose masks are bit-equal to the cull
twin's.

Bounds (`bound_ms` of the kernels line): the larger of the counted
floating-point operations at 67 TFLOP/s and the bytes read and written
once at 3.35 TB/s (the H100 SXM's published float32 and memory rates),
from this run's inputs: a Moeller test 45 operations (the dense sweep:
one a (ray, row) pair, `tools.common.dense_bound`), a Baldwin-Weber
test 31, a slab test of a ray and a box 20, the move of a ray to
instance space 33; tables count once, whole. The cull and the refine
count 28 bytes a ray (origin, 1/d, t_max: the slab test reads no
direction) and 24 a box (`tools.common.cull_bound`, `refine_bound`).
The work-list sweeps
count the work their warp walks need, from the censuses of the walks on
the camera rays (2b; 2d on the whole camera set; the grouped sweeps from
2c's census of the pool), with the admission boxes among the tables:
one admission slab test a ray of each (item, warp) pair the warp visits
(closest: past the warp vote; any-hit: some ray of the warp not yet
done), the fine cull of each pair the warp admits, on instanced tables
the move to instance space of each (ray, item) whose fine cull entered a
child, and for the closest sweeps 16 triangle tests per cluster the ray
swept (the any-hit sweeps leave their triangle tests out, so theirs are
lower bounds). Their `bound_ms_block_walk` keeps the count of the first
designs, which walked the items by 1024-ray blocks: the fine cull of
every item of the ray's block and, closest, the triangle tests. The
clustered cull counts what its kernel computes on 2f's camera rays
(`tools/clustered_ab.py` `cull_bound`): per (ray block, cluster) of a
block with a reaching ray 10 operations per axis whose direction bounds
do not span zero and 3 for enter; its `bound_ms_reference` keeps the
reference's count, FLOPS_INTERVAL (87) per (ray block, cluster), and
both count 24 bytes a ray, 32 a box and a byte a mask entry. The
clustered sweeps
count their warp walks' work, from the census of 2f's cast
(`clustered_ab.admission_census`): FLOPS_VOTE (26) per slab vote of a
lane (one per group its block entered, one per masked cluster of each
group whose box its warp enters) and one Moeller test per row of every
cluster admitted for the ray's warp; the any-hit sweep only the votes of
the warps that hold a ray ending unoccluded and the triangle tests of
those rays (a lower bound). Their `bound_ms_block_walk` keeps the first
design's count: one Moeller test per ray and row of every cluster the
ray's block entered (any-hit: the rays that end unoccluded only).
The pair emission counts 20 operations a cell against the grid written
and the rays, caps, items and super boxes read once; the pair closest
sweep the fine cull of every pair (32 slab tests) and 16 triangle tests
per cluster its walk swept, the any-hit sweep the fine cull only (a
lower bound), against the pair list, rays, per-pair outputs and tables
read or written once. The pair kernels must equal their twins in every
field. The ray prep counts 24 bytes read a ray and 40 written a padded
ray (14 operations a ray bound nothing); the item-list probe 23
operations a (row, lane) of each item against the items, the slab table
and the rays read once, and beside it `bound_ms_issue`: 24 FP32
instructions a (row, lane) (12 FMUL, 11 FADD, 1 FMNMX; 67 TFLOP/s counts
an FMA as two operations, which no kernel built with -fmad=false can
reach) at 132 SMs x 128 lanes x the card's highest SM clock
(`nvidia-smi clocks.max.sm`); the transpose 64 bytes read and 64 written
a row. Prep and probes must equal their twins bit for bit.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext

import numpy as np

from directcomputeraytracing_tpu_torch.tools.common import bound, dense_bound

TOL = 1e-5
TIE_WL = 2.0 ** -12
N_RAYS = 1 << 20
RENDER = dict(width=1024, height=1024, spp=16, max_bounce=4)
SMALL = dict(width=64, height=64, spp=4, max_bounce=4)
GRID = (12, 12)                         # 211,972 world triangles
SMALL_GRID = ((3, 3), dict(stacks=12, slices=16))
# CPU vs card render gate. Paths are identical up to float rounding
# (transcendentals differ by an ulp between torch's CPU and CUDA math);
# a rare flipped branch changes one path of one pixel, so the gate allows
# a few diverged pixels but not a systematic difference.
GATE_RMSE = 0.02
GATE_DIVERGED_FRACTION = 0.01
WAVEFRONT = dict(width=1920, height=1080, spp=8, max_bounce=4)
AB_SPP = 2                              # samples of 3c's pool-backend turns
WL_TWIN_BLOCKS = 64                     # ray blocks of 2b's random, shadow
WARM_SPP = 2            # a warm-up's samples: one fused pass, as timed
POOL_BIG = 1 << 20
GROUPED_TWIN_BLOCKS = 16                # ray blocks of 2c's twins on 1M sets
MK_VS_WF = dict(width=256, height=256, spp=4, max_bounce=4)
GATE_WF_RMSE = 1e-3
INST_GRID = (27, 27)                    # 1,073,092 world triangles, instanced
INST_TWIN_BLOCKS = 16                   # ray blocks of an instanced twin cast
INST_WAVEFRONT = dict(width=1920, height=1080, spp=4, max_bounce=4)
FORCED_SOUP_MAX = 2048                  # SOUP_MAX_TRIS that forces instancing
INST_VS_SOUP = dict(width=256, height=256, spp=4, max_bounce=4)
T_RTOL_INST = 3e-5
EDGE_TOL = 1e-4                         # barycentric margin of an edge hit
FLOPS_MOELLER, FLOPS_BW, FLOPS_SLAB = 45, 31, 20
ISSUE_ITEM_LIST = 24                    # FP32 instructions a (row, lane)
SMS, FP32_LANES = 132, 128              # H100 SXM: SMs, FP32 lanes an SM
FLOPS_LOCAL_RAY = 33        # [o, 1] @ M, d @ M: 18 products, 15 sums
CLUSTER_TWIN_BLOCKS = 16                # ray blocks of a clustered twin cast
CLUSTER_RENDER = dict(width=1024, height=1024, spp=4, max_bounce=4)
CLUSTER_WAVEFRONT = dict(width=1920, height=1080, spp=2, max_bounce=4)
PAIR_TWIN_BLOCKS = 64                   # ray blocks of a pair twin sweep
PAIR_RENDER = dict(width=1024, height=1024, spp=4, max_bounce=4)
PAIR_WAVEFRONT = dict(width=1920, height=1080, spp=4, max_bounce=4)
ALPHA_RENDER = dict(width=1024, height=1024, spp=4, max_bounce=4)
ALPHA_WAVEFRONT = dict(width=1920, height=1080, spp=2, max_bounce=4)
ALPHA_TEX_RENDER = dict(width=1024, height=1024, spp=2, max_bounce=4)
STANDIN = dict(width=1920, height=1080, spp=8, max_bounce=4)
STANDIN_FILTER = ("gaussian", 2.0)      # the CLI's radius for a Gaussian
SMALL_STANDIN = dict(nx=2, nz=2, stacks=8, slices=12)
SMALL_STANDIN_RENDER = dict(width=64, height=36, spp=2, max_bounce=4)
WALKER_GRID = (129, 128)                # 1,056,768 world triangles from 64
WALKER_RENDER = dict(width=512, height=512, spp=1, max_bounce=4)
WALKER_CPU_RAYS, WALKER_TRACE_RAYS = 4096, 256
BUILDER_MESH = (192, 256)               # uv_sphere: 97,792 triangles (3w)
SMALL_WALKER_GRID = (6, 6)              # 2,304 world triangles, forced
SMALL_WALKER_RENDER = dict(width=32, height=32, spp=1, max_bounce=4)
CLI_CORNELL = ["--resx", "512", "--resy", "512"]
CLI_STANDIN_SPP = 2
EDIT_REPEATS = 5                        # timed edits of each kind (3s)
EDIT_MATERIAL = "mat-diffuse"           # the stand-in's untextured opaque
                                        # material the edits of 3s, 4m take
PREVIEW_SCALE = 4                       # 3s: 480x270 of the 1080p frame
EDITOR = dict(width=960, height=540, preview_scale=3)
DIST_CORNELL = dict(width=256, height=256, max_bounce=4)
# 3v's gloo cases: (name, spp_parallel, steps, film); spp_parallel 1 is
# two bands of 128 rows, the Gaussian film across their seam
DIST_CORNELL_CASES = (("box_spp2", 2, 1, ("box", 0.5)),
                      ("gaussian_tile2", 1, 2, ("gaussian", 2.0)))
# the reference bake's own spread at quality 0.25 over the pairs of seeds
# 1-5 (tests/test_torch_lut_bake.py SPREAD): table -> (largest mean,
# largest max absolute difference); the noise gate is twice these
BAKE_SPREAD = {"brdf": (0.00942, 0.01591), "brdf_avg": (0.00937, 0.01483),
               "brdf_dielectric": (0.00235, 0.02126),
               "brdf_dielectric_avg": (0.00206, 0.01078),
               "bsdf": (0.00163, 0.01003), "bsdf_avg": (0.00155, 0.00450)}


def _tests(name):
    """The triangle tests that a ray set's work-list and clustered casts
    are held to their twins with (2b-2d, 2f): both, the default and the
    watertight one, on the camera set; the default on the others, which
    differ from it in how the walks go, and the walks are the same code
    under either test."""
    return (False, True) if name == "camera" else (False,)


def _timed_call(fn):
    """(fn(), its ms) of one launch, timed with CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare_kernels(tab, o, d, t_max, t_min, watertight):
    """Dense-sweep kernel vs twin on one ray set; the mismatch report, with
    the rays whose bits differ per field (`bits`, zeros' signs included)."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.tools import brute_ab

    scene = brute_ab.Soup(tab)
    k = brute.brute_closest(scene, o, d, t_min, watertight)
    w = brute.brute_closest_torch(tab, o, d, t_min, watertight)
    occ_k = brute.brute_any(scene, o, d, t_max, t_min, watertight)
    occ_w = brute.brute_any_torch(tab, o, d, t_max, t_min, watertight)
    torch.cuda.synchronize()
    rep = _mismatches(k, w, occ_k, occ_w, o, t_max, t_min, 0.0)
    rep.update(tris=tab.shape[0], watertight=bool(watertight),
               bits=dict(brute_ab.closest_diffs(k, w),
                         occ=int((occ_k != occ_w).sum())))
    return rep


def _mismatches(k, w, occ_k, occ_w, o, t_max, t_min, tie_rel):
    """Mismatch report of kernel (k, occ_k) against twin (w, occ_w)
    results; tie_rel widens the near-tie bound by tie_rel * |t|."""
    import torch

    (tk, uk, vk, trik, instk, backk), (tw, uw, vw, triw, instw, backw) = \
        k[:6], w[:6]
    hk, hw = torch.isfinite(tk), torch.isfinite(tw)

    def near(t, bound):
        """t finite and within TOL (1 + |t|) + tie_rel |t| of bound."""
        return torch.isfinite(t) & ((t - bound).abs()
                                    <= TOL * (1 + t.abs()) + tie_rel * t.abs())

    hit_miss = hk != hw
    hit_miss_bad = hit_miss & ~near(torch.where(hw, tw, tk), t_min)
    both = hk & hw
    tri_diff = both & (trik != triw)
    tri_bad = tri_diff & ~near(tk, tw)
    same = both & (trik == triw)
    dt = torch.where(same, (tk - tw).abs() / (1 + tw.abs()), 0.0)
    du = torch.where(same, (uk - uw).abs(), 0.0)
    dv = torch.where(same, (vk - vw).abs(), 0.0)
    attr_bad = same & ((instk != instw) | (backk != backw))
    occ_diff = occ_k != occ_w
    # an occlusion flip is explained when the nearest hit above t_min sits
    # at t_max (or t_min) within the bound
    tm = torch.as_tensor(t_max, device=o.device).expand(o.shape[:1])
    occ_bad = occ_diff & ~(near(tw, tm) | near(tw, t_min))
    rep = dict(rays=o.shape[0],
               hits=int(hw.sum()), occluded=int(occ_w.sum()),
               hit_miss_diff=int(hit_miss.sum()),
               hit_miss_unexplained=int(hit_miss_bad.sum()),
               tri_diff=int(tri_diff.sum()),
               tri_unexplained=int(tri_bad.sum()),
               inst_or_back_diff=int(attr_bad.sum()),
               max_rel_dt=float(dt.max()), max_du=float(du.max()),
               max_dv=float(dv.max()),
               occ_diff=int(occ_diff.sum()),
               occ_unexplained=int(occ_bad.sum()))
    rep["ok"] = (rep["hit_miss_unexplained"] == 0 and rep["tri_unexplained"]
                 == 0 and rep["inst_or_back_diff"] == 0
                 and rep["occ_unexplained"] == 0
                 and max(rep["max_rel_dt"], rep["max_du"], rep["max_dv"])
                 <= TOL)
    rep["closest_max_abs_err"] = float(max(
        torch.where(same, (tk - tw).abs(), 0.0).max(), du.max(), dv.max()))
    rep["any_max_abs_err"] = float(occ_diff.float().max())
    return rep


def phase_kernels(device):
    """Dense-sweep kernels against their twins (phase 2) on
    `tools/brute_ab.py`'s sets: bit differences per field on the Cornell
    soup's camera and random rays, the 2048-triangle soup and the
    adversarial set (each triangle cast alone); CUDA-event and profiler
    times at 2^20 and 2^18 rays."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.tools import brute_ab
    from directcomputeraytracing_tpu_torch.tools.common import (
        kernel_ms,
        timed,
    )

    sets = brute_ab.dense_sets(device, names=(
        "cornell_camera", "cornell_random", "cornell_pool", "soup_random",
        "soup_pool"))
    cam, rnd = sets["cornell_camera"], sets["cornell_random"]
    cases = {"cornell32": (cam[0], *(torch.cat([a, b]) for a, b in zip(
                 cam[1:], rnd[1:]))),
             "soup2048": sets["soup_random"]}
    # timed at the main path's cast size, one ray per pixel of 1024^2 (for
    # Cornell its camera rays), and at a 2^18 pool's
    timed_sets = {"cornell32": cam, "cornell32_pool": sets["cornell_pool"],
                  "soup2048": sets["soup_random"],
                  "soup2048_pool": sets["soup_pool"]}
    reports, times = [], {}
    t_min = brute_ab.T_MIN
    for wt in (False, True):
        for name, (tab, o, d, t_max) in cases.items():
            rep = compare_kernels(tab, o, d, t_max, t_min, wt)
            rep["case"] = name
            reports.append(rep)
            print("kernel-vs-twin", json.dumps(rep))
        rep = dict(brute_ab.adversarial_diffs(device, wt), case="adversarial",
                   watertight=wt)
        rep["ok"] = not any(rep[f] for f in brute_ab.FIELDS + ("occ",))
        # bit differences: the errors are 0 where the phase passes
        rep.update(closest_max_abs_err=0.0, any_max_abs_err=0.0)
        reports.append(rep)
        print("kernel-vs-twin", json.dumps(rep))
        for name, (tab, o, d, t_max) in timed_sets.items():
            scene_like = brute_ab.Soup(tab)
            tag = f"{name}_{'watertight' if wt else 'moeller'}"

            def closest():
                return brute.brute_closest(scene_like, o, d, t_min, wt)

            def any_():
                return brute.brute_any(scene_like, o, d, t_max, t_min, wt)

            times[tag] = dict(
                closest_ms=timed(closest, 10),
                closest_kernel_ms=kernel_ms(closest, 10, "closest_kernel"),
                closest_twin_ms=timed(lambda: brute.brute_closest_torch(
                    tab, o, d, t_min, wt), 2),
                any_ms=timed(any_, 10),
                any_kernel_ms=kernel_ms(any_, 10, "any_kernel"),
                any_twin_ms=timed(lambda: brute.brute_any_torch(
                    tab, o, d, t_max, t_min, wt), 2))
            print("timing", tag, f"rays={o.shape[0]} tris={tab.shape[0]}",
                  json.dumps(times[tag]))
    bad = [r for r in reports if not r["ok"]
           or any(r.get("bits", {}).values())]
    if bad:
        raise SystemExit(f"kernel/twin mismatch: {bad}")
    return reports, times


def _walk_ops(counts, local_ray=False, tested="warp_voted"):
    """Operations of a per-ray warp walk besides its triangle tests, from
    its census (`worklist_ab.ray_census`, or `any_census` with tested
    "visited"): one admission slab test a ray of each (item, warp) pair
    the census counts under `tested` (closest: past the warp vote;
    any-hit: some ray of the warp not yet done) and the fine cull (32
    slab tests a ray) of each admitted pair; with local_ray also the move
    to instance space (FLOPS_LOCAL_RAY) of each (ray, item) whose fine
    cull entered a child."""
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    ops = FLOPS_SLAB * wl.GL * (counts[tested]
                                + wl.SUPER * counts["admitted"])
    return ops + (FLOPS_LOCAL_RAY * counts["entered"] if local_ray else 0)


def _items_census(tables, od, tm):
    """Items per block of one cast: mean and max over blocks."""
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    items = wl.phases(tables, od, tm)
    if items is None:
        return dict(items=0, items_per_block=0.0, items_per_block_max=0)
    counts = (items.seg[1:] - items.seg[:-1]).float()
    return dict(items=int(items.seg[-1]), items_per_block=float(counts.mean()),
                items_per_block_max=int(counts.max()))


def phase_worklist_kernels(device):
    """Work-list kernels vs twins on sphere_grid(12, 12); kernel and twin
    times at the camera rays; the item and cluster census."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.presets import sphere_grid
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene
    from directcomputeraytracing_tpu_torch.tools import common, worklist_ab
    from directcomputeraytracing_tpu_torch.tools.common import timed

    rng = np.random.default_rng(20261017)
    scene, cam = sphere_grid(*GRID)
    t0 = time.perf_counter()
    arrays, _ = flatten_scene(scene, device)
    flatten_s = time.perf_counter() - t0
    tables = wl.scene_tables(arrays)
    print("worklist scene", json.dumps(dict(
        world_tris=arrays.world_tris.shape[0],
        clusters=arrays.cluster_bbox.shape[0], supers=tables.sbox.shape[0],
        hypers=None if tables.hbox is None else tables.hbox.shape[0],
        flatten_s=flatten_s)))
    if tables.hbox is None:
        raise SystemExit("sphere_grid(12, 12) should use the hyper level")

    sets = common.grid_ray_sets(rng, tables, to_device(cam, device), device,
                                names=("camera", "random", "shadow"))
    t_min = 1e-4
    reports, census, walk, any_walk = [], {}, {}, {}
    cull = dict(diff=0, err=0.0, refine_diff=0, refine_err=0.0)
    for name, (o, d, t_max) in sets.items():
        if name != "camera":
            # the random and shadow casts against their twins on ray
            # blocks spread over the set (the camera set's census sets the
            # sweeps' bounds, so it stays whole; the cull and the refine
            # are held to their twins on the whole shadow and sorted
            # random sets below)
            idx = common.spread_blocks(o.shape[0], WL_TWIN_BLOCKS, device,
                                       wl.RB)
            o, d, t_max = o[idx], d[idx], t_max[idx]
        od, tm_closest, _ = wl.prep_rays(o, d)
        _, tm_any, _ = wl.prep_rays(o, d, t_max)
        texp = wl.scene_exit(tables, od)
        items_c = wl.phases(tables, od, tm_closest)
        od_w, tm_w, _ = wl.prep_rays_torch(o, d)
        texp_w = wl.scene_exit(tables, od_w)
        items_w = wl.phases(tables, od_w, tm_w, plain=True)
        od_wa, tm_wa, _ = wl.prep_rays_torch(o, d, t_max)
        items_wa = wl.phases(tables, od_wa, tm_wa, plain=True)
        items_equal = all(torch.equal(a, b) for a, b in zip(items_c, items_w))
        census[name] = dict(closest=_items_census(tables, od, tm_closest),
                            any=_items_census(tables, od, tm_any))
        for tm in (tm_closest, tm_any):
            tlo = wl.cull_boxes(tables.hbox, od, tm)
            tlo_w = wl.cull_boxes_torch(tables.hbox, od, tm)
            blk, hyp, _ = wl.compact_pairs(tlo_w)
            ref = wl.refine(tables.hsup, blk, hyp, od, tm)
            ref_w = wl.refine_torch(tables.hsup, blk, hyp, od, tm)
            cull["diff"] += _bit_diff(tlo, tlo_w)
            cull["err"] = max(cull["err"], float((tlo - tlo_w).abs().max()))
            cull["refine_diff"] += _bit_diff(ref, ref_w)
            cull["refine_err"] = max(cull["refine_err"],
                                     float((ref - ref_w).abs().max()))
        for wt in _tests(name):
            t0 = time.perf_counter()
            k = wl.worklist_closest(arrays, o, d, t_min, wt)
            occ_k = wl.worklist_any(arrays, o, d, t_max, t_min, wt)
            state_k = wl.sweep_closest(tables, items_c, od, texp, t_min, wt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            # the plain cast (worklist_closest_torch's steps: plain prep,
            # plain phases), its sweep walked by the census (the twin's
            # own steps)
            state_w, walk[name, wt] = worklist_ab.ray_census(
                tables, items_w, od_w, texp_w, t_min, wt)
            w = wl.decode_closest(state_w, texp_w, items_w.block_any,
                                  o.shape[0])
            # the plain any-hit cast (worklist_any_torch's steps), its
            # sweep walked by the census
            occ_w, any_walk[name, wt] = worklist_ab.any_census(
                tables, items_wa, od_wa, tm_wa, t_min, wt)
            occ_w = (occ_w & items_wa.block_any.repeat_interleave(
                wl.RB))[:o.shape[0]]
            torch.cuda.synchronize()
            rep = _mismatches(k, w, occ_k, occ_w, o, t_max, t_min, TIE_WL)
            rep["iters_diff"] = int((k[6] != w[6]).sum())
            rep["items_equal"] = items_equal
            rep["vs_twin"] = common.sweep_diffs(state_k, state_w)
            rep["any_vs_twin"] = int((occ_k != occ_w).sum())
            rep["ok"] = (rep["ok"] and rep["iters_diff"] == 0 and items_equal
                         and not any(rep["vs_twin"].values())
                         and rep["any_vs_twin"] == 0)
            rep.update(case=name, watertight=wt, kernel_casts_s=t1 - t0,
                       twin_casts_s=time.perf_counter() - t1)
            print("ray-census", json.dumps(dict(
                case=name, watertight=wt, rays=o.shape[0],
                **worklist_ab.ray_census_summary(walk[name, wt],
                                                 od.shape[1]),
                iters_per_ray=float(state_k[7].float().mean()))))
            print("any-census", json.dumps(dict(
                case=name, watertight=wt, rays=o.shape[0],
                **worklist_ab.any_census_summary(any_walk[name, wt],
                                                 od_wa.shape[1]),
                occluded=float(occ_w.float().mean()))))
            if not wt:
                hit = torch.isfinite(k[0])
                census[name].update(
                    iters_per_ray=float(k[6].float().mean()),
                    iters_per_hit=float(k[6][hit].float().mean()),
                    hit_fraction=float(hit.float().mean()))
            reports.append(rep)
            print("worklist-kernel-vs-twin", json.dumps(rep))
    print("worklist census", json.dumps(census))
    print("worklist cull-and-refine-vs-twin", json.dumps(cull))

    # kernel and twin times at the main path's first cast: 1M camera rays
    o, d, t_max = sets["camera"]
    od, tm, _ = wl.prep_rays(o, d)
    _, tm_any, _ = wl.prep_rays(o, d, t_max)
    texp = wl.scene_exit(tables, od)
    boxes = tables.hbox
    blk, hyp, _ = wl.compact_pairs(wl.cull_boxes(boxes, od, tm))
    items = wl.phases(tables, od, tm)
    items_any = wl.phases(tables, od, tm_any)
    times = dict(
        cull_ms=timed(lambda: wl.cull_boxes(boxes, od, tm), 20),
        cull_twin_ms=timed(lambda: wl.cull_boxes_torch(boxes, od, tm), 2),
        closest_ms=timed(lambda: wl.sweep_closest(
            tables, items, od, texp, t_min, False), 10),
        closest_twin_ms=timed(lambda: wl.sweep_closest_torch(
            tables, items, od, texp, t_min, False), 1),
        any_ms=timed(lambda: wl.sweep_any(
            tables, items_any, od, tm_any, t_min, False), 10),
        any_twin_ms=timed(lambda: wl.sweep_any_torch(
            tables, items_any, od, tm_any, t_min, False), 1),
        closest_cast_ms=timed(lambda: wl.worklist_closest(
            arrays, o, d, t_min), 5),
        any_cast_ms=timed(lambda: wl.worklist_any(
            arrays, o, d, t_max, t_min), 5),
        refine_items=int(blk.shape[0]),
        refine_ms=timed(lambda: wl.refine(tables.hsup, blk, hyp, od, tm),
                         20),
        refine_twin_ms=timed(lambda: wl.refine_torch(
            tables.hsup, blk, hyp, od, tm), 2))
    print("worklist timing camera", f"rays={o.shape[0]}", json.dumps(times))
    # the any-hit sweep at the shape the main path launches it on: 1M
    # shadow rays
    o_sh, d_sh, t_sh = sets["shadow"]
    od_sh, tm_sh, _ = wl.prep_rays(o_sh, d_sh, t_sh)
    items_sh = wl.phases(tables, od_sh, tm_sh)
    times["any_shadow_ms"] = timed(lambda: wl.sweep_any(
        tables, items_sh, od_sh, tm_sh, t_min, False), 10)
    print("worklist timing shadow", f"rays={o_sh.shape[0]}",
          json.dumps(dict(any_ms=times["any_shadow_ms"])))
    # rows 7-8 at the main path's other shapes, each against the twins bit
    # for bit: the shadow casts and the sorted bounce casts (the random
    # set in ray_sort_key order)
    o_r, d_r, _ = sets["random"]
    shapes = dict(shadow=(o_sh, d_sh, t_sh),
                  random_sorted=(*common.sorted_rays(tables, o_r, d_r), None))
    for name, (o_c, d_c, t_c) in shapes.items():
        od_c, tm_c, _ = wl.prep_rays(o_c, d_c, t_c)
        diffs = worklist_ab.cull_refine_diffs(tables, od_c, tm_c)
        cull["diff"] += diffs["cull_bits"]
        cull["refine_diff"] += diffs["refine_bits"]
        blk_c, hyp_c, _ = wl.compact_pairs(wl.cull_boxes(boxes, od_c, tm_c))
        print("worklist timing culls", name, f"rays={o_c.shape[0]}",
              json.dumps(dict(
                  diffs,
                  cull_ms=timed(lambda: wl.cull_boxes(boxes, od_c, tm_c),
                                20),
                  refine_ms=timed(lambda: wl.refine(
                      tables.hsup, blk_c, hyp_c, od_c, tm_c), 20),
                  cull_bound=common.cull_bound(od_c.shape[1],
                                               boxes.shape[0], wl.RB),
                  refine_bound=common.refine_bound(
                      od_c.shape[1], tables.hsup, blk_c.shape[0], wl.RB))))
    bad = [r for r in reports if not r["ok"]]
    if bad or cull["diff"] or cull["refine_diff"]:
        raise SystemExit(f"work-list kernel/twin mismatch: {bad} {cull}")
    rp = od.shape[1]
    iters = wl.sweep_closest(tables, items, od, texp, t_min, False)[7]
    table_bytes = 4 * (tables.cbox3.numel() + tables.bwtab.numel())
    n_items, n_items_any = int(items.seg[-1]), int(items_any.seg[-1])
    fine = FLOPS_SLAB * wl.RB * wl.SUPER
    tri_ops = 16 * FLOPS_BW * int(iters.long().sum())
    work = dict(
        cull=common.cull_bound(rp, boxes.shape[0], wl.RB),
        refine=common.refine_bound(rp, tables.hsup, blk.shape[0], wl.RB),
        # the warp walk's work, from the census of the camera rays
        sweep_closest=bound(_walk_ops(walk["camera", False]) + tri_ops,
                             69 * rp + 12 * n_items + table_bytes
                             + 4 * tables.abox.numel()),
        sweep_closest_block_walk=bound(fine * n_items + tri_ops,
                                        69 * rp + 12 * n_items
                                        + table_bytes),
        sweep_any=bound(_walk_ops(any_walk["camera", False],
                                   tested="visited"),
                         41 * rp + 8 * n_items_any + table_bytes
                         + 4 * tables.abox.numel()),
        sweep_any_block_walk=bound(fine * n_items_any,
                                    41 * rp + 8 * n_items_any + table_bytes))
    print("worklist bounds camera", json.dumps(work))
    return reports, times, cull, work, census


def phase_grouped_kernels(device):
    """Grouped kernels against their twins and the per-ray sweeps on the
    sphere grid; grouped vs per-ray kernel times; the census of the
    grouped walk (items per block, admitted (item, warp) pairs, fine-cull
    tests and clusters swept per ray)."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.presets import sphere_grid
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene
    from directcomputeraytracing_tpu_torch.tools import common, worklist_ab
    from directcomputeraytracing_tpu_torch.tools.common import timed

    scene, cam = sphere_grid(*GRID)
    arrays, _ = flatten_scene(scene, device)
    tables = wl.scene_tables(arrays)
    # the five sets, from seed 20261018
    sets = worklist_ab.ray_sets(tables, to_device(cam, device), device)
    t_min = 1e-4
    reports, timing, errs, counts = [], {}, dict(closest=0.0, any=0.0), {}

    def prepared(o, d, t_max):
        od, tm_c, _ = wl.prep_rays(o, d)
        _, tm_a, _ = wl.prep_rays(o, d, t_max)
        return (od, tm_c, tm_a, wl.scene_exit(tables, od),
                wl.phases(tables, od, tm_c), wl.phases(tables, od, tm_a))

    for name, (o, d, t_max) in sets.items():
        full = prepared(o, d, t_max)
        # the twins on ray blocks spread over the 1M-ray sets, on the
        # whole pool-sized set (its census sets the pool's bounds)
        idx = slice(None) if name == "pool_sorted" else common.spread_blocks(
            o.shape[0], GROUPED_TWIN_BLOCKS, device, wl.RB)
        sub = prepared(o[idx], d[idx], t_max[idx])
        n_twin = o[idx].shape[0]
        for wt in _tests(name):
            od, tm_c, tm_a, texp, it_c, it_a = full
            g = wl.sweep_closest_grouped(tables, it_c, od, texp, t_min, wt)
            p = wl.sweep_closest(tables, it_c, od, texp, t_min, wt)
            ga = wl.sweep_any_grouped(tables, it_a, od, tm_a, t_min, wt)
            pa = wl.sweep_any(tables, it_a, od, tm_a, t_min, wt)
            od_s, _, tm_as, texp_s, it_cs, it_as = sub
            t0 = time.perf_counter()
            gs = wl.sweep_closest_grouped(tables, it_cs, od_s, texp_s, t_min,
                                          wt)
            gas = wl.sweep_any_grouped(tables, it_as, od_s, tm_as, t_min, wt)
            # the twins' sweeps, walked by the census (their own steps)
            gw, closest_counts = worklist_ab.grouped_census(
                tables, it_cs, od_s, texp_s, t_min, wt)
            gaw, any_counts = worklist_ab.any_census(tables, it_as, od_s,
                                                     tm_as, t_min, wt)
            torch.cuda.synchronize()
            rep = dict(case=name, watertight=wt, rays=o.shape[0],
                       twin_rays=n_twin,
                       twin_s=time.perf_counter() - t0,
                       vs_twin=common.sweep_diffs(gs, gw),
                       vs_twin_occ=int((gas != gaw).sum()),
                       vs_per_ray=common.sweep_diffs(g, p, 7),
                       vs_per_ray_occ=int((ga != pa).sum()),
                       iters_per_ray=float(p[7].float().mean()),
                       grouped_iters_per_ray=float(g[7].float().mean()),
                       hits=int(torch.isfinite(wl.decode_closest(
                           g, texp, it_c.block_any, o.shape[0])[0]).sum()),
                       occluded=int(ga.sum()))
            rep["ok"] = (not any(rep["vs_twin"].values())
                         and not any(rep["vs_per_ray"].values())
                         and rep["vs_twin_occ"] == 0
                         and rep["vs_per_ray_occ"] == 0)
            errs["closest"] = max(errs["closest"], *(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(gs[1:4], gw[1:4])))
            errs["any"] = max(errs["any"], float((gas != gaw).float().max()))
            reports.append(rep)
            print("grouped-kernel", json.dumps(rep))
            counts[name, wt] = closest_counts, any_counts
            census = dict(
                case=name, watertight=wt, twin_rays=n_twin,
                items_per_block=float(it_cs.seg[-1])
                / (od_s.shape[1] // wl.RB),
                **worklist_ab.census_summary(*counts[name, wt],
                                             od_s.shape[1]),
                iters_per_ray=rep["iters_per_ray"],
                grouped_iters_per_ray=rep["grouped_iters_per_ray"])
            print("grouped-census", json.dumps(census))
        od, tm_c, tm_a, texp, it_c, it_a = full
        timing[name] = dict(
            rays=o.shape[0],
            items_per_block=float(it_c.seg[-1]) / (od.shape[1] // wl.RB),
            closest_ms=timed(lambda: wl.sweep_closest(
                tables, it_c, od, texp, t_min, False), 5),
            closest_grouped_ms=timed(lambda: wl.sweep_closest_grouped(
                tables, it_c, od, texp, t_min, False), 5),
            any_ms=timed(lambda: wl.sweep_any(
                tables, it_a, od, tm_a, t_min, False), 5),
            any_grouped_ms=timed(lambda: wl.sweep_any_grouped(
                tables, it_a, od, tm_a, t_min, False), 5))
        print("grouped-timing", name, json.dumps(timing[name]))
    # the main path's shape: a sorted pool of 2^18 rays, whose census
    # (Baldwin-Weber) covers the whole set
    od, tm_c, tm_a, texp, it_c, it_a = prepared(*sets["pool_sorted"])
    rp = od.shape[1]
    iters = wl.sweep_closest(tables, it_c, od, texp, t_min, False)[7]
    tri_ops = 16 * FLOPS_BW * int(iters.long().sum())
    table_bytes = 4 * (tables.cbox3.numel() + tables.bwtab.numel())
    fine = FLOPS_SLAB * wl.RB * wl.SUPER
    n_c, n_a = int(it_c.seg[-1]), int(it_a.seg[-1])
    c_n, a_n = counts["pool_sorted", False]
    # one admission test a ray of each (item, warp) pair the warp visits,
    # the fine cull (32 tests a ray) of each pair it admits
    slab = FLOPS_SLAB * wl.GL
    closest_ops = slab * (c_n["warp_voted"] + wl.SUPER * c_n["admitted"])
    any_ops = slab * (a_n["visited"] + wl.SUPER * a_n["admitted"])
    box_bytes = table_bytes + 4 * tables.abox.numel()
    pool = dict(
        closest_twin_ms=timed(lambda: wl.sweep_closest_grouped_torch(
            tables, it_c, od, texp, t_min, False), 1, warm=False),
        any_twin_ms=timed(lambda: wl.sweep_any_torch(
            tables, it_a, od, tm_a, t_min, False), 1, warm=False),
        closest_bound=bound(closest_ops + tri_ops,
                             69 * rp + 12 * n_c + box_bytes),
        any_bound=bound(any_ops, 41 * rp + 8 * n_a + box_bytes),
        closest_bound_block_walk=bound(fine * n_c + tri_ops,
                                        69 * rp + 12 * n_c + table_bytes),
        any_bound_block_walk=bound(fine * n_a,
                                    41 * rp + 8 * n_a + table_bytes))
    pool.update(closest_ms=timing["pool_sorted"]["closest_grouped_ms"],
                any_ms=timing["pool_sorted"]["any_grouped_ms"])
    print("grouped-pool", json.dumps(pool))
    bad = [r for r in reports if not r["ok"]]
    if bad:
        raise SystemExit(f"grouped kernel mismatch: {bad}")
    return reports, timing, errs, pool


def _inst_bounds(tables, it_c, it_a, iters, rp, watertight, walk=None,
                 any_walk=None):
    """Bounds of the instanced sweeps on one ray set (module docstring):
    `closest` and `any` from the censuses of their warp walks on the
    whole set (walk: `worklist_ab.ray_census`'s, any_walk: `any_census`'s;
    None without one), `closest_block_walk` and `any_block_walk` by the
    first designs' count; the tables are the world child boxes, the local
    slab, the per-super ids and the instance rows (and for the warp walks
    the admission boxes)."""
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    tab = tables.ctab if watertight else tables.bwtab
    table_bytes = 4 * (tables.cbox3.numel() + tab.numel()
                       + tables.inst_rows.numel() + 2 * tables.sbox.shape[0])
    abox_bytes = 4 * tables.abox.numel()
    fine = FLOPS_SLAB * tables.cbox3.shape[1]
    n_c, n_a = int(it_c.seg[-1]), int(it_a.seg[-1])
    test = FLOPS_MOELLER if watertight else FLOPS_BW
    tri_ops = 16 * test * int(iters.long().sum())
    closest_bytes = 69 * rp + 12 * n_c + table_bytes
    any_bytes = 41 * rp + 8 * n_a + table_bytes
    return dict(
        closest=walk and bound(_walk_ops(walk, local_ray=True) + tri_ops,
                                closest_bytes + abox_bytes),
        any=any_walk and bound(_walk_ops(any_walk, True, "visited"),
                                any_bytes + abox_bytes),
        closest_block_walk=bound(fine * wl.RB * n_c + tri_ops,
                                  closest_bytes),
        any_block_walk=bound(fine * wl.RB * n_a, any_bytes))


def phase_instanced_kernels(device, soup_census):
    """Instanced kernels against their twins on sphere_grid(27, 27); kernel
    times, bounds and the census on four ray sets; the kernels line's rows
    at the camera rays."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene
    from directcomputeraytracing_tpu_torch.tools import common, worklist_ab
    from directcomputeraytracing_tpu_torch.tools.common import timed

    scene, cam = _scene("inst_grid")
    t0 = time.perf_counter()
    arrays, _ = flatten_scene(scene, device)
    flatten_s = time.perf_counter() - t0
    tables = wl.scene_tables(arrays)
    print("instanced scene", json.dumps(dict(
        world_tris=_world_tris(scene), local_tris=arrays.triangles.shape[0],
        instances=arrays.inst_rows.shape[0],
        local_clusters=arrays.icl_slab.shape[0] // 16,
        supers=tables.sbox.shape[0],
        hypers=None if tables.hbox is None else tables.hbox.shape[0],
        flatten_s=flatten_s)))
    if tables.inst_rows is None or tables.hbox is None:
        raise SystemExit("sphere_grid(27, 27) should use the instanced "
                         "tables and the hyper level")

    # the A/B tool's four sets, from seed 20261019
    sets = worklist_ab.inst_ray_sets(tables, to_device(cam, device), device)
    t_min = 1e-4
    reports, census, errs = [], {}, dict(closest=0.0, any=0.0)

    def prepared(o, d, t_max, plain=False):
        od, tm_c, _ = wl.prep_rays(o, d)
        _, tm_a, _ = wl.prep_rays(o, d, t_max)
        return (od, tm_c, tm_a, wl.scene_exit(tables, od),
                wl.phases(tables, od, tm_c, plain),
                wl.phases(tables, od, tm_a, plain))

    culls = {}
    for name, (o, d, t_max) in sets.items():
        od, tm_c, tm_a, texp, it_c, it_a = prepared(o, d, t_max)
        # the hyper cull (183 hypers: chunks of 64, a partial last one)
        # and the refine (16 members) against their twins, bit for bit
        culls[name] = [worklist_ab.cull_refine_diffs(tables, od, tm)
                       for tm in (tm_c, tm_a)]
        idx = common.spread_blocks(o.shape[0], INST_TWIN_BLOCKS, device,
                                   wl.RB)
        od_s, _, tm_as, texp_s, it_cs, it_as = prepared(o[idx], d[idx],
                                                        t_max[idx])
        plain = prepared(o[idx], d[idx], t_max[idx], plain=True)
        items_equal = all(torch.equal(a, b) for it, it_w in
                          ((it_cs, plain[4]), (it_as, plain[5]))
                          for a, b in zip(it, it_w))
        nb, r = od.shape[1] // wl.RB, o.shape[0]
        counts = (it_c.seg[1:] - it_c.seg[:-1]).float()
        census[name] = dict(items_per_block=float(counts.mean()),
                            items_per_block_max=int(counts.max()),
                            any_items_per_block=int(it_a.seg[-1]) / nb)
        for wt in _tests(name):
            k = wl.sweep_closest_inst(tables, it_c, od, texp, t_min, wt)
            ks = wl.sweep_closest_inst(tables, it_cs, od_s, texp_s, t_min, wt)
            kas = wl.sweep_any_inst(tables, it_as, od_s, tm_as, t_min, wt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the twin's sweep, walked by the census (its own steps)
            w, walk = worklist_ab.ray_census(tables, it_cs, od_s, texp_s,
                                             t_min, wt)
            wa, any_walk = worklist_ab.any_census(tables, it_as, od_s, tm_as,
                                                  t_min, wt)
            torch.cuda.synchronize()
            twin_s = time.perf_counter() - t0
            hit = torch.isfinite(wl.decode_closest(k, texp, it_c.block_any,
                                                   r)[0])
            iters = k[7][:r]
            timing = dict(
                closest_ms=timed(lambda: wl.sweep_closest_inst(
                    tables, it_c, od, texp, t_min, wt), 3),
                any_ms=timed(lambda: wl.sweep_any_inst(
                    tables, it_a, od, tm_a, t_min, wt), 3))
            bounds = _inst_bounds(tables, it_c, it_a, iters, od.shape[1], wt)
            rep = dict(case=name, watertight=wt, rays=r,
                       twin_rays=int(idx.numel()), twin_s=twin_s,
                       items_equal=items_equal,
                       vs_twin=common.sweep_diffs(ks, w),
                       vs_twin_occ=int((kas != wa).sum()),
                       hits=int(hit.sum()),
                       twin_occluded=int(wa.sum()),
                       iters_per_ray=float(iters.float().mean()),
                       iters_per_hit=float(iters[hit].float().mean()),
                       **timing,
                       closest_bound_block_walk=bounds["closest_block_walk"],
                       any_bound_block_walk=bounds["any_block_walk"])
            rep["ok"] = (items_equal and not any(rep["vs_twin"].values())
                         and rep["vs_twin_occ"] == 0)
            errs["closest"] = max(errs["closest"], *(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(ks[1:4], w[1:4])))
            errs["any"] = max(errs["any"], float((kas != wa).float().max()))
            if not wt:
                census[name].update(iters_per_ray=rep["iters_per_ray"],
                                    iters_per_hit=rep["iters_per_hit"],
                                    hit_fraction=float(hit.float().mean()))
            reports.append(rep)
            print("instanced-kernel", json.dumps(rep))
            print("ray-census", json.dumps(dict(
                case=f"inst_{name}", watertight=wt,
                twin_rays=rep["twin_rays"],
                **worklist_ab.ray_census_summary(walk, od_s.shape[1]),
                iters_per_ray=float(w[7].float().mean()))))
            print("any-census", json.dumps(dict(
                case=f"inst_{name}", watertight=wt,
                twin_rays=rep["twin_rays"],
                **worklist_ab.any_census_summary(any_walk, od_s.shape[1]),
                occluded=float(wa.float().mean()))))
    print("instanced census", json.dumps(dict(
        instanced_27x27=census, soup_12x12=soup_census)))
    print("instanced cull-and-refine-vs-twin", json.dumps(culls))
    bad = [r for r in reports if not r["ok"]]
    bad_culls = [(name, c) for name, cs in culls.items() for c in cs
                 if c["cull_bits"] or c["refine_bits"]]
    if bad or bad_culls:
        raise SystemExit(f"instanced kernel/twin mismatch: {bad} "
                         f"{bad_culls}")

    # the kernels line's rows: the main path's first cast, 1M camera rays,
    # Baldwin-Weber; the twins timed once each on the whole set
    o, d, t_max = sets["camera"]
    od, tm_c, tm_a, texp, it_c, it_a = prepared(o, d, t_max)
    cam_rep = next(r for r in reports
                   if r["case"] == "camera" and not r["watertight"])
    state, walk = worklist_ab.ray_census(tables, it_c, od, texp, t_min,
                                         False)
    print("ray-census", json.dumps(dict(
        case="inst_camera_whole_set", watertight=False, rays=o.shape[0],
        **worklist_ab.ray_census_summary(walk, od.shape[1]))))
    _, any_walk = worklist_ab.any_census(tables, it_a, od, tm_a, t_min, False)
    print("any-census", json.dumps(dict(
        case="inst_camera_whole_set", watertight=False, rays=o.shape[0],
        **worklist_ab.any_census_summary(any_walk, od.shape[1]))))
    bounds = _inst_bounds(tables, it_c, it_a, state[7][:o.shape[0]],
                          od.shape[1], False, walk, any_walk)
    shadow_rep = next(r for r in reports
                      if r["case"] == "shadow" and not r["watertight"])
    row = dict(
        closest_ms=cam_rep["closest_ms"], any_ms=cam_rep["any_ms"],
        any_shadow_ms=shadow_rep["any_ms"],
        closest_bound=bounds["closest"],
        closest_bound_block_walk=cam_rep["closest_bound_block_walk"],
        closest_share=bounds["closest"][0] / cam_rep["closest_ms"],
        any_bound=bounds["any"],
        any_bound_block_walk=cam_rep["any_bound_block_walk"],
        any_share=bounds["any"][0] / cam_rep["any_ms"],
        closest_twin_ms=timed(lambda: wl.sweep_closest_inst_torch(
            tables, it_c, od, texp, t_min, False), 1, warm=False),
        any_twin_ms=timed(lambda: wl.sweep_any_inst_torch(
            tables, it_a, od, tm_a, t_min, False), 1, warm=False))
    print("instanced-row", json.dumps(row))
    return reports, errs, row


@contextmanager
def _forced_instanced():
    """Flatten scenes onto the instanced tables from FORCED_SOUP_MAX world
    triangles up, as the tests force them."""
    from directcomputeraytracing_tpu_torch.scene import scene as scene_mod

    old = scene_mod.SOUP_MAX_TRIS
    scene_mod.SOUP_MAX_TRIS = FORCED_SOUP_MAX
    try:
        yield
    finally:
        scene_mod.SOUP_MAX_TRIS = old


def _casts_diff(a, b):
    """Rays where closest hits a and b disagree beyond the gate: hit mask,
    t beyond rtol T_RTOL_INST, or triangle or instance ids apart from a
    near-tie (t within 2^-12 relative)."""
    both = a.hit & b.hit
    dt = (a.t - b.t).abs()
    ids = (a.triangle != b.triangle) | (a.instance != b.instance)
    return (a.hit != b.hit) | (both & ((dt > T_RTOL_INST * a.t.abs())
                                       | (ids & (dt > TIE_WL * a.t.abs()))))


def phase_instanced_vs_soup(device):
    """sphere_grid(12, 12) as the world soup and forced onto the instanced
    tables: the same geometry through two kernel families, which round it
    apart (world vertices against a ray moved to mesh space). With the
    watertight test a ray may disagree only where its nearer hit lies
    within EDGE_TOL (barycentric) of its triangle's edge: at a silhouette
    one cast grazes the triangle and the other passes and hits something
    behind. The Baldwin-Weber test is not watertight: a ray may disagree
    only where one cast went through the crack between two triangles,
    i.e. its nearer hit is the watertight soup cast's (t within 2^-12).
    Such rays are counted and listed; any other disagreement fails."""
    import torch

    from directcomputeraytracing_tpu_torch.accel.traverse import (
        intersect_closest,
    )
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene
    from directcomputeraytracing_tpu_torch.tools import common

    scene, cam = _scene("grid")
    soup, _ = flatten_scene(scene, device)
    with _forced_instanced():
        inst, _ = flatten_scene(_scene("grid")[0], device)
    if inst.isup_inst.shape[0] <= 1 or soup.cluster_bbox.shape[0] <= 1:
        raise SystemExit("sphere_grid(12, 12): expected soup clusters and "
                         "forced instanced tables")
    side = int(np.sqrt(N_RAYS))
    o, d = common.tiled_camera_rays(to_device(cam, device), side, side,
                                    device)
    rep = dict(rays=o.shape[0], edge_tol=EDGE_TOL)
    t_wt = None
    for wt in (True, False):
        a = intersect_closest(soup, o, d, watertight=wt)
        b = intersect_closest(inst, o, d, watertight=wt)
        both = a.hit & b.hit
        same = both & (a.triangle == b.triangle) & (a.instance == b.instance)
        bad = _casts_diff(a, b)
        near_a = a.t <= b.t
        u, v = torch.where(near_a, a.u, b.u), torch.where(near_a, a.v, b.v)
        if wt:
            t_wt = a.t
            why = torch.minimum(torch.minimum(u, v), 1.0 - u - v) <= EDGE_TOL
        else:
            why = torch.isfinite(t_wt) & (
                (torch.minimum(a.t, b.t) - t_wt).abs() <= TIE_WL * t_wt)
        rays = torch.nonzero(bad)[:, 0][:20]
        rep["watertight" if wt else "baldwin_weber"] = dict(
            hits=int(a.hit.sum()), hit_diff=int((a.hit != b.hit).sum()),
            id_diff=int((both & ~same).sum()), outside_gate=int(bad.sum()),
            explained=int((bad & why).sum()),
            unexplained=int((bad & ~why).sum()),
            max_rel_dt_same_triangle=float(torch.where(
                same, (a.t - b.t).abs() / a.t.abs(), 0.0).max()),
            back_agree=float((a.backface == b.backface)[same].float()
                             .mean()),
            outside=[dict(ray=int(i), t=[float(a.t[i]), float(b.t[i])],
                          tri=[int(a.triangle[i]), int(b.triangle[i])],
                          inst=[int(a.instance[i]), int(b.instance[i])],
                          uv=[float(u[i]), float(v[i])]) for i in rays])
    imgs = {name: _renderer(name, INST_VS_SOUP, device)[0].render(
        spp=INST_VS_SOUP["spp"]) for name in ("grid", "grid_forced")}
    x, y = imgs["grid"], imgs["grid_forced"]
    rep.update(render=_image_diff(x, y), mean_soup=float(x.mean()),
               mean_instanced=float(y.mean()))
    print("instanced-vs-soup", json.dumps(rep))
    if (rep["watertight"]["unexplained"] or rep["baldwin_weber"]["unexplained"]
            or not _image_ok(rep["render"]) or not y.mean() > 0):
        raise SystemExit(f"instanced casts differ from the soup's: {rep}")
    return rep


def phase_clustered_kernels(device):
    """Clustered kernels against their twins and the dense sweep on
    sphere_grid(12, 12); CUDA-event times, bounds and the census of the
    warp walks; the kernels line's rows at the camera rays."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.accel import clustered as cl
    from directcomputeraytracing_tpu_torch.tools import clustered_ab as cab
    from directcomputeraytracing_tpu_torch.tools import common
    from directcomputeraytracing_tpu_torch.tools.brute_ab import closest_diffs
    from directcomputeraytracing_tpu_torch.tools.common import timed

    arrays, tables, sets = cab.grid_sets(device)
    print("clustered scene", json.dumps(dict(
        world_tris=arrays.world_tris.shape[0],
        clusters=tables.cbox.shape[0], groups=tables.n_groups,
        reach=tables.reach)))
    t_min = cab.T_MIN
    reports, census, errs = [], {}, dict(cull=0.0, closest=0.0, any=0.0)
    rows = {}
    for name, (o, d, t_max) in sets.items():
        r = o.shape[0]
        cmask, gmask = cl.cull_masks(tables, o, d)
        cm_w, gm_w = cl.cull_masks_torch(tables, o, d)
        cull_diff = int((cmask != cm_w).sum() + (gmask != gm_w).sum())
        errs["cull"] = max(errs["cull"], float(cull_diff > 0))
        idx = common.spread_blocks(r, CLUSTER_TWIN_BLOCKS, device,
                                   cl.RAY_BLOCK)
        blocks = idx[::cl.RAY_BLOCK] // cl.RAY_BLOCK
        cm_s, gm_s = cmask[blocks].contiguous(), gmask[blocks].contiguous()
        o_s, d_s, tm_s = o[idx], d[idx], t_max[idx]
        exact = cl.exact_masks_torch(arrays, o_s, d_s)[0]
        cull_ms = timed(lambda: cl.cull_masks(tables, o, d), 5)
        cull_kernel_ms = common.kernel_ms(lambda: cl.cull_masks(
            tables, o, d), 5, "cull_kernel")
        for wt in _tests(name):
            k = cl.sweep_closest(tables, cmask, gmask, o, d, t_min, wt)
            ka = cl.sweep_any(tables, cmask, gmask, o, d, t_max, t_min, wt)
            ks = cl.sweep_closest(tables, cm_s, gm_s, o_s, d_s, t_min, wt)
            kas = cl.sweep_any(tables, cm_s, gm_s, o_s, d_s, tm_s, t_min, wt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = cl.sweep_closest_torch(tables, cm_s, gm_s, o_s, d_s, t_min,
                                       wt)
            wa = cl.sweep_any_torch(tables, cm_s, gm_s, o_s, d_s, tm_s,
                                    t_min, wt)
            torch.cuda.synchronize()
            twin_s = time.perf_counter() - t0
            dense, dense_ms = _timed_call(lambda: brute.brute_closest(
                arrays, o, d, t_min, wt))
            dense_a, dense_any_ms = _timed_call(lambda: brute.brute_any(
                arrays, o, d, t_max, t_min, wt))
            timing = dict(
                cull_ms=cull_ms, cull_kernel_ms=cull_kernel_ms,
                closest_ms=timed(lambda: cl.sweep_closest(
                    tables, cmask, gmask, o, d, t_min, wt), 5),
                any_ms=timed(lambda: cl.sweep_any(
                    tables, cmask, gmask, o, d, t_max, t_min, wt), 5),
                dense_closest_ms=dense_ms, dense_any_ms=dense_any_ms)
            cen = cab.admission_census(tables, cmask, gmask, o, d, ka)
            census[f"{name}_{'watertight' if wt else 'moeller'}"] = dict(
                cen, exact_clusters_per_block=float(
                    exact.float().sum(1).mean()),
                spread_clusters_per_block=float(cm_s.float().sum(1).mean()),
                reaching=float(cl.reach_mask(tables, o, d).float().mean()))
            bnd = cab.cast_bounds(tables, cmask, gmask, o, d, ka, cen)
            rep = dict(case=name, watertight=wt, rays=r,
                       twin_rays=int(idx.numel()), twin_s=twin_s,
                       cull_diff=cull_diff,
                       cull_sound=bool((cm_s >= exact).all()),
                       vs_twin=closest_diffs(ks, w),
                       vs_twin_occ=common.bit_diff(kas, wa),
                       vs_dense=cab.graze_diffs(tables, cmask, o, d, k, dense,
                                                ka, dense_a, t_max, t_min,
                                                wt),
                       group_misses=cen["group_misses"],
                       hits=int(torch.isfinite(k[0]).sum()),
                       occluded=int(ka.sum()), **timing, bounds=bnd,
                       closest_share=bnd["closest"][0] / timing["closest_ms"],
                       any_share=bnd["any"][0] / timing["any_ms"])
            rep["ok"] = (cull_diff == 0 and rep["cull_sound"]
                         and not any(rep["vs_twin"].values())
                         and rep["vs_twin_occ"] == 0
                         and rep["group_misses"] == 0
                         and cab.graze_ok(rep["vs_dense"]))
            errs["closest"] = max(errs["closest"], *(
                float(torch.where(torch.isfinite(a), a - b, 0.0).abs().max())
                for a, b in zip(ks[:3], w[:3])))
            errs["any"] = max(errs["any"], float((kas != wa).float().max()))
            if name == "camera" and not wt:
                rows = dict(
                    cull_ms=cull_ms, cull_kernel_ms=cull_kernel_ms,
                    closest_ms=timing["closest_ms"],
                    any_ms=timing["any_ms"], bounds=bnd,
                    cull_twin_ms=timed(lambda: cl.cull_masks_torch(
                        tables, o, d), 1, warm=False),
                    closest_twin_ms=timed(lambda: cl.sweep_closest_torch(
                        tables, cmask, gmask, o, d, t_min), 1, warm=False),
                    any_twin_ms=timed(lambda: cl.sweep_any_torch(
                        tables, cmask, gmask, o, d, t_max, t_min), 1,
                        warm=False))
            reports.append(rep)
            print("clustered-kernel", json.dumps(rep))
    print("clustered census", json.dumps(census))
    print("clustered-row", json.dumps(rows))
    bad = [r for r in reports if not r["ok"]]
    if bad:
        raise SystemExit(f"clustered kernel mismatch: {bad}")
    return reports, errs, rows, census


def phase_pair_kernels(device):
    """Pair kernels against their twins and the pair casts against the
    work list on sphere_grid(12, 12); CUDA-event times of every step of a
    cast beside the work list's and the grouped sweep's; bounds, census
    and peak memory; the kernels line's rows at the pool-sorted set."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import pairsweep as ps
    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene
    from directcomputeraytracing_tpu_torch.tools import common
    from directcomputeraytracing_tpu_torch.tools import pair_ab
    from directcomputeraytracing_tpu_torch.tools.common import kernel_ms, timed

    rng = np.random.default_rng(pair_ab.SEED)
    arrays, _ = flatten_scene(_scene("grid")[0], device)
    tables = wl.scene_tables(arrays)

    sets = common.grid_ray_sets(
        rng, tables, None, device,
        names=("shadow", "random_sorted", "pool_sorted"))
    t_min = 1e-4
    reports, errs, rows = [], dict(emit=0.0, closest=0.0, any=0.0), {}
    for name, (o, d, t_max) in sets.items():
        r = o.shape[0]
        od, tm_c, _ = wl.prep_rays(o, d)
        _, tm_a, _ = wl.prep_rays(o, d, t_max)
        texp = wl.scene_exit(tables, od)
        cap_c = wl._window(wl._float_bits(texp) | wl._LOWM)
        idx = common.spread_blocks(r, PAIR_TWIN_BLOCKS, device, wl.RB)
        for kind, tm, cap in (("closest", tm_c, cap_c), ("any", tm_a, tm_a)):
            items = wl.phases(tables, od, tm)
            grid = ps.emit_pairs(tables, items, od, cap, t_min)
            twin, emit_twin_ms = _timed_call(lambda: ps.emit_pairs_torch(
                tables, items, od, cap, t_min))
            emit_diff = int((grid != twin).sum())
            del twin
            emit_ms = timed(lambda: ps.emit_pairs(tables, items, od, cap,
                                                   t_min), 3)
            emit_kernel_ms = kernel_ms(lambda: ps.emit_pairs(
                tables, items, od, cap, t_min), 3, "emit_kernel")
            it, lane = torch.nonzero(grid, as_tuple=True)
            nonzero_ms = timed(lambda: torch.nonzero(grid, as_tuple=True),
                                3)
            cells = grid.numel()
            del grid
            pairs = ps.pair_list(tables, items, it, lane)
            list_ms = timed(lambda: ps.pair_list(tables, items, it, lane),
                             3)
            sub = pair_ab.pair_subset(tables, items, it, lane, idx)
            del it, lane
            p = pairs.ray.shape[0]
            counts = pairs.chunk_count[pairs.chunk_count > 0].float()
            for wt in (False, True):
                # the closest cast's census once, with the Baldwin-Weber test
                if kind == "any" or not wt:
                    census = pair_ab.pair_census(
                        tables, items, pairs, od, cap, t_min, r,
                        tm if kind == "any" else None, wt,
                        texp if kind == "closest" else None)
                    print("pair-census", json.dumps(dict(
                        set=name, kind=kind, watertight=wt, **census)))
                if kind == "closest":
                    sweep = ps.pair_sweep_closest
                    twin_fn = ps.pair_sweep_closest_torch
                    cast = ps.pair_closest
                    wl_cast = wl.worklist_closest
                    args = (texp,)
                else:
                    sweep, twin_fn = ps.pair_sweep_any, ps.pair_sweep_any_torch
                    cast, wl_cast, args = ps.pair_any, wl.worklist_any, (tm,)
                out = sweep(tables, pairs, od, *args, t_min, wt)
                sweep_ms = timed(lambda: sweep(tables, pairs, od, *args,
                                                t_min, wt), 3)
                sweep_kernel_ms = kernel_ms(lambda: sweep(
                    tables, pairs, od, *args, t_min, wt), 3,
                    f"pair_{kind}_kernel")
                ks = sweep(tables, sub, od, *args, t_min, wt)
                ws = twin_fn(tables, sub, od, *args, t_min, wt)
                if kind == "closest":
                    vs_twin = common.sweep_diffs(ks, ws)
                    model = pair_ab.closest_replay(tables, sub, od, texp,
                                                   t_min, wt)
                    vs_twin.update({f"model_{k}": v for k, v in
                                    common.sweep_diffs(ks, model).items()})
                    errs["closest"] = max(errs["closest"], *(
                        float((a.float() - b.float()).abs().max())
                        for a, b in zip(ks[1:4], ws[1:4])))
                    reduce_ms = timed(lambda: ps.reduce_closest(
                        ps._initial_state(texp), out, pairs, texp), 3)
                    iters_p = out[7]
                else:
                    vs_twin = dict(occ=int((ks != ws).sum()))
                    errs["any"] = max(errs["any"],
                                      float((ks != ws).float().max()))
                    hits = torch.zeros(od.shape[1], dtype=torch.int32,
                                       device=device)
                    reduce_ms = timed(lambda: hits.index_add_(
                        0, pairs.ray.long(), out.to(torch.int32)), 3)
                    iters_p = None
                del out
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                if kind == "closest":
                    pc = cast(arrays, o, d, t_min, wt)
                    peak = torch.cuda.max_memory_allocated() - base
                    wc = wl_cast(arrays, o, d, t_min, wt)
                    cast_ms = timed(lambda: cast(arrays, o, d, t_min, wt), 3)
                    wl_ms = timed(lambda: wl_cast(arrays, o, d, t_min, wt),
                                   3)
                    wlg_ms = timed(lambda: wl_cast(
                        arrays, o, d, t_min, wt, grouped=True), 3)
                    vs_wl = {f: int((a != b).sum()) for f, a, b in zip(
                        ("t", "u", "v", "tri", "inst", "back"), pc, wc)}
                    extra = dict(
                        iters_ge_wl=bool((pc[6] >= wc[6]).all()),
                        hits=int(torch.isfinite(pc[0]).sum()),
                        iters_per_ray=float(pc[6].float().mean()),
                        wl_iters_per_ray=float(wc[6].float().mean()),
                        swept_per_pair=float(iters_p.float().mean()))
                else:
                    pc = cast(arrays, o, d, t_max, t_min, wt)
                    peak = torch.cuda.max_memory_allocated() - base
                    wc = wl_cast(arrays, o, d, t_max, t_min, wt)
                    cast_ms = timed(lambda: cast(arrays, o, d, t_max, t_min,
                                                  wt), 3)
                    wl_ms = timed(lambda: wl_cast(arrays, o, d, t_max, t_min,
                                                   wt), 3)
                    wlg_ms = timed(lambda: wl_cast(
                        arrays, o, d, t_max, t_min, wt, grouped=True), 3)
                    vs_wl = dict(occ=int((pc != wc).sum()))
                    extra = dict(occluded=int(pc.sum()))
                peak /= 2**30
                eb, sb = pair_ab.pair_bounds(tables, items, pairs,
                                             od.shape[1], wt, kind, iters_p,
                                             census)
                rep = dict(
                    case=name, kind=kind, watertight=wt, rays=r,
                    items=items.sup.shape[0], cells=cells, pairs=p,
                    pairs_per_ray=p / r,
                    pairs_per_chunk=float(counts.mean()),
                    chunks=int(counts.numel()),
                    twin_pairs=sub.ray.shape[0], emit_diff=emit_diff,
                    vs_twin=vs_twin, vs_worklist=vs_wl, **extra,
                    emit_ms=emit_ms, emit_kernel_ms=emit_kernel_ms,
                    emit_twin_ms=emit_twin_ms,
                    nonzero_ms=nonzero_ms, list_ms=list_ms,
                    sweep_ms=sweep_ms, sweep_kernel_ms=sweep_kernel_ms,
                    reduce_ms=reduce_ms,
                    cast_ms=cast_ms, worklist_cast_ms=wl_ms,
                    grouped_cast_ms=wlg_ms, cast_peak_gib=peak,
                    emit_bound=eb, sweep_bound=sb,
                    emit_share=eb[0] / emit_ms, sweep_share=sb[0] / sweep_ms)
                rep["ok"] = (emit_diff == 0 and not any(vs_twin.values())
                             and not any(vs_wl.values())
                             and extra.get("iters_ge_wl", True))
                reports.append(rep)
                print("pair-kernel", json.dumps(rep))
                if name == "pool_sorted" and not wt:
                    twin_out, twin_ms = _timed_call(lambda: twin_fn(
                        tables, pairs, od, *args, t_min, wt))
                    del twin_out
                    rows[kind] = dict(emit_ms=emit_ms,
                                      emit_kernel_ms=emit_kernel_ms,
                                      emit_twin_ms=emit_twin_ms,
                                      emit_bound=eb, sweep_ms=sweep_ms,
                                      sweep_kernel_ms=sweep_kernel_ms,
                                      sweep_twin_ms=twin_ms, sweep_bound=sb)
            errs["emit"] = max(errs["emit"], float(emit_diff > 0))
            del pairs, sub
    print("pair-rows", json.dumps(rows))
    bad = [r for r in reports if not r["ok"]]
    if bad:
        raise SystemExit(f"pair kernel mismatch: {bad}")
    return reports, errs, rows


def _bit_diff(a, b):
    """Elements of two float32 tensors whose bits differ."""
    import torch

    return int((a.contiguous().view(torch.int32)
                != b.contiguous().view(torch.int32)).sum())


def _injected_rays(rng, n, device):
    """n random rays with NaN and inf origin components, zero, NaN and inf
    directions, components of +-1e-31, -0.0 and negative denormals
    injected at random rays, and per-ray t_max."""
    import torch

    from directcomputeraytracing_tpu_torch.tools import common

    o, d = common.rays_inside(rng, n, -5.0, 5.0)
    o, d = o.astype(np.float32), d.astype(np.float32)
    for vals, arr in (((np.nan, np.inf, -np.inf), o),
                      ((0.0, np.nan, np.inf, 1e-31, -1e-31, -0.0, -1e-40),
                       d)):
        for v in vals:
            i = rng.integers(0, n, n // 100)
            arr[i, rng.integers(0, 3, i.size)] = v
    d[rng.integers(0, n, n // 100)] = 0.0
    t_max = rng.uniform(0.1, 30.0, n).astype(np.float32)
    return tuple(torch.as_tensor(x, device=device) for x in (o, d, t_max))


def phase_prep_kernel(device):
    """Row 6: the prep kernel against `prep_rays_torch` on the grid's
    three 1M-ray sets of 2b, the random set in `ray_sort_key` order (the
    pool's) and a 1M-ray set with injected NaN, inf, zero, +-1e-31, -0.0
    and denormal components; each without t_max (a closest cast) and with
    its per-ray t_max (a shadow cast). Bit-equal od and tm; CUDA-event
    times of the kernel and of the twin's route on the camera set; the
    bound."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.core.types import to_device
    from directcomputeraytracing_tpu_torch.scene.presets import sphere_grid
    from directcomputeraytracing_tpu_torch.scene.scene import flatten_scene
    from directcomputeraytracing_tpu_torch.tools import common
    from directcomputeraytracing_tpu_torch.tools.common import timed

    rng = np.random.default_rng(20261018)
    scene, cam = sphere_grid(*GRID)
    tables = wl.scene_tables(flatten_scene(scene, device)[0])
    sets = common.grid_ray_sets(
        rng, tables, to_device(cam, device), device,
        names=("camera", "random", "shadow", "random_sorted"))
    sets["injected"] = _injected_rays(rng, N_RAYS, device)
    reports, err = [], 0.0
    for name, (o, d, t_max) in sets.items():
        for tm_in in (None, t_max):
            od, tm, _ = wl.prep_rays(o, d, tm_in)
            od_w, tm_w, _ = wl.prep_rays_torch(o, d, tm_in)
            torch.cuda.synchronize()
            rep = dict(case=name, t_max=tm_in is not None, rays=o.shape[0],
                       od_bits_diff=_bit_diff(od, od_w),
                       tm_bits_diff=_bit_diff(tm, tm_w),
                       parked=int((od_w[0, :o.shape[0]] == wl._FAR).sum()))
            err = max(err, float((od - od_w).abs().nan_to_num().max()),
                      float((tm - tm_w).abs().max()))
            reports.append(rep)
            print("prep-kernel-vs-twin", json.dumps(rep))
    if any(r["od_bits_diff"] or r["tm_bits_diff"] for r in reports):
        raise SystemExit(f"prep kernel/twin mismatch: {reports}")
    if not next(r for r in reports if r["case"] == "injected")["parked"]:
        raise SystemExit("the injected set parked no ray")
    o, d, t_max = sets["camera"]
    rp = -(-N_RAYS // wl.RB) * wl.RB
    row = dict(
        rays=N_RAYS, max_abs_err=err,
        ms=timed(lambda: wl.prep_rays(o, d), 50),
        twin_ms=timed(lambda: wl.prep_rays_torch(o, d), 20),
        shadow_ms=timed(lambda: wl.prep_rays(o, d, t_max), 50),
        shadow_twin_ms=timed(lambda: wl.prep_rays_torch(o, d, t_max), 20),
        # 3 tests, 3 squares and 2 adds, 3 compares and 3 divisions a ray
        bound=bound(14 * N_RAYS, 24 * N_RAYS + 40 * rp))
    print("prep timing camera", json.dumps(row))
    return row


def phase_probes(device, wl_times, wl_census):
    """Rows 18 and 19 through the port's probe tools: each tool's
    measurement (its launches counted from 0), then each kernel against
    its twin: the item-list probe at the reference's four capacities (64
    blocks, 4096 slabs) and on `crafted_inputs`, bit for bit (a NaN equal
    to any NaN), beside `sweep_closest`'s cost per item on 2b's camera
    rays, with its split and resident blocks; the (2^20, 16) transpose,
    bit-equal to `.T.contiguous()` and to the twin."""
    import torch

    from directcomputeraytracing_tpu_torch.tools.common import timed
    from directcomputeraytracing_tpu_torch.tools import prof_prep as pp
    from directcomputeraytracing_tpu_torch.tools import probe_worklist as pw

    pw.item_list.launches = pp.transpose16.launches = 0
    rows = pw.measure(device)
    layout = pp.measure(device)
    launches = dict(item_list=pw.item_list.launches,
                    transpose16=pp.transpose16.launches)
    tab, o = (torch.from_numpy(x).to(device) for x in pw.make_inputs())
    diffs, err = [], 0.0
    for row in rows:
        items = torch.from_numpy(pw.make_items(row["capacity"])).to(device)
        got, want = pw.item_list(items, tab, o), pw.item_list_torch(items,
                                                                    tab, o)
        torch.cuda.synchronize()
        row["diff"] = pw.diff(got, want)
        err = max(err, float((got - want).abs().max()))
        diffs.append(row["diff"])
    c_items, c_tab, c_o = (torch.from_numpy(x).to(device)
                           for x in pw.crafted_inputs())
    c_want = pw.item_list_torch(c_items, c_tab, c_o)
    crafted = dict(diff=pw.diff(pw.item_list(c_items, c_tab, c_o), c_want),
                   nan_lanes=int(torch.isnan(c_want).sum()),
                   negative_zero_lanes=int(
                       ((c_want == 0) & torch.signbit(c_want)).sum()))
    diffs.append(crafted["diff"])
    sweep_items = wl_census["camera"]["closest"]["items"]
    sweep_ns = 1e6 * wl_times["closest_ms"] / max(sweep_items, 1)
    print("item-list probe", json.dumps(dict(
        rows=rows, crafted=crafted, resources=pw.resources(),
        sweep_closest_items=sweep_items,
        sweep_closest_ns_per_item=sweep_ns)))
    x = pp.build_table(*(torch.from_numpy(a).to(device)
                         for a in pp.make_rays()))
    t, lib, twin = pp.transpose16(x), x.T.contiguous(), pp.transpose16_torch(x)
    torch.cuda.synchronize()
    layout.update(diff_vs_library=_bit_diff(t, lib),
                  diff_vs_twin=_bit_diff(t, twin))
    print("layout probe", json.dumps(layout), json.dumps(launches))
    if any(diffs) or layout["diff_vs_library"] or layout["diff_vs_twin"]:
        raise SystemExit(f"probe kernel/twin mismatch: {rows} {crafted} "
                         f"{layout}")
    if not (launches["item_list"] and launches["transpose16"]):
        raise SystemExit(f"a probe tool launched no kernel: {launches}")
    cap = rows[-1]["capacity"]
    r = 64 * pw.RB
    row_lanes = pw.CS * pw.RB * cap     # (row, lane) pairs of the items
    clock = _max_sm_clock()
    item = dict(row=rows[-1], max_abs_err=err, launches=launches["item_list"],
                twin_ms=timed(lambda: pw.item_list_torch(items, tab, o), 1),
                bound=bound(23 * row_lanes,
                             4 * cap + 4 * tab.numel() + 8 * r),
                # 12 FMUL, 11 FADD and 1 FMNMX a (row, lane) at 128 FP32
                # lanes a clock on each of 132 SMs
                bound_issue=1e3 * ISSUE_ITEM_LIST * row_lanes
                / (SMS * FP32_LANES * clock), sm_clock_hz=clock)
    print("item-list bounds", json.dumps(dict(
        capacity=cap, bound_ms=item["bound"][0], bound_by=item["bound"][1],
        bound_ms_issue=item["bound_issue"], sm_clock_hz=clock)))
    tr = dict(layout=layout, launches=launches["transpose16"],
              bound=bound(0, 2 * 64 * pp.R))
    return item, tr


def _max_sm_clock():
    """The card's highest SM clock in Hz (nvidia-smi clocks.max.sm)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return 1e6 * float(smi.stdout.strip().splitlines()[0])


def _image_diff(a, b):
    """RMSE and diverged-pixel share of two images (the CPU-vs-card
    gate's measure)."""
    return dict(rmse=float(np.sqrt(((a - b) ** 2).mean())),
                diverged_pixels=float(
                    (np.abs(a - b).max(-1) > 1e-3 * (1.0 + np.abs(a).max(-1)))
                    .mean()),
                gate_rmse=GATE_RMSE, gate_diverged=GATE_DIVERGED_FRACTION)


def _tight_diff(img, want):
    """The largest difference of two images and the pixels beyond rtol
    1e-5, atol 1e-6 (3o's gate: the same paths, rounded alike)."""
    diff = np.abs(img - want)
    return dict(max_abs=float(diff.max()),
                beyond_tol=int((diff > 1e-6 + 1e-5 * np.abs(want)).sum()),
                rtol=1e-5, atol=1e-6)


def _dist_close(img, want):
    """3v's gate against the one-process image, with the image's mean."""
    return dict(_tight_diff(img, want), finite=bool(np.isfinite(img).all()),
                mean=float(img.mean()))


def _image_ok(diff):
    return (diff["rmse"] <= GATE_RMSE
            and diff["diverged_pixels"] <= GATE_DIVERGED_FRACTION)


def _world_tris(scene):
    return sum(scene.meshes[i.mesh].indices.shape[0] for i in scene.instances)


def _scene(name):
    """A scene of the run by name; a name ending in `_forced` is the same
    scene, which `_renderer` flattens onto the instanced tables."""
    from directcomputeraytracing_tpu_torch.scene.presets import (
        alpha_panel,
        alpha_sphere_grid,
        cornell_box,
        sphere_grid,
    )

    name = name.removesuffix("_forced")
    if name == "small_walker_grid":
        from directcomputeraytracing_tpu_torch.scene.presets import (
            walker_grid,
        )

        return walker_grid(*SMALL_WALKER_GRID)
    if name == "cornell":
        return cornell_box("area", "glossy")
    if name == "alpha_panel":
        return alpha_panel()
    if name.startswith("alpha_grid"):
        return alpha_sphere_grid(*GRID, textured=name.endswith("textured"))
    if name.startswith("small_alpha_grid"):
        return alpha_sphere_grid(*SMALL_GRID[0], **SMALL_GRID[1],
                                 textured=name.endswith("textured"))
    if name == "grid":
        return sphere_grid(*GRID)
    if name == "inst_grid":
        return sphere_grid(*INST_GRID)
    return sphere_grid(*SMALL_GRID[0], **SMALL_GRID[1])


def _renderer(name, p, device, integrator="megakernel", backend="auto",
              **cfg):
    """(Renderer of scene `name` at p's size through traversal backend
    `backend` with RenderConfig fields cfg, its world triangle count)."""
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer

    scene, cam = _scene(name)
    with _forced_instanced() if name.endswith("_forced") else nullcontext():
        r = Renderer(scene, cam, p["width"], p["height"],
                     max_bounce=p["max_bounce"], integrator=integrator,
                     device=device, traversal_backend=backend, **cfg)
    return r, _world_tris(scene)


def _launches():
    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.accel import clustered as cl
    from directcomputeraytracing_tpu_torch.accel import pairsweep as ps
    from directcomputeraytracing_tpu_torch.accel import traverse as tv
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    return dict(brute_closest=brute.brute_closest.launches,
                brute_any=brute.brute_any.launches, **wl.counters(),
                **cl.counters(), **ps.counters(),
                alpha_calls=tv.alpha_recast.calls,
                alpha_passes=tv.alpha_recast.passes)


def _reset_launches():
    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.accel import clustered as cl
    from directcomputeraytracing_tpu_torch.accel import pairsweep as ps
    from directcomputeraytracing_tpu_torch.accel import traverse as tv
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    brute.brute_closest.launches = brute.brute_any.launches = 0
    wl.reset_counters()
    cl.reset_counters()
    ps.reset_counters()
    tv.reset_counters()


def _expected_launches(arrays, n_closest, n_any, got, sweeps="",
                       backend="auto", alpha=False):
    """The counts the main path must show: every cast went through the
    path's kernels (the dense sweep for Cornell, the work list's sweeps
    `sweep_closest{sweeps}` and `sweep_any{sweeps}` for the sphere grids,
    the instanced ones on instanced tables, with "pallas_cluster" one
    cull and one clustered sweep, with "pallas_pair" the work list's cull
    and per cast with pairs one emission and one pair sweep; one ray prep
    per work-list or pair cast, empty ones included) and nothing else
    launched. With alpha (an alpha-tested scene on the opaque/masked
    split) each of the n_closest + n_any casts runs one recast loop
    (`alpha_calls`) after its opaque cast, and every recast pass
    (`alpha_passes`) is one more closest cast."""
    passes = got["alpha_passes"] if alpha else 0
    expect = _expected_cast_launches(arrays, n_closest + passes, n_any, got,
                                     sweeps, backend, passes)
    expect.update(alpha_calls=n_closest + n_any if alpha else 0,
                  alpha_passes=passes)
    return expect


def _refine_casts(arrays, n_casts, passes):
    """How many of n_casts work-list casts run the refine: those whose
    tables have the hyper level (above `worklist.HIER_MIN` supers). On the
    opaque/masked split the `passes` recast passes cast the masked side's
    tables and the other casts the opaque side's."""
    from directcomputeraytracing_tpu_torch.accel import traverse as tv
    from directcomputeraytracing_tpu_torch.accel import worklist as wl

    def hyper(scene):
        return wl.scene_tables(scene).hbox is not None

    if not (passes and tv._has_alpha_split(arrays, "worklist")):
        return n_casts if hyper(arrays) else 0
    return ((n_casts - passes) * hyper(tv._split_view(arrays, False))
            + passes * hyper(tv._split_view(arrays, True)))


def _expected_cast_launches(arrays, n_closest, n_any, got, sweeps, backend,
                            passes=0):
    """`_expected_launches` for n_closest closest and n_any any-hit casts
    of one backend, `passes` of the closest ones alpha recast passes."""
    zero = dict.fromkeys(got, 0)
    if backend == "pallas_cluster":
        return dict(zero, cluster_cull=n_closest + n_any,
                    cluster_closest=n_closest, cluster_any=n_any)
    if backend == "pallas_pair":
        # a cast with items emits; one without items or pairs sweeps
        # nothing (counted apart; `no_pair`: emitted, no pair)
        c_empty, a_empty = got["pair_closest_empty"], got["pair_any_empty"]
        return dict(zero, prep_rays=n_closest + n_any,
                    cull_boxes=n_closest + n_any,
                    refine=(_refine_casts(arrays, n_closest + n_any, passes)
                            - got["refine_skipped"]),
                    refine_skipped=got["refine_skipped"],
                    pair_emit=(n_closest - c_empty + got["pair_closest_no_pair"]
                               + n_any - a_empty + got["pair_any_no_pair"]),
                    pair_closest_empty=c_empty, pair_any_empty=a_empty,
                    pair_closest_no_pair=got["pair_closest_no_pair"],
                    pair_any_no_pair=got["pair_any_no_pair"],
                    pair_sweep_closest=n_closest - c_empty,
                    pair_sweep_any=n_any - a_empty)
    if arrays.cluster_bbox.shape[0] <= 1 and arrays.isup_inst.shape[0] <= 1:
        return dict(zero, brute_closest=n_closest, brute_any=n_any)
    if arrays.isup_inst.shape[0] > 1:
        sweeps = "_inst"
    # work list: a cast with an empty item list launches no sweep (counted
    # apart); each cast culls once; a cast on tables without the hyper
    # level runs no refine, nor does one whose hyper cull admitted nothing
    # (counted apart)
    return dict(zero, prep_rays=n_closest + n_any,
                cull_boxes=n_closest + n_any,
                refine=(_refine_casts(arrays, n_closest + n_any, passes)
                        - got["refine_skipped"]),
                refine_skipped=got["refine_skipped"],
                closest_empty=got["closest_empty"], any_empty=got["any_empty"],
                **{"sweep_closest" + sweeps: n_closest - got["closest_empty"],
                   "sweep_any" + sweeps: n_any - got["any_empty"]})


def phase_render(device, name, p=RENDER, backend="auto", warm_spp=None):
    import torch

    r, world_tris = _renderer(name, p, device, backend=backend)
    # warm-up: by default a fused pass of WARM_SPP samples, the timed
    # call's code path
    r.render(spp=warm_spp or WARM_SPP)
    r.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp=p["spp"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    expect = _expected_launches(
        r.arrays, p["spp"] * (p["max_bounce"] + 2) * r.n_chunks,
        p["spp"] * (p["max_bounce"] + 1) * r.n_chunks, launches,
        backend=backend, alpha=r.cfg.any_hit)
    post = r.postprocessed()
    stats = dict(scene=name, backend=backend, world_tris=world_tris,
                 instanced=r.arrays.isup_inst.shape[0] > 1,
                 tiled_and_sorted=r._inv is not None,
                 shape=list(img.shape), finite=bool(np.isfinite(img).all()),
                 mean=float(img.mean()), max=float(img.max()),
                 ms_per_spp=1000.0 * seconds / p["spp"],
                 total_s=seconds, chunks=r.n_chunks,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 post_mean=float(post.mean()), post_min=float(post.min()),
                 post_max=float(post.max()),
                 post_finite=bool(np.isfinite(post).all()),
                 launches=launches, expected_launches=expect,
                 **_alpha_stats(r, launches))
    print("render", json.dumps(stats))
    if not (stats["finite"] and stats["post_finite"] and stats["mean"] > 0.0
            and img.shape == (p["height"], p["width"], 3)):
        raise SystemExit(f"{name} render is not a finite, non-black image")
    if launches != expect:
        raise SystemExit(f"{name} launch counts {launches} != {expect}")
    return stats


def _alpha_stats(r, launches):
    """Recast passes per alpha-tested cast of a render (empty when the
    scene has no alpha)."""
    if not r.cfg.any_hit:
        return {}
    calls = launches["alpha_calls"]
    return dict(alpha=True, alpha_textures=r.cfg.any_hit_texture,
                recast_calls=calls, recast_passes=launches["alpha_passes"],
                recast_passes_per_cast=(launches["alpha_passes"]
                                        / max(calls, 1)),
                split=r.arrays.mclu_bbox.shape[0] > 1)


def _expected_wavefront_launches(arrays, stats, got, backend="auto",
                                 alpha=False):
    """Every pool cast of the wavefront went through the grouped sweep,
    or on instanced tables the instanced one (or found no item), or with
    "pallas_cluster" the clustered sweeps: no other sweep, one cull per
    cast."""
    return _expected_launches(arrays, sum(stats["closest_casts_per_phase"]),
                              sum(stats["any_casts_per_phase"]), got,
                              "_grouped", backend, alpha)


def phase_wavefront(device):
    """The wavefront path at 1920x1080 on the sphere grid."""
    import torch

    from directcomputeraytracing_tpu_torch.integrator import wavefront as wf
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer

    p = WAVEFRONT
    r = Renderer(*_scene("grid"), p["width"], p["height"],
                 max_bounce=p["max_bounce"], integrator="wavefront",
                 device=device)
    t0 = time.perf_counter()
    r.render(spp=WARM_SPP)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    r.reset()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp=p["spp"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    stats = dict(wf.LAST_STATS)
    expect = _expected_wavefront_launches(r.arrays, stats, launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    slabs = _slab_ab(r, img, seconds)
    backends = _pool_backends_ab(r)
    # one timed pass of the same 8 samples through a 2^20-path pool
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wf.render_samples_wavefront(r.arrays, r.luts, r.camera, r.cfg, r._px,
                                r._py, 100, pool_size=POOL_BIG,
                                spp_batch=p["spp"])
    torch.cuda.synchronize()
    big = dict(pool_size=POOL_BIG, seconds=time.perf_counter() - t0,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               stats=dict(wf.LAST_STATS))
    big["ms_per_spp"] = 1000.0 * big["seconds"] / p["spp"]
    rep = dict(scene="grid", integrator="wavefront",
               world_tris=r.arrays.world_tris.shape[0],
               shape=list(img.shape), finite=bool(np.isfinite(img).all()),
               mean=float(img.mean()), max=float(img.max()),
               ms_per_spp=1000.0 * seconds / p["spp"], total_s=seconds,
               warmup_s=warm_s, peak_mem_gib=peak, last_stats=stats,
               launches=launches, expected_launches=expect,
               slab_ab=slabs, pool_backends=backends, pool_2_20=big)
    print("wavefront", json.dumps(rep))
    if not (rep["finite"] and rep["mean"] > 0.0
            and img.shape == (p["height"], p["width"], 3)):
        raise SystemExit("wavefront render is not a finite, non-black image")
    if launches != expect:
        raise SystemExit(f"wavefront launch counts {launches} != {expect}")
    if not slabs["rmse_off_vs_on"] <= GATE_WF_RMSE:
        raise SystemExit("the wavefront without slabs differs from the "
                         "slab-marched render")
    return rep


def _slab_ab(r, img, on_s):
    """The render's pool pass (seed 0, 8 samples) without slab marching,
    then with it once more: ms/spp in the order on (the render), off, on,
    the no-slab pass's stats and its image's RMSE against the render's."""
    from dataclasses import replace

    import torch

    from directcomputeraytracing_tpu_torch.integrator import wavefront as wf

    p = WAVEFRONT
    out = dict(order=["on", "off", "on"],
               ms_per_spp=[1000.0 * on_s / p["spp"]])
    for march in (0.0, None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, val = wf.render_samples_wavefront(
            r.arrays, r.luts, r.camera, replace(r.cfg, slab_march=march),
            r._px, r._py, 0, spp_batch=p["spp"])
        torch.cuda.synchronize()
        out["ms_per_spp"].append(1000.0 * (time.perf_counter() - t0)
                                 / p["spp"])
        if march == 0.0:
            off, out["off_stats"] = val, dict(wf.LAST_STATS)
    got = (r._raster(off) / p["spp"]).reshape(img.shape).cpu().numpy()
    out["rmse_off_vs_on"] = float(np.sqrt(((got - img) ** 2).mean()))
    return out


def _pool_backends_ab(r):
    """A pool pass of the render's (seed 0, default slabs) of AB_SPP
    samples through the three pool backends in turns, "" (the default:
    the grouped sweep, "pallas_wlg"), "pallas_wl" and "pallas_pair",
    after a one-sample warm-up pass of the last two: ms/spp in the order
    grouped, wl, pair, pair, wl, grouped."""
    from dataclasses import replace

    import torch

    from directcomputeraytracing_tpu_torch.integrator import wavefront as wf

    names = {"": "pallas_wlg", "pallas_wl": "pallas_wl",
             "pallas_pair": "pallas_pair"}
    order = list(names) + list(names)[::-1]
    out = dict(order=[names[b] for b in order],
               ms_per_spp={n: [] for n in names.values()})
    for spp, b in [(1, "pallas_wl"), (1, "pallas_pair")] + [
            (AB_SPP, b) for b in order]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wf.render_samples_wavefront(
            r.arrays, r.luts, r.camera, replace(r.cfg, pool_backend=b),
            r._px, r._py, 0, spp_batch=spp)
        torch.cuda.synchronize()
        if spp == AB_SPP:
            out["ms_per_spp"][names[b]].append(
                1000.0 * (time.perf_counter() - t0) / spp)
    return out


def phase_wavefront_vs_megakernel(device):
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer

    p = MK_VS_WF
    imgs = {}
    for integ in ("megakernel", "wavefront"):
        r = Renderer(*_scene("grid"), p["width"], p["height"],
                     max_bounce=p["max_bounce"], integrator=integ,
                     device=device)
        imgs[integ] = r.render(spp=p["spp"])
    a, b = imgs["megakernel"], imgs["wavefront"]
    rep = dict(scene="grid", rmse=float(np.sqrt(((a - b) ** 2).mean())),
               max_abs=float(np.abs(a - b).max()), gate_rmse=GATE_WF_RMSE,
               mean_megakernel=float(a.mean()), mean_wavefront=float(b.mean()))
    print("wavefront-vs-megakernel", json.dumps(rep))
    if not (rep["rmse"] <= GATE_WF_RMSE and b.mean() > 0):
        raise SystemExit("wavefront differs from the megakernel on the card")
    return rep


def phase_wavefront_pass(device, name, p, backend="auto"):
    """One timed pool pass of the wavefront at p's size after a warm-up
    pass, default pool: on the instanced sphere grid with its slab
    marching (3f), on the soup grid through "pallas_cluster", which
    marches no slabs (3h), or on the alpha-tested grid (3l)."""
    import torch

    from directcomputeraytracing_tpu_torch.integrator import wavefront as wf

    r, world_tris = _renderer(name, p, device, "wavefront", backend)
    t0 = time.perf_counter()
    r.render(spp=min(WARM_SPP, p["spp"]))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    r.reset()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp=p["spp"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    stats = dict(wf.LAST_STATS)
    expect = _expected_wavefront_launches(r.arrays, stats, launches,
                                          backend, r.cfg.any_hit)
    rep = dict(scene=name, integrator="wavefront", backend=backend,
               world_tris=world_tris,
               instanced=r.arrays.isup_inst.shape[0] > 1,
               shape=list(img.shape), finite=bool(np.isfinite(img).all()),
               mean=float(img.mean()), max=float(img.max()),
               ms_per_spp=1000.0 * seconds / p["spp"], total_s=seconds,
               warmup_s=warm_s,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               last_stats=stats, launches=launches, expected_launches=expect,
               **_alpha_stats(r, launches))
    print(f"wavefront-{name}-{backend}", json.dumps(rep))
    if not (rep["finite"] and rep["mean"] > 0.0
            and img.shape == (p["height"], p["width"], 3)):
        raise SystemExit(f"{name} wavefront render is not a finite, "
                         "non-black image")
    if launches != expect:
        raise SystemExit(f"{name} wavefront launch counts {launches} != "
                         f"{expect}")
    if backend == "pallas_cluster" and (
            stats["slab_depth"] is not None
            or any(stats["closest_casts_per_phase"][1:])
            or any(stats["any_casts_per_phase"][1:])):
        raise SystemExit(f"{name}: pool casts through {backend} marched "
                         f"slabs: {stats}")
    return rep


def phase_pair_wavefront(device):
    """The wavefront through pool_backend="pallas_pair" on the sphere grid
    at 1920x1080: one timed pool pass after a warm-up, default slabs;
    every pool cast, slab phases included, is a pair cast; the image
    against the grouped sweep's pass at the same seed, which is timed
    beside it."""
    from dataclasses import replace

    import torch

    from directcomputeraytracing_tpu_torch.integrator import wavefront as wf

    p = PAIR_WAVEFRONT
    r, world_tris = _renderer("grid", p, device, "wavefront",
                              pool_backend="pallas_pair")
    t0 = time.perf_counter()
    r.render(spp=min(WARM_SPP, p["spp"]))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    r.reset()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp=p["spp"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    stats = dict(wf.LAST_STATS)
    expect = _expected_launches(r.arrays, sum(stats["closest_casts_per_phase"]),
                                sum(stats["any_casts_per_phase"]), launches,
                                backend="pallas_pair")
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    _, val = wf.render_samples_wavefront(
        r.arrays, r.luts, r.camera, replace(r.cfg, pool_backend=""), r._px,
        r._py, 0, spp_batch=p["spp"])
    torch.cuda.synchronize()
    grouped_s = time.perf_counter() - t0
    grouped = dict(wf.LAST_STATS)
    ref = (r._raster(val) / p["spp"]).reshape(img.shape).cpu().numpy()
    rep = dict(scene="grid", integrator="wavefront", backend="pallas_pair",
               world_tris=world_tris, shape=list(img.shape),
               finite=bool(np.isfinite(img).all()), mean=float(img.mean()),
               ms_per_spp=1000.0 * seconds / p["spp"], total_s=seconds,
               warmup_s=warm_s, peak_mem_gib=peak, last_stats=stats,
               launches=launches, expected_launches=expect,
               grouped_ms_per_spp=1000.0 * grouped_s / p["spp"],
               grouped_stats=grouped,
               rmse_vs_grouped=float(np.sqrt(((img - ref) ** 2).mean())))
    print("wavefront-grid-pallas_pair", json.dumps(rep))
    if not (rep["finite"] and rep["mean"] > 0.0
            and img.shape == (p["height"], p["width"], 3)):
        raise SystemExit("pair wavefront render is not a finite, non-black "
                         "image")
    if stats["pool_backend"] != "pallas_pair" or launches != expect:
        raise SystemExit(f"pair wavefront launch counts {launches} != "
                         f"{expect}")
    if not rep["rmse_vs_grouped"] <= GATE_WF_RMSE:
        raise SystemExit("the pair wavefront differs from the grouped one")
    return rep


def phase_cpu_vs_card(device, name, integrator="megakernel", backend="auto",
                      p=SMALL, **cfg):
    import torch

    from directcomputeraytracing_tpu_torch.accel.traverse import (
        _resolve_backend,
    )

    imgs = {}
    for dev in (torch.device("cpu"), device):
        r, world_tris = _renderer(name, p, dev, integrator, backend, **cfg)
        imgs[dev.type] = r.render(spp=p["spp"])
    a, b = imgs["cpu"], imgs[device.type]
    rep = dict(scene=name, integrator=integrator, backend=backend, cfg=cfg,
               world_tris=world_tris,
               instanced=r.arrays.isup_inst.shape[0] > 1,
               walker=_resolve_backend(r.arrays, backend) == "walk",
               **_image_diff(a, b), mean_cpu=float(a.mean()),
               mean_card=float(b.mean()))
    print("cpu-vs-card", json.dumps(rep))
    if not _image_ok(rep):
        raise SystemExit(f"{name}: card render differs from the CPU render")
    return rep


def _load_standin(**kw):
    """(scene, camera, host seconds to write, host seconds to load) of a
    stand-in written into a temporary directory and loaded from its XML."""
    import tempfile

    from directcomputeraytracing_tpu_torch.scene.standin import (
        write_standin_scene,
    )
    from directcomputeraytracing_tpu_torch.scene.xml_loader import (
        load_mitsuba_xml,
    )

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        xml = write_standin_scene(d, **kw)
        t1 = time.perf_counter()
        scene, settings = load_mitsuba_xml(xml)
        t2 = time.perf_counter()
    return scene, settings.camera, t1 - t0, t2 - t1


def _standin_renderer(scene, camera, p, device, integrator):
    from directcomputeraytracing_tpu_torch.film.filters import FilterParams
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer

    return Renderer(scene, camera, p["width"], p["height"],
                    max_bounce=p["max_bounce"], integrator=integrator,
                    filter_params=FilterParams(*STANDIN_FILTER),
                    device=device)


def _time_film(r):
    """Time the Renderer's filtered film (`_filter_planes`: the slots'
    gather to raster order and the convolutions), host clock between
    synchronisations; returns the list its seconds accumulate in."""
    import torch

    inner, spent = r._filter_planes, [0.0]

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(*args)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0

    r._filter_planes = timed
    return spent


def phase_standin_wavefront(device):
    """The headline stand-in at 1920x1080 through the wavefront and the
    Gaussian film (3n). Returns (report, scene, camera, image)."""
    import torch

    from directcomputeraytracing_tpu_torch.integrator import wavefront as wf

    p = STANDIN
    scene, cam, write_s, load_s = _load_standin()
    t0 = time.perf_counter()
    r = _standin_renderer(scene, cam, p, device, "wavefront")
    flatten_s = time.perf_counter() - t0
    node_s = _node_tables_s(r.arrays)
    t0 = time.perf_counter()
    r.render(spp=WARM_SPP)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    r.reset()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    film_s = _time_film(r)
    t0 = time.perf_counter()
    img = r.render(spp=p["spp"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    stats = dict(wf.LAST_STATS)
    expect = _expected_wavefront_launches(r.arrays, stats, launches, "auto",
                                          r.cfg.any_hit)
    rep = dict(scene="standin", integrator="wavefront",
               filter=list(STANDIN_FILTER), world_tris=_world_tris(scene),
               instanced=r.arrays.isup_inst.shape[0] > 1,
               tiled_and_sorted=r._inv is not None,
               host_s=dict(write=write_s, load=load_s, flatten=flatten_s,
                           node_tables=node_s),
               shape=list(img.shape), finite=bool(np.isfinite(img).all()),
               mean=float(img.mean()), max=float(img.max()),
               ms_per_spp=1000.0 * seconds / p["spp"], total_s=seconds,
               warmup_s=warm_s, film_s=film_s[0],
               film_share=film_s[0] / seconds,
               slot_buffer_bytes=(stats["slots"] + 1) * (2 + 3) * 4,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches_per_spp={k: v / p["spp"] for k, v in launches.items()},
               last_stats=stats, launches=launches, expected_launches=expect,
               **_alpha_stats(r, launches))
    print("standin-wavefront", json.dumps(rep))
    if not (rep["finite"] and rep["mean"] > 0.0
            and img.shape == (p["height"], p["width"], 3)):
        raise SystemExit("stand-in wavefront render is not a finite, "
                         "non-black image")
    if rep["world_tris"] < 200_000 or not rep["tiled_and_sorted"]:
        raise SystemExit(f"the stand-in is not the headline scene: {rep}")
    if stats["slots"] != p["width"] * p["height"] * p["spp"]:
        raise SystemExit(f"stand-in pool pass kept {stats['slots']} slots")
    if launches != expect:
        raise SystemExit(f"stand-in wavefront launch counts {launches} != "
                         f"{expect}")
    return rep, scene, cam, img


def phase_standin_megakernel(device, scene, cam, wf_img):
    """The stand-in of 3n through the megakernel (3o), against 3n's
    image."""
    import torch

    p = STANDIN
    r = _standin_renderer(scene, cam, p, device, "megakernel")
    r.render(spp=1)
    r.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp=p["spp"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    expect = _expected_launches(
        r.arrays, p["spp"] * (p["max_bounce"] + 2) * r.n_chunks,
        p["spp"] * (p["max_bounce"] + 1) * r.n_chunks, launches,
        alpha=r.cfg.any_hit)
    rep = dict(scene="standin", integrator="megakernel",
               filter=list(STANDIN_FILTER), shape=list(img.shape),
               finite=bool(np.isfinite(img).all()), mean=float(img.mean()),
               ms_per_spp=1000.0 * seconds / p["spp"], total_s=seconds,
               chunks=r.n_chunks,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               vs_wavefront=_tight_diff(img, wf_img),
               launches_per_spp={k: v / p["spp"] for k, v in launches.items()},
               launches=launches, expected_launches=expect,
               **_alpha_stats(r, launches))
    print("standin-megakernel", json.dumps(rep))
    if not (rep["finite"] and rep["mean"] > 0.0):
        raise SystemExit("stand-in megakernel render is not a finite, "
                         "non-black image")
    if launches != expect:
        raise SystemExit(f"stand-in megakernel launch counts {launches} != "
                         f"{expect}")
    if rep["vs_wavefront"]["beyond_tol"]:
        raise SystemExit("stand-in: the megakernel's image differs from the "
                         "wavefront's")
    return rep


def phase_standin_cpu_vs_card(device):
    """The small stand-in through the wavefront and the Gaussian film, the
    card against the port's CPU (4k)."""
    import torch

    p = SMALL_STANDIN_RENDER
    scene, cam, _, _ = _load_standin(**SMALL_STANDIN)
    imgs = {}
    for dev in (torch.device("cpu"), device):
        r = _standin_renderer(scene, cam, p, dev, "wavefront")
        imgs[dev.type] = r.render(spp=p["spp"])
    a, b = imgs["cpu"], imgs[device.type]
    rep = dict(scene="small_standin", integrator="wavefront",
               filter=list(STANDIN_FILTER), world_tris=_world_tris(scene),
               **_image_diff(a, b), mean_cpu=float(a.mean()),
               mean_card=float(b.mean()))
    print("cpu-vs-card", json.dumps(rep))
    if not (_image_ok(rep) and b.mean() > 0.0):
        raise SystemExit("small stand-in: card render differs from the CPU "
                         "render")
    return rep


def _card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120, check=True)
    return smi.stdout.strip().splitlines()[0]


def _synced_ms(fn):
    """(fn(), host ms between synchronisations)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1000.0 * (time.perf_counter() - t0)


def _expected_recast_launches(arrays, n_closest, n_any, got):
    """The counts of an alpha-tested pass without the opaque/masked split
    (dropped by an opacity edit): each of the n_closest + n_any casts is
    one recast loop over the whole scene, and every pass of it one closest
    cast of the path's kernels; no any-hit cast."""
    passes = got["alpha_passes"]
    expect = _expected_cast_launches(arrays, passes, 0, got, "", "auto")
    expect.update(alpha_calls=n_closest + n_any, alpha_passes=passes)
    return expect


def _edited_standin(scene, albedo=None, radiance=None, opacity=None):
    """A copy of the stand-in scene with the edits of 3s applied to the
    host scene (for a fresh Renderer to hold the edited one to)."""
    import copy

    scene = copy.deepcopy(scene)
    m = _material_index(scene)
    if albedo is not None:
        scene.materials[m].albedo = albedo
    if opacity is not None:
        scene.materials[m].opacity = opacity
    if radiance is not None:
        scene.instances[_emitter_index(scene)].radiance = radiance
    return scene


def _material_index(scene):
    return next(i for i, m in enumerate(scene.materials)
                if m.name == EDIT_MATERIAL)


def _emitter_index(scene):
    return next(i for i, inst in enumerate(scene.instances)
                if inst.is_emitter)


def _one_fixed_sample(r):
    """One fixed-seed sample of r from a clean film, its launch counts."""
    r.reset()
    _reset_launches()
    img = r.render(spp=1, seed_mode="fixed")
    return img, _launches()


def phase_standin_edits(device, scene, cam):
    """Edits and preview on the headline stand-in at 1920x1080 (3s): the
    megakernel, max_bounce 4, 3n's Gaussian film. Times EDIT_REPEATS
    edits of each kind (an albedo, the emitter's radiance, an opacity that
    turns EDIT_MATERIAL masked and drops the opaque/masked split), holds
    one fixed-seed sample after the albedo and after the opacity edits to
    a fresh Renderer of the edited scene, checks that the geometry tensors
    (and so the traversal tables) are the ones the renderer started with,
    and times `preview(spp=1, scale=PREVIEW_SCALE)`."""
    import torch

    p = dict(STANDIN, spp=1)
    mb = p["max_bounce"]
    card = _card_line()
    r = _standin_renderer(scene, cam, p, device, "megakernel")
    geometry = {f: getattr(r.arrays, f) for f in
                ("cluster_bbox", "inst_rows", "world_tris", "cluster_tris")}
    if not (r.cfg.any_hit and r.arrays.mclu_bbox.shape[0] > 1):
        raise SystemExit("the stand-in has no opaque/masked split to drop")
    m, em = _material_index(scene), _emitter_index(scene)
    albedos = [(0.2 + 0.1 * k, 0.5, 0.3) for k in range(EDIT_REPEATS)]
    radiances = [(14.0 + k, 13.0, 12.0) for k in range(EDIT_REPEATS)]
    opacities = [0.5] * EDIT_REPEATS

    edit_ms = {}
    edit_ms["albedo"] = [_synced_ms(lambda a=a: r.set_material(
        m, albedo=a))[1] for a in albedos]
    img, launches = _one_fixed_sample(r)
    n_closest, n_any = (mb + 2) * r.n_chunks, (mb + 1) * r.n_chunks
    expect = _expected_launches(r.arrays, n_closest, n_any, launches,
                                alpha=True)
    fresh = _standin_renderer(_edited_standin(scene, albedo=albedos[-1]),
                              cam, p, device, "megakernel")
    want = fresh.render(spp=1, seed_mode="fixed")
    del fresh
    albedo_check = dict(_tight_diff(img, want), mean=float(img.mean()),
                        launches=launches, expected_launches=expect)

    edit_ms["emitter_radiance"] = [_synced_ms(
        lambda x=x: r.set_emitter_radiance(em, x))[1] for x in radiances]
    edit_ms["opacity"] = [_synced_ms(lambda o=o: r.set_material(
        m, opacity=o))[1] for o in opacities]
    dropped = r.arrays.mclu_bbox.shape[0] == 1
    # untimed: the first cast of the whole table builds its work-list
    # tables (the split's sides had their own)
    _one_fixed_sample(r)
    (img, launches), sample_ms = _synced_ms(lambda: _one_fixed_sample(r))
    expect_recast = _expected_recast_launches(r.arrays, n_closest, n_any,
                                              launches)
    fresh = _standin_renderer(
        _edited_standin(scene, albedo=albedos[-1], radiance=radiances[-1],
                        opacity=opacities[-1]), cam, p, device, "megakernel")
    fresh_split = fresh.arrays.mclu_bbox.shape[0] > 1
    _one_fixed_sample(fresh)
    (want, fresh_launches), fresh_ms = _synced_ms(
        lambda: _one_fixed_sample(fresh))
    del fresh
    opacity_check = dict(**_image_diff(img, want), mean=float(img.mean()),
                         dropped_split=dropped, fresh_has_split=fresh_split,
                         sample_ms_dropped_split=sample_ms,
                         sample_ms_fresh_split=fresh_ms,
                         launches=launches, expected_launches=expect_recast,
                         recast_passes_per_cast=(
                             launches["alpha_passes"]
                             / max(launches["alpha_calls"], 1)),
                         fresh_recast_passes_per_cast=(
                             fresh_launches["alpha_passes"]
                             / max(fresh_launches["alpha_calls"], 1)))
    same_tables = {f: getattr(r.arrays, f) is t for f, t in geometry.items()}

    film = (r.film.value.clone(), r.film.weight.clone(), r.spp)
    preview_ms = []
    for _ in range(3):
        _reset_launches()
        small, ms = _synced_ms(lambda: r.preview(spp=1, scale=PREVIEW_SCALE))
        preview_ms.append(ms)
    preview_launches = _launches()
    pw, ph = p["width"] // PREVIEW_SCALE, p["height"] // PREVIEW_SCALE
    preview_expect = _expected_recast_launches(
        r.arrays, mb + 2, mb + 1, preview_launches)
    film_kept = (torch.equal(film[0], r.film.value)
                 and torch.equal(film[1], r.film.weight)
                 and film[2] == r.spp)
    rep = dict(scene="standin", card=card, width=p["width"],
               height=p["height"], max_bounce=mb, material=EDIT_MATERIAL,
               edit_ms=edit_ms,
               edit_ms_median={k: float(np.median(v))
                               for k, v in edit_ms.items()},
               albedo_vs_fresh=albedo_check, opacity_vs_fresh=opacity_check,
               same_tables=same_tables,
               preview=dict(width=pw, height=ph, ms=preview_ms,
                            ms_median=float(np.median(preview_ms)),
                            shape=list(small.shape),
                            finite=bool(np.isfinite(small).all()),
                            mean=float(small.mean()), film_kept=film_kept,
                            launches=preview_launches,
                            expected_launches=preview_expect))
    print("standin-edits", json.dumps(rep))
    for kind, med in rep["edit_ms_median"].items():
        print(f"standin-edit {kind}: median {med:.3f} ms of "
              f"{EDIT_REPEATS} ({card})")
    print(f"standin-preview {pw}x{ph}: median "
          f"{rep['preview']['ms_median']:.1f} ms ({card})")
    if albedo_check["beyond_tol"] or albedo_check["mean"] <= 0.0:
        raise SystemExit("stand-in: the albedo-edited renderer differs from "
                         "a fresh renderer of the edited scene")
    if launches != expect_recast or albedo_check["launches"] != expect:
        raise SystemExit("stand-in edits: launch counts off the path")
    if not (dropped and fresh_split and _image_ok(opacity_check)
            and opacity_check["mean"] > 0.0):
        raise SystemExit(f"stand-in: the opacity edit's render "
                         f"{opacity_check}")
    if not all(same_tables.values()):
        raise SystemExit(f"stand-in edits replaced tables: {same_tables}")
    if not (small.shape == (ph, pw, 3) and rep["preview"]["finite"]
            and small.mean() > 0.0 and film_kept
            and preview_launches == preview_expect):
        raise SystemExit(f"stand-in preview: {rep['preview']}")
    return rep


def phase_editor(device):
    """The editor on the card (3t): an EditorSession on Cornell glossy at
    EDITOR's size, served on 127.0.0.1 (port 0); GET /state, a material
    POST /edit, GET /preview?spp=1 (timed), a camera move, /state and
    /preview again."""
    import io
    import threading
    import urllib.request

    from PIL import Image

    from directcomputeraytracing_tpu_torch.scene.presets import cornell_box
    from directcomputeraytracing_tpu_torch.tools.editor import (
        EditorSession,
        serve,
    )

    card = _card_line()
    session = EditorSession(*cornell_box("area", "glossy"), device=device,
                            **EDITOR)
    mb = session.renderer.cfg.max_bounce
    started = threading.Event()
    th = threading.Thread(target=serve, args=(session, 0), daemon=True,
                          kwargs={"started": started})
    th.start()
    if not started.wait(30):
        raise SystemExit("editor: the server did not start")
    base = f"http://127.0.0.1:{started.server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=120) as f:
            return f.read()

    def post(path, body):
        req = urllib.request.Request(base + path, method="POST",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=120) as f:
            return json.loads(f.read())

    try:
        st0 = json.loads(get("/state"))
        edited = post("/edit", {"kind": "material", "index": 0,
                                "fields": {"albedo": [0.9, 0.2, 0.1]}})
        st1 = json.loads(get("/state"))
        previews = []
        for _ in range(2):
            _reset_launches()
            png, ms = _synced_ms(lambda: get("/preview?spp=1"))
            previews.append(ms)
        launches = _launches()
        img = np.asarray(Image.open(io.BytesIO(png)))
        moved = post("/camera", {"forward": 0.5, "yaw_deg": 10.0})
        st2 = json.loads(get("/state"))
        png2, ms2 = _synced_ms(lambda: get("/preview?spp=1"))
        img2 = np.asarray(Image.open(io.BytesIO(png2)))
    finally:
        started.server.shutdown()
        th.join(30)
    s = EDITOR["preview_scale"]
    shape = (EDITOR["height"] // s, EDITOR["width"] // s, 3)
    expect = _expected_launches(session.renderer.arrays, mb + 2, mb + 1,
                                launches)
    rep = dict(scene="cornell-glossy", card=card, size=[EDITOR["width"],
                                                         EDITOR["height"]],
               preview_shape=list(img.shape), preview_ms=previews,
               preview_ms_after_move=ms2, edit_ok=edited.get("ok"),
               move_ok=moved.get("ok"),
               albedo_after=st1["materials"][0]["albedo"],
               eye_before=st0["camera"]["position"],
               eye_after=st2["camera"]["position"], launches=launches,
               expected_launches=expect, server_stopped=not th.is_alive())
    print("editor", json.dumps(rep))
    print(f"editor preview {shape[1]}x{shape[0]}: {previews[-1]:.1f} ms "
          f"({card})")
    if not (edited.get("ok") and moved.get("ok")
            and st1["materials"][0]["albedo"] == [0.9, 0.2, 0.1]
            and img.shape == img2.shape == shape and img.mean() > 0
            and st2["camera"]["position"] != st0["camera"]["position"]
            and st2["spp"] == 0 and launches == expect
            and rep["server_stopped"]):
        raise SystemExit(f"editor: {rep}")
    return rep


def phase_entry(device):
    """The single-sample entry on the card (3u): `entry("cuda")`, one call
    of fn timed after one untimed, against `entry("cpu")` under phase 4's
    gate (jitter positions equal)."""
    import torch

    from directcomputeraytracing_tpu_torch.entry import entry

    card = _card_line()
    fn, args = entry("cuda")
    fn(*args)
    _reset_launches()
    (pos, val), ms = _synced_ms(lambda: fn(*args))
    launches = _launches()
    mb = 3                                  # the entry's max_bounce
    expect = _expected_launches(args[0], mb + 2, mb + 1, launches)
    fn_c, args_c = entry("cpu")
    pos_c, val_c = fn_c(*args_c)
    a, b = val_c.numpy().reshape(64, 64, 3), val.cpu().numpy().reshape(
        64, 64, 3)
    rep = dict(card=card, shapes=[list(pos.shape), list(val.shape)],
               device=str(val.device), ms=ms,
               positions_equal=bool(torch.equal(pos.cpu(), pos_c)),
               **_image_diff(a, b), mean_cpu=float(a.mean()),
               mean_card=float(b.mean()), launches=launches,
               expected_launches=expect)
    print("entry", json.dumps(rep))
    if not (rep["shapes"] == [[4096, 2], [4096, 3]] and _image_ok(rep)
            and rep["positions_equal"] and b.mean() > 0.0
            and launches == expect):
        raise SystemExit(f"entry: {rep}")
    return rep


def _dist_cornell_rank(out):
    """One of 3v's two gloo ranks on the card: DIST_CORNELL's cases, each
    on a new mesh over the two ranks; every rank writes its launches per
    case (`rank<r>.json`), rank 0 the images (`<case>.npy`)."""
    import torch
    import torch.distributed as dist

    from directcomputeraytracing_tpu_torch.film.filters import FilterParams
    from directcomputeraytracing_tpu_torch.parallel.dist import (
        DistributedRenderer,
        band_rows,
        make_mesh,
    )

    rank, p = dist.get_rank(), DIST_CORNELL
    rep = {}
    for name, spp_parallel, steps, filt in DIST_CORNELL_CASES:
        mesh = make_mesh(spp_parallel=spp_parallel)
        r, _ = _renderer("cornell", p, mesh.device)
        dr = DistributedRenderer(mesh, r.arrays, r.luts, r.camera, r.cfg,
                                 filter_params=FilterParams(*filt))
        _reset_launches()
        for _ in range(steps):
            dr.render_step()
        torch.cuda.synchronize()
        rep[name] = dict(launches=_launches(), spp=dr.spp,
                         band_rows=band_rows(r.cfg, mesh),
                         coords=[mesh.spp_index, mesh.tile_index],
                         device=str(mesh.device))
        img = dr.image()
        if rank == 0:
            np.save(os.path.join(out, f"{name}.npy"), img)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)


def phase_distributed(device, scene, cam, mk_ms_per_spp):
    """The distributed renderer on the card (3v): 3n's stand-in through a
    world of one on NCCL, then Cornell on two gloo ranks sharing the
    card, then `dryrun_multichip(2)`."""
    import tempfile

    import torch
    import torch.distributed as dist

    from directcomputeraytracing_tpu_torch.entry import (
        dryrun_multichip,
        run_gloo_world,
    )
    from directcomputeraytracing_tpu_torch.film.filters import FilterParams
    from directcomputeraytracing_tpu_torch.integrator.renderer import (
        CHUNK_PIXELS,
    )
    from directcomputeraytracing_tpu_torch.parallel.dist import (
        DistributedRenderer,
        band_rows,
        make_mesh,
    )

    card = _card_line()
    p = STANDIN
    r = _standin_renderer(scene, cam, p, device, "megakernel")
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(spp_parallel=1)
            dr = DistributedRenderer(mesh, r.arrays, r.luts, r.camera, r.cfg,
                                     filter_params=FilterParams(
                                         *STANDIN_FILTER))
            _, first_ms = _synced_ms(dr.render_step)
            _reset_launches()
            _, step_ms = _synced_ms(dr.render_step)
            launches = _launches()
            img = dr.image()
        finally:
            dist.destroy_process_group()
    hb = band_rows(r.cfg, mesh)
    chunks = -(-hb * r.cfg.width // CHUNK_PIXELS)
    mb = p["max_bounce"]
    expect = _expected_launches(r.arrays, (mb + 2) * chunks, (mb + 1) * chunks,
                                launches, alpha=r.cfg.any_hit)
    want, single_ms = _synced_ms(lambda: r.render(dr.spp))
    standin = dict(card=card, backend="nccl", world=1, mesh=mesh.shape,
                   band_rows=hb, chunks=chunks, steps=dr.spp,
                   first_step_ms=first_ms, step_ms=step_ms,
                   single_ms_per_spp=single_ms / dr.spp,
                   standin_megakernel_ms_per_spp=mk_ms_per_spp,
                   vs_single=_dist_close(img, want),
                   launches=launches, expected_launches=expect)
    print("distributed-standin", json.dumps(standin))
    if not (img.shape == (p["height"], p["width"], 3)
            and standin["vs_single"]["beyond_tol"] == 0
            and standin["vs_single"]["finite"] and chunks == 2
            and launches == expect):
        raise SystemExit(f"distributed stand-in: {standin}")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        run_gloo_world(2, _dist_cornell_rank, out)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for rank in range(2):
            with open(os.path.join(out, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
        imgs = {name: np.load(os.path.join(out, f"{name}.npy"))
                for name, *_ in DIST_CORNELL_CASES}
    cases, ok = {}, True
    for name, spp_parallel, steps, filt in DIST_CORNELL_CASES:
        single, _ = _renderer("cornell", DIST_CORNELL, device,
                              filter_params=FilterParams(*filt))
        n, mb = steps * spp_parallel, DIST_CORNELL["max_bounce"]
        want = single.render(n, samples_per_dispatch=1)
        per_rank = [rep[name] for rep in ranks]
        expect = [_expected_launches(single.arrays, steps * (mb + 2),
                                     steps * (mb + 1), rep["launches"])
                  for rep in per_rank]
        cases[name] = dict(spp_parallel=spp_parallel, filter=list(filt),
                           steps=steps, ranks=per_rank,
                           expected_launches=expect,
                           vs_single=_dist_close(imgs[name], want))
        ok &= (cases[name]["vs_single"]["beyond_tol"] == 0
               and cases[name]["vs_single"]["finite"]
               and all(rep["spp"] == n and rep["launches"] == e
                       for rep, e in zip(per_rank, expect)))
    t0 = time.perf_counter()
    dryrun_multichip(2)
    gloo = dict(card=card, backend="gloo", world=2, spawn_s=spawn_s,
                dryrun_s=time.perf_counter() - t0, cases=cases)
    print("distributed-cornell", json.dumps(gloo))
    if not ok:
        raise SystemExit(f"distributed Cornell on two gloo ranks: {gloo}")
    return standin, gloo


def phase_standin_edits_cpu_vs_card(device):
    """3s's albedo and opacity edits on the small stand-in, the card
    against the port's CPU (4m): the edited tables bit for bit, then the
    images (megakernel, 3n's Gaussian film) under phase 4's gate."""
    import torch

    p = SMALL_STANDIN_RENDER
    scene, cam, _, _ = _load_standin(**SMALL_STANDIN)
    m = _material_index(scene)
    imgs, tables = {}, {}
    for dev in (torch.device("cpu"), device):
        r = _standin_renderer(scene, cam, p, dev, "megakernel")
        r.set_material(m, albedo=(0.3, 0.6, 0.2))
        r.set_material(m, opacity=0.5)
        tables[dev.type] = r.arrays
        imgs[dev.type] = r.render(spp=p["spp"])
    a, b = imgs["cpu"], imgs[device.type]
    differ = [f for f in tables["cpu"]._fields
              if not torch.equal(getattr(tables["cpu"], f),
                                 getattr(tables[device.type], f).cpu())]
    rep = dict(scene="small_standin", integrator="megakernel",
               edits=["albedo", "opacity"], world_tris=_world_tris(scene),
               tables_differ=differ, **_image_diff(a, b),
               mean_cpu=float(a.mean()), mean_card=float(b.mean()))
    print("cpu-vs-card", json.dumps(rep))
    if differ or not (_image_ok(rep) and b.mean() > 0.0):
        raise SystemExit("small stand-in edits: the card differs from the "
                         "CPU")
    return rep


def _node_tables_s(arrays):
    """Host seconds of a scene's deferred node-table build (its first
    use), synchronised."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import traverse as tv

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tv.node_tables(arrays)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _walker_counts():
    from directcomputeraytracing_tpu_torch.accel import traverse as tv

    return dict(calls=tv.walk.calls, steps=tv.walk.total_steps)


def _timed_walk(arrays, o, d, every):
    """One closest walk of rays (o, d) with a done check every `every`
    steps: (ms by host clock between synchronisations, steps, host
    reads, the `WalkState`)."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import traverse as tv

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = tv.walk(arrays, o, d, 0.0, float("inf"), False,
                    check_every=every)
    torch.cuda.synchronize()
    ms = 1000.0 * (time.perf_counter() - t0)
    return ms, tv.walk.steps, tv.walk.host_reads, state


def phase_walker(device):
    """The stack walker at real size (3p): walker_grid(129, 128), the node
    table alone, rendered through the megakernel, and its casts against
    the port's CPU walker and `trace_ray`."""
    import torch

    from directcomputeraytracing_tpu_torch.accel import traverse as tv
    from directcomputeraytracing_tpu_torch.camera.camera import generate_ray
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
    from directcomputeraytracing_tpu_torch.scene import scene as scene_mod
    from directcomputeraytracing_tpu_torch.scene.presets import walker_grid
    from directcomputeraytracing_tpu_torch.utils.debug_trace import trace_ray

    from directcomputeraytracing_tpu_torch.scene.presets import sphere_grid

    p = WALKER_RENDER
    # what the node tables would add to the instanced grid's flatten
    t0 = time.perf_counter()
    inst_arrays, _ = scene_mod.flatten_scene(sphere_grid(*INST_GRID)[0],
                                             device)
    torch.cuda.synchronize()
    inst_host = dict(flatten=time.perf_counter() - t0,
                     node_tables=_node_tables_s(inst_arrays))
    del inst_arrays
    scene, cam = walker_grid(*WALKER_GRID)
    build_s = [0.0]
    inner = scene_mod.build_two_level

    def timed_two_level(*args):
        t0 = time.perf_counter()
        out = inner(*args)
        build_s[0] += time.perf_counter() - t0
        return out

    scene_mod.build_two_level = timed_two_level
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        r = Renderer(scene, cam, p["width"], p["height"],
                     max_bounce=p["max_bounce"], device=device)
        flatten_s = time.perf_counter() - t0
    finally:
        scene_mod.build_two_level = inner
    a = r.arrays
    tables = tv.node_tables(a)
    table_bytes = sum(x.numel() * x.element_size() for x in (
        tables.node_table, tables.tri_verts, a.inst_rows))
    if not (tv._resolve_backend(a, "auto") == "walk"
            and a.world_tris.shape[0] == 1 and a.isup_inst.shape[0] == 1):
        raise SystemExit("the walker grid did not flatten to node tables")
    r.render(spp=1)
    r.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp=p["spp"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, walks = _launches(), _walker_counts()
    expect_walks = p["spp"] * (2 * p["max_bounce"] + 3)
    peak_render = torch.cuda.max_memory_allocated() / 2**30

    # the camera cast: iterations a ray, and the done check every step
    # against every WALK_CHECK_EVERY steps (the same result)
    film = torch.rand((p["width"] * p["height"], 2), device=device,
                      generator=torch.Generator(device).manual_seed(5))
    o, d = generate_ray(r.camera, film, torch.zeros((film.shape[0], 3),
                                                    device=device))
    torch.cuda.reset_peak_memory_stats()
    timings, states = {}, {}
    for every in (tv.WALK_CHECK_EVERY, 1, tv.WALK_CHECK_EVERY, 1):
        ms, steps, reads, states[every] = _timed_walk(a, o, d, every)
        timings.setdefault(str(every), []).append(
            dict(ms=ms, steps=steps, host_reads=reads))
    peak_cast = torch.cuda.max_memory_allocated() / 2**30
    k8 = states[tv.WALK_CHECK_EVERY]
    same_k = all(torch.equal(x, y) for x, y in zip(k8, states[1]))
    iters = k8.iters.float()

    # oracles without a soup: the port's CPU walker on the same tables,
    # and trace_ray
    cpu = type(a)(*(x.cpu() for x in a))
    tv.register_node_tables(cpu, tv.NodeTables(
        tables.node_table.cpu(), tables.tri_verts.cpu(), tables.stack_size))
    n = WALKER_CPU_RAYS
    want = tv.walk(cpu, o[:n].cpu(), d[:n].cpu(), 0.0, float("inf"), False)
    got = type(k8)(*(x[:n].cpu() for x in k8))
    int_fields = ("triangle", "instance", "backface", "iters")
    int_diff = {f: int((getattr(want, f) != getattr(got, f)).sum())
                for f in int_fields}
    h = torch.isfinite(want.t)
    int_diff["hit"] = int((h != torch.isfinite(got.t)).sum())
    t_err = float((torch.abs(got.t[h] - want.t[h])
                   / (1.0 + want.t[h].abs())).max()) if h.any() else 0.0
    trace_diff = 0
    for i in range(WALKER_TRACE_RAYS):
        tr = trace_ray(cpu, o[i].cpu().numpy(), d[i].cpu().numpy())
        if tr.hit != bool(torch.isfinite(got.t[i])) or (
                tr.hit and tr.triangle != int(got.triangle[i])):
            trace_diff += 1
    rep = dict(scene="walker_grid", grid=list(WALKER_GRID),
               world_tris=_world_tris(scene),
               local_tris=sum(m.indices.shape[0] for m in scene.meshes),
               instances=len(scene.instances),
               host_s=dict(flatten=flatten_s, two_level_build=build_s[0]),
               inst_grid_host_s=inst_host,
               nodes=tables.node_table.shape[0],
               stack_size=tables.stack_size,
               table_bytes=table_bytes, shape=list(img.shape),
               finite=bool(np.isfinite(img).all()), mean=float(img.mean()),
               ms_per_spp=1000.0 * seconds / p["spp"], total_s=seconds,
               walks=walks, expected_walks=expect_walks,
               steps_per_walk=walks["steps"] / max(walks["calls"], 1),
               launches=launches, peak_mem_gib_render=peak_render,
               camera_cast=dict(
                   rays=int(o.shape[0]),
                   hit_share=float(torch.isfinite(k8.t).float().mean()),
                   iterations_mean=float(iters.mean()),
                   iterations_max=int(iters.max()),
                   check_every=timings,
                   same_result=same_k, peak_mem_gib=peak_cast),
               cpu_oracle=dict(rays=n, int_diff=int_diff, t_rel_err=t_err,
                               t_tol=TOL),
               trace_oracle=dict(rays=WALKER_TRACE_RAYS, diff=trace_diff))
    print("walker", json.dumps(rep))
    if not (rep["finite"] and rep["mean"] > 0.0
            and img.shape == (p["height"], p["width"], 3)):
        raise SystemExit("walker grid render is not a finite, non-black "
                         "image")
    if any(launches.values()) or walks["calls"] != expect_walks:
        raise SystemExit(f"walker render: kernels {launches}, walks {walks} "
                         f"!= {expect_walks}")
    if not same_k:
        raise SystemExit("the walker's done check changed its result")
    if any(int_diff.values()) or t_err > TOL or trace_diff:
        raise SystemExit(f"walker casts differ from the CPU walker or "
                         f"trace_ray: {rep['cpu_oracle']}, {trace_diff}")
    return rep


def _cli(args, timeout=600):
    """Run the port's CLI in a subprocess under -X importtime: (rc, its
    JSON line or None, stderr, wall seconds, the jax modules it
    imported)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "directcomputeraytracing_tpu_torch.cli.render", *args],
        capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.strip().splitlines()
             if ln.startswith("{")]
    jax_mods = [ln.rsplit("|", 1)[-1].strip() for ln in
                proc.stderr.splitlines() if ln.startswith("import time:")
                and ln.rsplit("|", 1)[-1].strip().split(".")[0] == "jax"]
    return (proc.returncode, json.loads(lines[-1]) if lines else None,
            proc.stderr, wall, jax_mods)


def _cli_ok(what, out, **want):
    rc, line, err, wall, jax_mods = out
    rep = dict(run=what, rc=rc, wall_s=wall, line=line, jax=jax_mods)
    print("cli", json.dumps(rep))
    if rc != 0 or line is None or jax_mods or any(
            line.get(k) != v for k, v in want.items()):
        tail = "\n".join(ln for ln in err.splitlines()[-20:]
                         if not ln.startswith("import time:"))
        raise SystemExit(f"cli {what} failed: {rep}\n{tail}")
    return rep


def phase_cli(device):
    """The port's CLI on the card in subprocesses (3q)."""
    import tempfile
    import xml.etree.ElementTree as ET

    from directcomputeraytracing_tpu_torch.accel.build import (
        serialize_bvh_to_xml,
    )
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
    from directcomputeraytracing_tpu_torch.lut.bake import bake_luts_cached
    from directcomputeraytracing_tpu_torch.scene.presets import cornell_box
    from directcomputeraytracing_tpu_torch.scene.standin import (
        write_standin_scene,
    )

    reps = {}
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return f"{tmp}/{name}"

        xml = write_standin_scene(path("standin"))
        reps["standin"] = _cli_ok("standin", _cli(
            [xml, "--spp", str(CLI_STANDIN_SPP), "--checkpoint",
             path("standin.npz"), "-o", path("standin.png")]),
            spp=CLI_STANDIN_SPP, resolution=[1920, 1080])
        with np.load(path("standin.npz")) as f:
            film = f["value"] / np.maximum(f["weight"][..., None], 1e-10)
        reps["standin"].update(finite=bool(np.isfinite(film).all()),
                               mean=float(film.mean()))
        if not (reps["standin"]["finite"] and reps["standin"]["mean"] > 0):
            raise SystemExit("the CLI's stand-in film is not finite and "
                             "non-zero")

        def resume():
            base = ["preset:cornell-glossy", *CLI_CORNELL, "--checkpoint",
                    path("ck.npz")]
            first = _cli(base + ["--spp", "4", "-o", path("ck4.png")])
            return first, _cli(base + ["--spp", "8", "-o", path("ck8.png")])

        runs = {f"aov_{k}_{s}": ["preset:" + s, "--aov", k, *CLI_CORNELL,
                                 "-o", path(f"aov_{k}_{s}.png")]
                for k in ("iteration_count", "normal")
                for s in ("cornell", "spheres-12")}
        runs["bvh"] = ["preset:cornell", *CLI_CORNELL, "--spp", "1",
                       "--output-bvh", path("bvh.xml"), "-o",
                       path("bvh.png")]
        with ThreadPoolExecutor(len(runs) + 1) as pool:
            resumed = pool.submit(resume)
            futures = {k: pool.submit(_cli, v) for k, v in runs.items()}
        first, second = resumed.result()
        reps["ck4"] = _cli_ok("checkpoint 4", first, spp=4)
        reps["ck8"] = _cli_ok("checkpoint resume 8", second, spp=8)
        if "resumed at 4 spp" not in second[2]:
            raise SystemExit("the second CLI run did not resume at 4 spp")
        for k, fut in futures.items():
            reps[k] = _cli_ok(k, fut.result())
        dump = open(path("bvh.xml")).read()
        ET.fromstring(dump)
        reps["bvh"]["equal_to_cpu_dump"] = dump == serialize_bvh_to_xml(
            cornell_box("area", "glossy")[0])
        if not reps["bvh"]["equal_to_cpu_dump"]:
            raise SystemExit("the CLI's BVH dump differs from the CPU dump")
        # the resumed film against 8 samples in this process
        r = Renderer(*cornell_box("area", "glossy"), 512, 512, max_bounce=4,
                     luts=bake_luts_cached(device=device), device=device)
        for _ in range(8):
            r.render_sample(r.spp)
        with np.load(path("ck.npz")) as f:
            value, weight, spp = f["value"], f["weight"], int(f["spp"])
        want_v = r.film.value.cpu().numpy()
        rel = float((np.abs(value - want_v)
                     / np.maximum(np.abs(want_v), 1e-30)).max())
        reps["resume_vs_in_process"] = dict(
            spp=spp, max_rel=rel, rtol=1e-6,
            weight_equal=bool(np.array_equal(weight,
                                             r.film.weight.cpu().numpy())))
        print("cli-resume", json.dumps(reps["resume_vs_in_process"]))
        if spp != 8 or not np.allclose(value, want_v, rtol=1e-6, atol=0) \
                or not reps["resume_vs_in_process"]["weight_equal"]:
            raise SystemExit("the resumed CLI film differs from the "
                             "in-process film")
    return reps


def phase_bake(device):
    """The LUT bake on the card (3r) against the committed bake, under
    the noise gate."""
    import torch

    from directcomputeraytracing_tpu_torch.lut.bake import bake_luts
    from directcomputeraytracing_tpu_torch.lut.textures import load_luts

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = bake_luts(seed=0, quality=1.0, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = load_luts(device)
    diffs = {}
    ok = True
    for k, (mean_s, max_s) in BAKE_SPREAD.items():
        diff = (getattr(got, k) - getattr(want, k)).abs()
        diffs[k] = dict(mean=float(diff.mean()), max=float(diff.max()),
                        bound_mean=2 * mean_s, bound_max=2 * max_s)
        ok &= diffs[k]["mean"] <= 2 * mean_s and diffs[k]["max"] <= 2 * max_s
        ok &= bool(torch.isfinite(getattr(got, k)).all())
    rep = dict(seconds=seconds, quality=1.0, seed=0, vs_committed=diffs)
    print("bake", json.dumps(rep))
    if not ok:
        raise SystemExit("the card's bake is outside the noise gate")
    return rep


def _bvh_diffs(want, got):
    """The fields of two `BVH`s that differ in any bit (shape and dtype
    included), and whether max_depth does."""
    out = [f for f in ("bbox_min", "bbox_max", "right_or_prim", "misc",
                       "prim_order", "leaf_depths")
           if not _same_bits(getattr(want, f), getattr(got, f))]
    return out + (["max_depth"] if want.max_depth != got.max_depth else [])


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _flatten_walker(native, p, device):
    """`walker_grid(*WALKER_GRID)` through `Renderer` with
    DCRT_NATIVE_BVH=native: host seconds of the flatten, of its BLAS
    builds, of its two-level build and of the TLAS build inside that, and
    the node tables on the host."""
    from unittest import mock

    import torch

    from directcomputeraytracing_tpu_torch.accel import build as build_mod
    from directcomputeraytracing_tpu_torch.accel import traverse as tv
    from directcomputeraytracing_tpu_torch.integrator.renderer import Renderer
    from directcomputeraytracing_tpu_torch.scene import scene as scene_mod
    from directcomputeraytracing_tpu_torch.scene.presets import walker_grid

    scene, cam = walker_grid(*WALKER_GRID)
    s = dict(blas=0.0, two_level=0.0, tlas=0.0)

    def timed(mod, attr, key):
        inner = getattr(mod, attr)

        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kw)
            finally:
                s[key] += time.perf_counter() - t0
        return mock.patch.object(mod, attr, call)

    with mock.patch.dict(os.environ, DCRT_NATIVE_BVH=native), \
            timed(scene_mod, "build_bvh", "blas"), \
            timed(scene_mod, "build_two_level", "two_level"), \
            timed(build_mod, "build_bvh", "tlas"):
        t0 = time.perf_counter()
        r = Renderer(scene, cam, p["width"], p["height"],
                     max_bounce=p["max_bounce"], device=device)
        torch.cuda.synchronize()
        s["flatten"] = time.perf_counter() - t0
    tables = tv.node_tables(r.arrays)
    host = dict(node_table=tables.node_table.cpu().numpy(),
                tri_verts=tables.tri_verts.cpu().numpy(),
                stack_size=tables.stack_size)
    return s, host


def phase_builders(device):
    """The BVH builders on the card's host (3w): the walker grid's flatten
    and one ~100k-triangle BLAS, numpy then C++, bit for bit."""
    from directcomputeraytracing_tpu_torch.accel.build import build_bvh
    from directcomputeraytracing_tpu_torch.scene.presets import uv_sphere
    from directcomputeraytracing_tpu_torch.scene.scene import triangle_bounds

    seconds, tables = {}, {}
    for native in ("0", "1"):
        seconds[native], tables[native] = _flatten_walker(
            native, WALKER_RENDER, device)
    if not all(seconds[n]["tlas"] > 0.0 for n in seconds):
        raise SystemExit("the walker grid's flatten built no TLAS")
    a, b = tables["0"], tables["1"]
    table_diffs = [k for k in ("node_table", "tri_verts")
                   if not _same_bits(a[k], b[k])]
    if a["stack_size"] != b["stack_size"]:
        table_diffs.append("stack_size")
    pos, idx = uv_sphere(*BUILDER_MESH)
    bmin, bmax = triangle_bounds(pos, idx)
    bvh, mesh_s = {}, {}
    for native in (False, True):
        t0 = time.perf_counter()
        bvh[native] = build_bvh(bmin, bmax, 2, use_native=native)
        mesh_s["native" if native else "numpy"] = time.perf_counter() - t0
    mesh_diffs = _bvh_diffs(bvh[False], bvh[True])
    rep = dict(card=_card_line(),
               walker=dict(grid=list(WALKER_GRID),
                           numpy_s=seconds["0"], native_s=seconds["1"],
                           nodes=int(a["node_table"].shape[0]),
                           stack_size=a["stack_size"], diffs=table_diffs),
               mesh=dict(uv_sphere=list(BUILDER_MESH),
                         triangles=int(idx.shape[0]),
                         nodes=int(bvh[True].num_nodes),
                         max_depth=bvh[True].max_depth,
                         numpy_s=mesh_s["numpy"],
                         native_s=mesh_s["native"], diffs=mesh_diffs))
    print("builders", json.dumps(rep))
    if table_diffs or mesh_diffs:
        raise SystemExit(f"the C++ and numpy BVH builders differ: walker "
                         f"{table_diffs}, mesh {mesh_diffs}")
    return rep


def _build_all():
    """Build the six kernel libraries, the nvcc runs in parallel, and
    beside them the host's BVH builder with g++."""
    from directcomputeraytracing_tpu_torch.accel import brute
    from directcomputeraytracing_tpu_torch.accel import clustered as cl
    from directcomputeraytracing_tpu_torch.accel import pairsweep as ps
    from directcomputeraytracing_tpu_torch.accel import worklist as wl
    from directcomputeraytracing_tpu_torch.ops import native
    from directcomputeraytracing_tpu_torch.tools import brute_ab, pair_ab
    from directcomputeraytracing_tpu_torch.tools import probe_worklist as pw
    from directcomputeraytracing_tpu_torch.tools import worklist_ab

    sources = (("brute_sweep.cu", brute.kernels),
               ("worklist.cu", wl.kernels), ("clustered.cu", cl.kernels),
               ("pairsweep.cu", ps.kernels), ("prep.cu", wl.prep_kernels),
               ("probes.cu", pw.kernels))

    def gxx():
        t0 = time.perf_counter()
        return native.load_native(), time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources) + 1) as pool:
        futures = {src: pool.submit(fn) for src, fn in sources}
        host = pool.submit(gxx)
    lib, gxx_s = host.result()
    print(f"build: bvh_builder.cpp -> {lib._name} in {gxx_s:.1f} s (g++)")
    for src, fut in futures.items():
        built = fut.result()
        print(f"build: {src} -> {built.path} in {built.seconds:.1f} s")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("ptxas:", line.strip())
    # the warp-walk sweeps' (grouped, per-ray and instanced, closest and
    # any-hit) registers, shared memory and spills, and their resident
    # blocks per SM on this card
    print("warp-ptxas", json.dumps(worklist_ab.ptxas_report(
        futures["worklist.cu"].result().log)))
    print("warp-resources", json.dumps(wl.warp_resources()))
    # the culls' (rows 7-8) the same
    print("cull-ptxas", json.dumps(worklist_ab.cull_ptxas_report(
        futures["worklist.cu"].result().log)))
    print("cull-resources", json.dumps(wl.cull_resources()))
    # the dense sweep's (rows 1-2) the same
    print("brute-ptxas", json.dumps(brute_ab.ptxas_report(
        futures["brute_sweep.cu"].result().log)))
    print("brute-resources", json.dumps(brute.resources()))
    # the clustered sweeps' (rows 4-5) the same
    print("cluster-resources", json.dumps(cl.resources()))
    # the pair kernels' (rows 15-17) the same
    print("pair-ptxas", json.dumps(pair_ab.ptxas_report(
        futures["pairsweep.cu"].result().log)))
    print("pair-resources", json.dumps(ps.resources()))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU",
              file=sys.stderr)
        return 1
    print(_card_line())
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])
    device = torch.device("cuda")

    t_start = time.perf_counter()

    def phase(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    phase("1 build", _build_all)
    reports, times = phase("2 dense kernels", phase_kernels, device)
    wl_reports, wl_times, wl_cull, wl_work, wl_census = phase(
        "2b work-list kernels", phase_worklist_kernels, device)
    _, _, g_errs, g_pool = phase("2c grouped kernels",
                                 phase_grouped_kernels, device)
    _, inst_errs, inst_row = phase(
        "2d instanced kernels", phase_instanced_kernels, device, wl_census)
    phase("2e instanced vs soup", phase_instanced_vs_soup, device)
    _, cl_errs, cl_row, _ = phase("2f clustered kernels",
                                  phase_clustered_kernels, device)
    _, pair_errs, pair_rows = phase("2g pair kernels", phase_pair_kernels,
                                    device)
    prep = phase("2h prep kernel", phase_prep_kernel, device)
    probe_item, probe_tr = phase("2i probe kernels", phase_probes, device,
                                 wl_times, wl_census)
    cornell = phase("3 Cornell render", phase_render, device, "cornell")
    grid = phase("3b sphere-grid render", phase_render, device, "grid")
    wave = phase("3c wavefront render", phase_wavefront, device)
    phase("3d wavefront vs megakernel", phase_wavefront_vs_megakernel,
          device)
    inst = phase("3e instanced render", phase_render, device, "inst_grid")
    if not inst["instanced"]:
        raise SystemExit("sphere_grid(27, 27) did not flatten instanced")
    phase("3f instanced wavefront render", phase_wavefront_pass, device,
          "inst_grid", INST_WAVEFRONT)
    cl_grid = phase("3g clustered render", phase_render, device, "grid",
                    CLUSTER_RENDER, "pallas_cluster", 1)
    phase("3h clustered wavefront render", phase_wavefront_pass, device,
          "grid", CLUSTER_WAVEFRONT, "pallas_cluster")
    pair_grid = phase("3i pair render", phase_render, device, "grid",
                      PAIR_RENDER, "pallas_pair", 1)
    pair_wave = phase("3j pair wavefront render", phase_pair_wavefront,
                      device)
    alpha = phase("3k alpha render", phase_render, device, "alpha_grid",
                  ALPHA_RENDER, "auto", 1)
    phase("3l alpha wavefront render", phase_wavefront_pass, device,
          "alpha_grid", ALPHA_WAVEFRONT)
    phase("3m textured alpha render", phase_render, device,
          "alpha_grid_textured", ALPHA_TEX_RENDER, "auto", 1)
    if not (alpha["split"] and alpha["recast_passes"]):
        raise SystemExit(f"the alpha render cast no split: {alpha}")
    _, standin, standin_cam, standin_img = phase(
        "3n stand-in wavefront render", phase_standin_wavefront, device)
    standin_mk = phase("3o stand-in megakernel render",
                       phase_standin_megakernel, device, standin,
                       standin_cam, standin_img)
    phase("3p walker render", phase_walker, device)
    phase("3q CLI", phase_cli, device)
    phase("3r LUT bake", phase_bake, device)
    phase("3s stand-in edits and preview", phase_standin_edits, device,
          standin, standin_cam)
    phase("3t editor", phase_editor, device)
    phase("3u single-sample entry", phase_entry, device)
    phase("3v distributed render", phase_distributed, device, standin,
          standin_cam, standin_mk["ms_per_spp"])
    phase("3w BVH builders", phase_builders, device)
    phase("4 Cornell card vs CPU", phase_cpu_vs_card, device, "cornell")
    phase("4b small grid card vs CPU", phase_cpu_vs_card, device,
          "small_grid")
    phase("4c small grid wavefront card vs CPU", phase_cpu_vs_card, device,
          "small_grid", "wavefront")
    small_inst = phase("4d small instanced grid card vs CPU",
                       phase_cpu_vs_card, device, "small_grid_forced")
    if not small_inst["instanced"]:
        raise SystemExit("the forced small grid did not flatten instanced")
    phase("4e small grid clustered card vs CPU", phase_cpu_vs_card, device,
          "small_grid", "megakernel", "pallas_cluster")
    phase("4f small grid pair wavefront card vs CPU", phase_cpu_vs_card,
          device, "small_grid", "wavefront", pool_backend="pallas_pair")
    phase("4g small grid slab-marched megakernel card vs CPU",
          phase_cpu_vs_card, device, "small_grid", slab_march=0.03)
    phase("4h alpha panel card vs CPU", phase_cpu_vs_card, device,
          "alpha_panel")
    phase("4i small alpha grid wavefront card vs CPU", phase_cpu_vs_card,
          device, "small_alpha_grid", "wavefront")
    phase("4j small textured alpha grid card vs CPU", phase_cpu_vs_card,
          device, "small_alpha_grid_textured")
    phase("4k small stand-in wavefront card vs CPU",
          phase_standin_cpu_vs_card, device)
    small_walker = phase("4l small walker grid card vs CPU",
                         phase_cpu_vs_card, device,
                         "small_walker_grid_forced", p=SMALL_WALKER_RENDER)
    if small_walker["instanced"] or not small_walker["walker"]:
        raise SystemExit("the small walker grid did not flatten to node "
                         "tables")
    phase("4m small stand-in edits card vs CPU",
          phase_standin_edits_cpu_vs_card, device)
    if "jax" in sys.modules:
        raise SystemExit("the port imported jax")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")

    brute_src = "directcomputeraytracing_tpu_torch/csrc/brute_sweep.cu"
    wl_src = "directcomputeraytracing_tpu_torch/csrc/worklist.cu"
    cl_src = "directcomputeraytracing_tpu_torch/csrc/clustered.cu"
    pair_src = "directcomputeraytracing_tpu_torch/csrc/pairsweep.cu"
    probes_src = "directcomputeraytracing_tpu_torch/csrc/probes.cu"
    ref_pair = "directcomputeraytracing_tpu/accel/pairsweep.py"
    ref_wl = "directcomputeraytracing_tpu/accel/worklist.py"
    ref_brute = "directcomputeraytracing_tpu/accel/pallas_brute.py"
    top = times["cornell32_moeller"]   # the main path's scene and test
    n, tris = N_RAYS, 32
    brute_closest_bound = dense_bound("closest", n, tris)
    brute_any_bound = dense_bound("any", n, tris)
    wl_closest_err = max(r["closest_max_abs_err"] for r in wl_reports)
    wl_any_err = max(r["any_max_abs_err"] for r in wl_reports)

    def row(name, src, replaces, launches, err, ms, plain_ms, bound,
            library_ms=None, **extra):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms, **extra}

    print(json.dumps({"kernels": [
        row("brute_closest", brute_src,
            "directcomputeraytracing_tpu/accel/pallas_brute.py:128",
            cornell["launches"]["brute_closest"],
            max(r["closest_max_abs_err"] for r in reports),
            top["closest_ms"], top["closest_twin_ms"], brute_closest_bound,
            kernel_ms=top["closest_kernel_ms"]),
        row("brute_any", brute_src,
            "directcomputeraytracing_tpu/accel/pallas_brute.py:179",
            cornell["launches"]["brute_any"],
            max(r["any_max_abs_err"] for r in reports),
            top["any_ms"], top["any_twin_ms"], brute_any_bound,
            kernel_ms=top["any_kernel_ms"]),
        row("cull_boxes", wl_src, f"{ref_wl}:365",
            grid["launches"]["cull_boxes"], wl_cull["err"],
            wl_times["cull_ms"], wl_times["cull_twin_ms"], wl_work["cull"]),
        row("refine", wl_src, f"{ref_wl}:445", grid["launches"]["refine"],
            wl_cull["refine_err"], wl_times["refine_ms"],
            wl_times["refine_twin_ms"], wl_work["refine"]),
        row("sweep_closest", wl_src, f"{ref_wl}:678",
            grid["launches"]["sweep_closest"], wl_closest_err,
            wl_times["closest_ms"], wl_times["closest_twin_ms"],
            wl_work["sweep_closest"],
            bound_ms_block_walk=wl_work["sweep_closest_block_walk"][0]),
        row("sweep_any", wl_src, f"{ref_wl}:866",
            grid["launches"]["sweep_any"], wl_any_err, wl_times["any_ms"],
            wl_times["any_twin_ms"], wl_work["sweep_any"],
            bound_ms_block_walk=wl_work["sweep_any_block_walk"][0],
            shadow_ms=wl_times["any_shadow_ms"]),
        row("sweep_closest_grouped", wl_src, f"{ref_wl}:1000",
            wave["launches"]["sweep_closest_grouped"], g_errs["closest"],
            g_pool["closest_ms"], g_pool["closest_twin_ms"],
            g_pool["closest_bound"],
            bound_ms_block_walk=g_pool["closest_bound_block_walk"][0]),
        row("sweep_any_grouped", wl_src, f"{ref_wl}:1113",
            wave["launches"]["sweep_any_grouped"], g_errs["any"],
            g_pool["any_ms"], g_pool["any_twin_ms"], g_pool["any_bound"],
            bound_ms_block_walk=g_pool["any_bound_block_walk"][0]),
        row("sweep_closest_inst", wl_src, f"{ref_wl}:1208",
            inst["launches"]["sweep_closest_inst"], inst_errs["closest"],
            inst_row["closest_ms"], inst_row["closest_twin_ms"],
            inst_row["closest_bound"],
            bound_ms_block_walk=inst_row["closest_bound_block_walk"][0]),
        row("sweep_any_inst", wl_src, f"{ref_wl}:1349",
            inst["launches"]["sweep_any_inst"], inst_errs["any"],
            inst_row["any_ms"], inst_row["any_twin_ms"],
            inst_row["any_bound"],
            bound_ms_block_walk=inst_row["any_bound_block_walk"][0],
            shadow_ms=inst_row["any_shadow_ms"]),
        row("cluster_cull", cl_src, f"{ref_brute}:338",
            cl_grid["launches"]["cluster_cull"], cl_errs["cull"],
            cl_row["cull_ms"], cl_row["cull_twin_ms"],
            cl_row["bounds"]["cull"], kernel_ms=cl_row["cull_kernel_ms"],
            bound_ms_reference=cl_row["bounds"]["cull_reference"][0]),
        row("cluster_closest", cl_src, f"{ref_brute}:425",
            cl_grid["launches"]["cluster_closest"], cl_errs["closest"],
            cl_row["closest_ms"], cl_row["closest_twin_ms"],
            cl_row["bounds"]["closest"], bound_ms_block_walk=cl_row[
                "bounds"]["closest_block_walk"][0]),
        row("cluster_any", cl_src, f"{ref_brute}:508",
            cl_grid["launches"]["cluster_any"], cl_errs["any"],
            cl_row["any_ms"], cl_row["any_twin_ms"], cl_row["bounds"]["any"],
            bound_ms_block_walk=cl_row["bounds"]["any_block_walk"][0]),
        row("pair_emit", pair_src, f"{ref_pair}:78",
            pair_wave["launches"]["pair_emit"], pair_errs["emit"],
            pair_rows["closest"]["emit_ms"],
            pair_rows["closest"]["emit_twin_ms"],
            pair_rows["closest"]["emit_bound"],
            kernel_ms=pair_rows["closest"]["emit_kernel_ms"]),
        row("pair_sweep_closest", pair_src, f"{ref_pair}:274",
            pair_wave["launches"]["pair_sweep_closest"], pair_errs["closest"],
            pair_rows["closest"]["sweep_ms"],
            pair_rows["closest"]["sweep_twin_ms"],
            pair_rows["closest"]["sweep_bound"],
            kernel_ms=pair_rows["closest"]["sweep_kernel_ms"]),
        row("pair_sweep_any", pair_src, f"{ref_pair}:359",
            pair_wave["launches"]["pair_sweep_any"], pair_errs["any"],
            pair_rows["any"]["sweep_ms"], pair_rows["any"]["sweep_twin_ms"],
            pair_rows["any"]["sweep_bound"],
            kernel_ms=pair_rows["any"]["sweep_kernel_ms"]),
        row("prep_rays", "directcomputeraytracing_tpu_torch/csrc/prep.cu",
            f"{ref_wl}:205", alpha["launches"]["prep_rays"],
            prep["max_abs_err"], prep["ms"], prep["twin_ms"], prep["bound"]),
        row("item_list", probes_src, "experiments/probe_worklist.py:23",
            probe_item["launches"], probe_item["max_abs_err"],
            probe_item["row"]["ms"], probe_item["twin_ms"],
            probe_item["bound"], kernel_ms=probe_item["row"]["kernel_ms"],
            bound_ms_issue=probe_item["bound_issue"]),
        row("transpose16", probes_src, "experiments/prof_prep.py:56",
            probe_tr["launches"], 0.0, probe_tr["layout"]["kernel_ms"],
            probe_tr["layout"]["twin_ms"], probe_tr["bound"],
            probe_tr["layout"]["library_ms"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
