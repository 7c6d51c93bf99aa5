"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths: through
mitsuba_tpu_torch.integrators.path.render bench config 1 (the Cornell
box, 256x256 px, 16 spp, depth 5, brute backend), bench config 2 (the
Cornell box with a rough-conductor block, a mirror block and an analytic
glass sphere, 512x512 px, 4 spp, depth 5, brute backend, camera lanes in
pixel-Morton order), bench config 4 (config 1's loss, the mean of the
path tracer's radiance, and its gradient with respect to the material
reflectance, one checkpoint a bounce), bench config 3 (the
101,762-triangle textured mesh under a sky, 512x512 px, 4 spp, depth 5,
cluster backend) with the card's default item walk (v6b, #9) and again
with the v5 walk (#7, `ex_walk="v5"`) and the v6 walk (#8), the same
scene on the bvh backend (the JAX package's default for it), and an
instanced scene (three instances of config 3's 101,760-triangle sphere sharing one copy of its triangles, on a floor
under an area light, 512x512 px, 4 spp, depth 5, cluster backend); and
through mitsuba_tpu_torch.integrators.volpath.render_volpath "fog", the
config-1 Cornell box in a homogeneous HG medium (sigma_s 0.0015, sigma_a
0.0003, g 0.4), 256x256 px, 16 spp, depth 5, whose bounces run the split
brute kernels #2 and #3; and through mitsuba_tpu_torch.ops.cluster's
cluster_closest / cluster_any (the v1 cluster intersector, #14) config
3's camera and shadow wavefronts against its triangles cut into
128-triangle clusters by the port's BVH; and through the probe drivers of
mitsuba_tpu_torch.probes (kernel_cost, r3_kernel, r3_mt, r3_refinebits,
r5_megakernel) the cost probes of the card (csrc/probes.cu, #15), the
work-list probe (#13) on config 3's work list and the refine kernel (#5)
at the refine-bits script's sizes; and through the scene-file front end
(mitsuba_tpu_torch.io.xml, io.bitmap, cli) the README's command,
`python -m mitsuba_tpu_torch scenes/cornell.xml -D depth=5 -D spp=64 -D
width=512 -D height=512 -o cornell.exr` (cli.main on the card: 16,777,216
lanes in one wavefront, #1), and an XML twin of config 3 written as
binary PLY files (tests/torch_xml_cases.py) on the cluster backend under
`auto` and on the bvh backend; and participating media (#2 and #3):
through io.xml.load_scene and render_volpath "hetero_xml", the box of
scenes/cornell.xml under `volpath` in a heterogeneous medium read from a
256³ float32 .vol of band-limited noise (64 MiB, written from seed 0 by
tests/torch_media_cases.py), 256x256 px, 16 spp, depth 5; "flake",
config 1's box in an oriented Gaussian-flake medium (64³ density and
fiber fields, stddev 0.3), the same size; through render_volpath_guided
"guided", fog at that size (8 learning + 8 guided spp, res 16); and
through render_volpath_media "tank", the volumetric tank of
tests/golden_scenes.py:118 rebuilt with the port's SceneBuilder (16
triangles, an index-matched glass box holding a homogeneous medium),
512x512 px, 4 spp, depth 6, and "tank_het", its interior a 128³ grid;
and the materials (#1, the spheres merged after it): through cli.main
"snow_xml", the repo's showcase `python -m mitsuba_tpu_torch
scenes/snow.xml -D depth=5 -D spp=64 -D width=512 -D height=512` (the
Wiscombe snow BRDF on four analytic spheres under the sky, its
ldsampler pattern and gaussian filter; 16,777,216 lanes), and through
render "bsdf_zoo" (tests/torch_bsdf_cases.py: Ward, rough glass under
Beckmann, GGX and Phong, a Phong rough conductor, a diffuse
transmitter, Wiscombe, Hanrahan-Krueger, a composite, a mask and
twosided Ward, brute), 512x512 px, 16 spp, depth 5; and the lights,
textures and cameras (#1, #2, #3, #11): through cli.main "lights_xml",
the lights file of tests/torch_light_cases.py (point, spot,
directional, sphere and envmap lights over the two Cornell blocks on a
floor, 22 triangles, a 1,024^2 bitmap EXR floor, a 512 x 1,024 sky
EXR), 512x512 px, 64 spp, depth 5, and the same file with an
orthographic camera at 16 spp; through render "textured_mip", the
receding checker floor of tests/test_mipmap.py:154 at 512x512x16, with
no filter, mip_filter and aniso_filter, and "textured_bvh", config 3's
scene on bvh with a 1,024^2 bitmap floor and mips, 512x512x4; through
integrators.ptracer.ptracer_render "ptracer", config 1's box at 256x256,
depth 5, 2^24 particles; and subsurface scattering, surface guiding,
motion blur and the last PathConfig options (#1, #3; #5, #6, #9, #10):
through cli.main "sss_xml", the dipole slab of tests/golden_scenes.py:144
as a scene file (tests/torch_sss_cases.py, <subsurface type="dipole">,
irrSamples 512), 512x512 px, 16 spp, depth 4, and its twins
"sss_multipole" (thickness 0.3, 3 extra dipoles) and "sss_adipole"
(anisoRatio 3); "guided_cli", `scenes/cornell.xml --guided`
(render_guided), and "motion_xml", tests/test_motion.py:25's moving box
as an animatedinstance under shutterClose 1 (render_motion over 4
bins), each 512x512 px, 16 spp, depth 5; through render config 1 with
hit_prediction and strict_normals ("config1_options") and config 3 with
sort_mode="octant" ("config3_octant") and hit_prediction
("config3_pred"); and the reverse-mode gradients off the brute backend
(phase 5f): config 3's scene on bvh (#11) and on cluster (#5, #6, #9,
#10), the instanced scene (#12, #11), sss_xml's slab with its
irradiance cache inside the step (#1, #3) and the particle tracer's
box (#2, #3), each at the size of its forward render; and what scene
files could not name before (phase 5g; tests/torch_leftover_cases.py,
its files written at run time from seeds): through cli.main
"cylinders_xml", scenes/cornell.xml's box with three analytic cylinders
(lambertian, rough conductor, a dielectric under toWorld), 512x512 px,
64 spp, and "cloth_xml", the box with an irawan floor from a weave file
and a procedural twill panel, 512x512 px, 16 spp (#1); through
render_volpath_media "cylinder_media", the box with a homogeneous medium
held in a dielectric cylinder, 512x512 px, 4 spp, depth 6 (#2); through
render "cylinders_cluster" and "cylinders_bvh", config 3's binary-PLY
twin with eight cylinders, 512x512 px, 4 spp (#5, #6, #9, #10; #11); and
through cli.main "leftovers_xml", a 256x256-cell hspan snow field
(130,050 triangles), 1,000 tessellated hair fibres (180,000 triangles),
a 1,024^2 JPEG ground and an area light of <blackbody
temperature="5800">, 512x512 px, 16 spp, written as EXR and as JPEG
(#5, #6, #9, #10).
Phases, each printing one JSON line:

  1. the card's name and power limit (as nvidia-smi reports them);
  2. the build of every native source (one compiler per source, all at
     once: nvcc for csrc/*.cu, sm_90a; the host c++ for the BVH
     builder), with the compiler's ptxas lines, and the resources of the
     item walks (#9 v6b, #8 v6 and #7 v5, at config 3's list widths),
     the stream walk (#10), the work-list walk (#12) and its probe (#13),
     the BVH walk (#11), the refine kernels (#5, #6), the brute kernel's
     four instances (#1-#4) and the v1 cluster intersector (#14): rows
     (blocks) resident per SM, registers, shared memory, spills;
  3. each kernel against its plain PyTorch version on the card, bit for
     bit (every field of every lane), at the shapes of its path, with the
     bound of the work these inputs need (the larger of the bytes they
     need over 3.35 TB/s and their float32 operations over 67 TFLOP/s):
     the brute kernel (#1) on 1,048,576 config-1 camera rays and their
     shadow rays, and #1-#4 on the corner cases of
     tests/torch_brute_cases.py (whole warps and tiles dead, single live
     lanes, every shadow lane dead, shadow rays occluded by the first and
     by the last row, exact ties of duplicated rows, |det| at 1e-9 and an
     ulp or two either side, zero and -0.0 direction components, live
     lanes with a zero direction, T = 1 to 300, a ragged last warp), both
     by the bits of every field, bounded
     by the live lanes' tests with all lanes' beside; the refine (S1),
     child-refine (S2, S3) and item kernels (#7 v5, #8 v6, #9 v6b) on the
     config-3 camera wavefront (coherent caps) and on a first diffuse
     bounce wavefront with its shadow rays (diffuse caps), #5 and #6 by
     the bits of every key and also at the XL caps, as each wavefront's
     query re-runs its overflowing rows, with two bounds (the live lanes'
     tests, and those of all 128 lanes of a row), and on the corner cases
     of tests/torch_refine_cases.py (whole warps dead, a single live lane,
     zero and tiny direction components, keys tied at -0.0 and +0.0,
     live prefixes of 0, 1 and the whole list with garbage ids past them,
     every cap width and the all-L2 root table); the stream
     kernel on the bounce and shadow rows; #9 also at the XL caps on the
     bounce rows, and #7-#10 on the corner cases of
     tests/torch_walk_cases.py (whole warps dead, escaping or
     occluded early, a dead row, planted exact ties; #9 and #8 at list
     widths 32, 384 and 768, #7 at 96, 512 and 1,024); #12 and #11 on
     the corner cases of
     tests/torch_instanced_cases.py (dead, occluded and sentinel warps, a
     dead row, a 540-slot row, planted ties, lists with an unused tail
     and cut short; equal t in two leaves, a leaf past the last
     triangle, a few lanes walking the whole tree); the v1 cluster
     kernel (#14) on
     the camera and bounce wavefronts and the shadow rays, bounded also by
     the row-wide tests (every live lane of a row that votes for a
     cluster), with the live lanes compared, and on the corner cases of
     tests/torch_v1_cases.py (six superclusters, rows of a tile voting
     differently, dead and occluded rows, empty and full lists, ties
     within and across clusters, maxt = inf, the miss sentinel); the BVH kernel
     on the bvh path's camera, bounce and shadow wavefronts; the
     work-list kernel, instanced and flat (on the same spheres baked into
     world space), on one row chunk of the instanced path's camera,
     bounce and shadow wavefronts (its first 1,024 rows), and instanced
     on the whole chunk, its last row included, on the segments that end
     at the list's last used slot and on the untrimmed ones (timed both);
     the BVH kernel as that path's overflow
     fallback, on the static triangles and as the instance walks; the
     split brute kernels (#2 shaded, #3 any, #4 closest, which no render
     path of the JAX package launches) on the second bounce of a
     full-size fog render and its NEE shadow rays, 1,048,576 lanes each,
     with their lanes, live lanes and tests (needed and issued);
  4. 64x64 renders gated (8x8-block relative RMSE <= 0.10, as bench.py)
     against tests/goldens/bench_cfg1.npz, against
     tests/torch_goldens/bench_cfg3_sphere.npz for config 3 on the
     cluster backend with each item walk (v6b, v5, v6, each launching
     its own walk kernel and no other) and on the bvh backend (the committed
     tests/goldens/bench_cfg3.npz was rendered with the bunny mesh, which
     is absent, so both packages render its sphere fallback; the distance
     to the bunny golden is reported beside), and against
     tests/torch_goldens/instanced.npz for the instanced scene; config 1
     with sorted bounces (`sort_rays`, the split kernels) against
     tests/goldens/bench_cfg1.npz; config 2 against
     tests/goldens/bench_cfg2.npz with bench.py's 16x16 blocks, limit
     0.15 and mean band (0.09, 0.21); fog at 1,024 spp against
     tests/torch_goldens/volpath_fog.npz (at 16 spp the estimator's own
     seed-to-seed distance, 0.22, is over the gate); scenes/cornell.xml
     loaded by the port at 48x48, depth 4, 128 spp, seed 777 against the
     reference's 256-spp tests/goldens/cornell.npz by
     tests/test_goldens.py's per-pixel Welch t-test (a pixel fails at
     |t| > 3.9, the image at 1%); the config-3 twin at 64x64 on each
     backend against bench_cfg3_sphere.npz, as config 3 and bvh are;
  5. renders of each path: one warm-up (on the cluster backend counting
     the lanes that reach the XL re-run and the stream fallback), then
     timed renders with every launch count set to 0 just before and read
     just after, then one profiled render; on the instanced path one more
     render timing the parts of its overflow fallback. After config 1 and
     after fog, one more render records each launch of #1 (config 1), or
     of #2 and, in another render, of #3 (fog): each is replayed alone,
     held against its plain version bit for bit and timed, with its
     lanes, live lanes, dead-warp share and tests (needed and issued) of
     each ray set; the profiles of config 1 and fog give #1's, #2's and
     #3's device ms per render in the kernels line (the profile's
     brute_kernel split by instance). Fog counts as rays
     the lanes passed to #2 and #3 (the JAX volpath counts none). The
     profile gives each of the port's kernels its device ms per render.
     After config 3, one more render records each launch of #9 and #10:
     its rows, live lanes and share of warps with no live lane, and of #5
     and #6, labelled by their query (closest or any; coherent, diffuse or
     XL caps), each replayed alone and timed, with its live entries; the
     profiles of config 3 and config3_v5 give #5's and #6's device ms per
     render in the kernels line. After config3_v5 and config3_v6, one more
     render records each launch of #7 or #8: each is replayed alone, held
     against its plain version bit for bit and timed, with its rows, live
     lanes, dead-warp share and the steps or L1 blocks it tests (#8 also
     the children admitted per tested L1 block, by the row and by each
     lane's own slab); their profiles give #7's and #8's device ms per
     render in the kernels line; after bvh
     and instanced, one more render records each launch of #11 and #12
     with its arguments, and each is replayed alone and timed: #11's
     device ms a render split into its own walks, the static triangles'
     fallback and the instance walks, #12's on trimmed and on untrimmed
     segments (its unused-slot tail apart from its walk), and each
     launch's rows or lanes, live lanes and dead-warp share. Config 2
     renders as config 1 does, its lanes in pixel-Morton order. Config 4
     (bench.py bench_backward) as the gradient phases of 5f run
     (`grad_phase`: a profiled counting step, then the forward and the
     value-and-gradient step best of 3 each with the card synchronised
     before each clock read, their ratio, spp/s, the step's peak memory,
     #1's launches in the forward and in the backward (the recompute)
     apart); then its checks at 32x32 px as 5f's (`grad_checks_phase`:
     the gradient against central differences, its linearity in emitter
     radiance, the step with a checkpoint a bounce against the one
     without, the card's gradient against the CPU's) and the brute
     wrappers' refusal of a ray that requires grad;
  5b. the front end: after config 1, the README's command through
     cli.main (launch counts set to 0 just before and read just after),
     then the same file through io.xml.load_scene (timed) and render,
     twice timed (s/render, Mrays/s, #1's launches, peak memory) and once
     profiled (device busy share); the EXR the CLI wrote, read back by
     io.bitmap.read_exr, must equal the seed-0 render bit for bit. After
     config 3, the twin's files written and loaded (timed), its tables
     against config 3's (torch.equal on each; the loader orders the two
     material rows by first use, so config 3's are compared permuted),
     its 512x512x4 renders as a render phase, launching #5, #6, #9 and
     #10 as config 3 does, then one render of the same files on the bvh
     backend, #11 5 + 5 times;
  5a. the materials, after the README's command: snow_xml through
     cli.main as that command is (its own pattern and filter in the
     library's renders too); the |t| > 3.9 rule at 48x48 px, 128 spp,
     seed 777, box-developed with per-pixel variance
     (render.film.develop_with_variance), on snow.xml (`golden_snow`,
     its ldsampler pattern), on tests/golden_scenes.py:51's Ward / Phong
     / rough-glass spheres (`golden_ward_spheres`) and on the zoo
     (`golden_bsdf_zoo`), against the JAX package's 256-spp CPU renders
     tests/torch_goldens/snow.npz, tests/goldens/ward_spheres.npz and
     tests/torch_goldens/bsdf_zoo.npz; bsdf_zoo as a render phase; the
     zoo's first bounce at 32x32 px, 4 spp on the card against the CPU
     (`bsdf_zoo_vs_cpu`: material ids, wo, weight, pdf, the delta and
     transmission flags, the largest difference);
  5d. the lights, textures and cameras, after the materials: lights_xml
     through cli.main as the README's command is; the |t| > 3.9 rule at
     48x48x128, seed 777, on the lights file (`golden_lights`) and on
     the mip floor with aniso_filter (`golden_textured`) against the JAX
     package's 256-spp renders tests/torch_goldens/lights.npz and
     texture_mip.npz; render phases of the orthographic lights file, of
     the mip floor under each filter (then one render of each gated by
     tests/test_mipmap.py's three checks: energy within 12%, the far
     rows' std halved, EWA's contrast over 1.3x the isotropic filter's),
     of textured_bvh (#11 5 + 5 a render) and of ptracer (#2 5 and #3 6
     a render; two runs equal bit for bit; tests/test_ptracer.py's rule
     against config 1's path render: the mean within 6%, the pixels'
     correlation over 0.9); the texel gradient at 32x32 px against
     central differences (within 1e-3) and the CPU's (`texture_grad`);
  5e. the subsurface, guiding and motion slice, after texture_grad:
     sss_xml, sss_multipole and sss_adipole through cli.main (#3 8 and
     #1 16 in the CLI: the irradiance cache's direct samples and
     indirect passes, then the render), each then loaded, its cache
     timed alone (`cache_seconds`), rendered twice on the filled cache
     (s/render, peak memory, #1 4 a render) and once whole under the
     profiler (device ms, kernels, busy share); the EXR equal to the
     seed-0 render bit for bit; golden_sss_slab and
     golden_guided_cornell by the |t| > 3.9 rule at 48x48, 128 spp,
     depth 4, seed 777 against the JAX package's goldens
     tests/goldens/sss_slab.npz (the cache at seed 99) and
     guided_cornell.npz (a res-12 guide learned on the same camera rays
     at seed 782); guided_cli (#1 10 a render: a learning and a guided
     pass; its EXR against the library's render by the largest
     difference: the learning pass adds in atomic order) and
     motion_xml (#1 20 a render, the EXR bit for bit, the smear and
     energy of tests/test_motion.py:80-110 against the box baked at
     mid-shutter); config1_options after config 1 (hit_prediction bit
     for bit config 1's image, pred_hit_frac; strict_normals finite in
     config 1's band); config3_octant and config3_pred after config 3 as
     render phases (#5, #6, #9 and #10 as config 3), each image within
     1e-6 of config 3's;
  5f. the gradients off brute, after config 4's checks (bench.py
     bench_backward's recipe, remat on: a counting step, then the
     forward and the value-and-gradient step best of 3 each (the
     step best of 2 where the counting step took over 10 s), their
     ratio, the peak memory of each, the kernels' launches in the
     forward and in the backward's recompute apart, a profile of the
     step with its top kernels and the index gathers' backward share,
     grad_abs_max; each fails on a gradient that is not finite or all
     zero, or a kernel that did not launch in both passes), at depths
     cut to GRAD_DEPTH, GRAD_SSS_DEPTH and GRAD_PT_DEPTH: grad_bvh and
     grad_cluster (config 3's scene on bvh, #11, and on cluster, #5, #6,
     #9, #10; with respect to the reflectance and the sky's image),
     grad_instanced (#12, #11; the reflectance and the radiance),
     grad_sss (sss_xml's slab file, the irradiance cache inside the
     step: #3 and #1; the reflectance, the radiance and sigma_tr; its
     peak under 40 GiB) and grad_ptracer (the ptracer phase's box and
     particles: #2 and #3; the radiance and the reflectance); after
     each, its checks at 32x32 px, 4 spp (tests/torch_grad_cases.py
     grad_checks: central differences within 2e-2, linearity in
     radiance 1e-4, remat on against off 1e-5, the card against the CPU
     1e-3 of the largest entry);
  5g. the leftovers, after motion_xml: cylinders_xml and cloth_xml
     through cli.main as cli_cornell (#1 5 a render, the EXR equal to the
     seed-0 render bit for bit) and their goldens (`golden_cylinders`,
     `golden_cloth`) by the |t| > 3.9 rule at 48x48x128, seed 777,
     against the JAX package's 256-spp renders on its kernel path
     (tests/torch_goldens/cylinders.npz, cloth.npz); cylinder_media,
     cylinders_cluster and cylinders_bvh as render phases, each after a
     line of its file's load (s, backend, triangles, cylinders, media);
     leftovers_xml through cli.main on the cluster backend (#5, #6 and
     #9 in the CLI's run and in each render), then the CLI again with a
     .jpg output, whose bytes must be the port's JPEG of the render's
     sRGB image, and `golden_leftovers` (the same files at the golden's
     smaller cell and fibre counts, tests/torch_goldens/leftovers.npz);
  5h. analytic hair and the integrators outside the CLI (ROADMAP A.12),
     after the leftovers: hair_xml (scenes/cornell.xml's box with
     HAIR_FIBERS analytic fibres of 16 points, 15,000 segments, through
     cli.main as cli_cornell at CLI_W x CLI_H x LEFT_SPP: #1 5 a
     render, the segment walk after it; the EXR equal to the render),
     `hair_walk` (its walk steps a render and the walks' device ms,
     replayed alone), `golden_hair` (the |t| rule at 48x48x128 against
     tests/torch_goldens/hair_cornell.npz at its own fibre count) and
     `hair_tess` (the same fibres tessellated, cluster: the means within
     HAIR_TESS_REL, tests/test_shapes_extra.py:127); hair_cluster
     (leftovers.xml with its fibres analytic, a render phase at W3 x H3 x
     SPP3: #5, #6, #9, #10 and the walk); then photonmap, ppm,
     photonmapper and sppm on cornell_box(INTEG_RES, INTEG_RES) at
     INTEG_SPP spp, depth INTEG_DEPTH and their default photon counts,
     irrcache, vpl and adaptive on the box, bre in fog, photons_cluster
     (sppm_render on leftovers.xml, cluster, one sample a pixel a pass:
     #5, #6, #9, #10; config 3's scene has no light a photon can leave):
     each one profiled run, a line of its seconds, launches, peak
     memory, device busy ms and share and its aux numbers; and
     `golden_integrators`: each at 48x48 against the JAX package's CPU
     image at the same seed and counts (tests/torch_goldens/
     integrators.npz) by the relative RMSE of 8x8-block means, at most
     INTEG_REL_RMSE_MAX (a photon map's pixels share their photons, so
     the |t| rule does not apply);
  5c. the media: gates at 64x64, 1,024 spp, depth 5 against
     tests/torch_goldens/volpath_fog.npz with fog's 0.10 block gate and
     band: a heterogeneous medium of constant density 1 over a grid
     covering +-1e5 with fog's coefficients (`golden_64_hetero_const`:
     Woodcock tracking's analog weight is exact for a gray medium) and
     render_volpath_guided on fog (`golden_64_guided`); the tank at
     48x48 px, 128 spp, depth 6, seed 777 against
     tests/goldens/volumetric_tank.npz by the Welch |t| rule
     (`golden_tank`); the interior sigma_a's and sigma_s's gradients
     against central differences (`tank_grad`: tests/test_grad.py:76-97's
     tank at 32x32 px, 32 spp, h 0.02, seeds 20-31, within 8%) and
     against the CPU's; the five media paths as render phases (#2's and
     #3's launches and device ms a render; the .vol's load timed); and
     hetero_xml, flake and tank_het at 32x32 px, 4 spp on the card
     against the CPU (the mean's distance, the lanes that differ);
  6. the v1 cluster entry points on config 3's camera and shadow
     wavefronts, with the launch counts set to 0 just before and read just
     after, held against the exact-cull path's hits;
  7. the probes: each probe kernel against its plain version on the card
     (bit for bit, or within ops/probes.py's TOLERANCE for the tensor-core
     products and the approximate reciprocals of V2 and V4) at step counts
     where the plain version takes under a second, #13 on the first 1,024
     rows of config 3's 1,048,576-lane work list and on the flat lists of
     tests/torch_instanced_cases.py; then, every launch count
     set to 0 just before and read just after, the five probe drivers at
     the scripts' sizes (a line per probe and form), and the library
     yardsticks (torch.matmul on the products' shapes, table[idx] on the
     gathers'), timed here only.

Then a JSON line describing each kernel, and as the last line
{"ok": true, "device": {...}}. Any failure raises and the exit code is not
0; without a CUDA device the script exits 2 before doing anything. It
imports nothing of JAX.

    python3 chip_smoke.py --parent FILE

also reports, in each kernel_vs_plain line, the time that another run's
output FILE gives the same kernel at the same stage (`parent_ms`): run a `git archive` of the parent
commit first, in the same call, and pass its output.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
W1, H1, SPP1, DEPTH1 = 256, 256, 16, 5     # bench config 1
W3, H3, SPP3, DEPTH3 = 512, 512, 4, 5      # bench config 3, bvh, instanced
W2, H2, SPP2, DEPTH2 = 512, 512, 4, 5      # bench config 2
W4, H4, SPP4, DEPTH4 = 256, 256, 16, 5     # bench config 4 (gradient)
TIMED = {"config1": 2, "config2": 2, "config3": 2, "config3_v5": 2,
         "config3_v6": 2,
         "bvh": 2, "instanced": 2, "volpath": 2, "xml_config3": 2,
         "hetero_xml": 2, "flake": 2, "guided": 2, "tank": 2,
         "tank_het": 2, "bsdf_zoo": 2, "lights_ortho": 2,
         "textured_mip": 1, "textured_mip_mip": 1, "textured_mip_aniso": 1,
         "textured_bvh": 2, "ptracer": 2, "config3_octant": 2,
         "config3_pred": 2, "cylinders_cluster": 2, "cylinders_bvh": 2,
         "cylinder_media": 2, "hair_cluster": 1}
# participating media: hetero_xml (scenes/cornell.xml's box in a grid
# medium read from a HX_GRID³ float32 .vol, 64 MiB), flake (config 1's
# box in an oriented Gaussian-flake medium, FLAKE_GRID³ density and
# fiber fields) and guided (fog through render_volpath_guided, res 16) at
# config 1's size; the volumetric tank of tests/golden_scenes.py:118 at
# TANK_RES, homogeneous and (tank_het) a TANK_GRID³ grid (8 MiB)
HX_GRID, HX_SIGMA_T, HX_ALBEDO, HX_G = 256, 0.005, 0.8, 0.4
FLAKE_GRID, FLAKE_STDDEV = 64, 0.3
FLAKE_SIGMA = dict(sigma_s=(0.003,) * 3, sigma_a=(0.001,) * 3)
TANK_RES, TANK_SPP, TANK_DEPTH, TANK_GRID = 512, 4, 6, 128
# tests/test_goldens.py's gate on the tank (48x48 px, 128 spp, depth 6,
# seed 777) against tests/goldens/volumetric_tank.npz
TANK_GOLD_RES, TANK_GOLD_SPP, TANK_GOLD_SEED = 48, 128, 777
# tests/test_grad.py:76-97's gate on the interior sigma: central
# differences, h 0.02, seeds 20-31, within 8%, here at 32x32 px
GRAD_RES, GRAD_SPP, GRAD_H, GRAD_SEEDS, GRAD_REL = 32, 32, 0.02, \
    range(20, 32), 0.08
# card against CPU: 32x32 px, 4 spp (Woodcock decisions within an ulp and
# the libraries' exp, log and erfinv may flip lanes: the means within
# MEDIA_CPU_REL)
MEDIA_CPU_RES, MEDIA_CPU_REL = 32, 0.03
# the README's command: scenes/cornell.xml, 512x512 px, 64 spp, depth 5
# (16,777,216 lanes in one wavefront, as the reference renders it); the
# repo's showcase, scenes/snow.xml (the Wiscombe snow BRDF, four analytic
# spheres, the sky, its ldsampler pattern and gaussian filter), the same
CLI_W, CLI_H, CLI_SPP, CLI_DEPTH = 512, 512, 64, 5
# the materials slice: tests/torch_bsdf_cases.py's bsdf_zoo (every BSDF
# kind and option the port has, brute, spheres merged after #1) at
# 512x512 px, 16 spp, depth 5; its first bounce on the card against the
# port on the CPU at ZOO_CPU_RES, ZOO_CPU_SPP
ZOO_RES, ZOO_SPP, ZOO_DEPTH = 512, 16, 5
ZOO_CPU_RES, ZOO_CPU_SPP = 32, 4
# tests/test_goldens.py's gate of scenes/cornell.xml against the
# reference's 256-spp render tests/goldens/cornell.npz: 48x48 px, depth
# 4, 128 spp, seed 777; a pixel fails at |t| > 3.9, the image at 1%
GOLD_RES, GOLD_DEPTH, GOLD_SPP, GOLD_SEED = 48, 4, 128, 777
GOLD_CRIT, GOLD_FAIL_MAX = 3.9, 0.01
# the same rule on the JAX package's 256-spp CPU renders of snow.xml
# and bsdf_zoo (tests/torch_goldens, scripts/gen_torch_goldens.py) and
# on tests/goldens/ward_spheres.npz (tests/golden_scenes.py:51), each at
# its golden's size and depth, 128 spp, seed 777
STATS_GOLDENS = {"golden_snow": "tests/torch_goldens/snow.npz",
                 "golden_ward_spheres": "tests/goldens/ward_spheres.npz",
                 "golden_bsdf_zoo": "tests/torch_goldens/bsdf_zoo.npz",
                 "golden_lights": "tests/torch_goldens/lights.npz",
                 "golden_textured": "tests/torch_goldens/texture_mip.npz",
                 "golden_cylinders": "tests/torch_goldens/cylinders.npz",
                 "golden_cloth": "tests/torch_goldens/cloth.npz",
                 "golden_leftovers": "tests/torch_goldens/leftovers.npz",
                 "golden_hair": "tests/torch_goldens/hair_cornell.npz"}
# the lights slice (tests/torch_light_cases.py): the lights file (point,
# spot, directional, sphere and envmap lights; a LIGHTS_TEX^2 floor EXR,
# an LIGHTS_ENV x 2 LIGHTS_ENV sky EXR) through the CLI at CLI_W x CLI_H x
# CLI_SPP, and with its orthographic camera at ORTHO_SPP; the receding
# checker floor of tests/test_mipmap.py:154 at MIP_RES^2 x MIP_SPP, depth
# 5, with no filter, mip_filter and aniso_filter, gated by that test's
# three checks (MIP_ENERGY, MIP_FAR_STD, MIP_CONTRAST; its far rows
# 18-30 of 32); config 3's scene on bvh with a bitmap floor and mips at
# W3 x H3 x SPP3; the particle tracer on config 1's box at PT_RES^2,
# depth 5, PT_PARTICLES particles, gated by tests/test_ptracer.py's rule
# against config 1's path render (PT_MEAN_REL, PT_CORR); the texel
# gradient of tests/test_grad.py:100 at TEX_GRAD_RES^2, 4 spp, depth 2,
# seed 5, central differences within TEX_GRAD_REL (that test's bound)
LIGHTS_TEX, LIGHTS_ENV, ORTHO_SPP = 1024, 512, 16
MIP_RES, MIP_SPP = 512, 16
MIP_ENERGY, MIP_FAR_STD, MIP_CONTRAST = 0.12, 0.5, 1.3
PT_RES, PT_PARTICLES, PT_MEAN_REL, PT_CORR = 256, 1 << 24, 0.06, 0.9
TEX_GRAD_RES, TEX_GRAD_REL = 32, 1e-3
# config 4 and the gradients off brute (ROADMAP A.14), bench.py
# bench_backward's recipe (the mean of L, remat on, best of GRAD_ROUNDS
# steps, the profiled counting step the first of them, or of two where
# it took over GRAD_LONG_S s): config 1's box (config 4), config 3's
# scene on bvh and cluster (with respect to the reflectance and the
# sky's image), the instanced scene
# (reflectance, radiance), sss_xml's slab file at SSS_W x SSS_H x SSS_SPP,
# depth SSS_DEPTH, SSS_IRR points, its cache inside the step (reflectance,
# radiance, sigma_tr), and the particle tracer's box (PT_RES, depth 5,
# PT_PARTICLES; radiance, reflectance); each path's checks at
# GRAD_CHECK_RES^2 (tests/torch_grad_cases.py grad_checks: central
# differences 2e-2, linearity in radiance 1e-4, remat on against off
# 1e-5, the card against the CPU 1e-3 of the largest entry), the slab
# with GRAD_CHECK_POINTS points, the particle tracer GRAD_CHECK_PARTICLES
GRAD_ROUNDS, GRAD_LONG_S, GRAD_CHECK_RES = 3, 10.0, 32
# the gradient phases' depths, cut to make room for the hair and
# integrator phases (5h) in the script's time limit (grad_bvh,
# grad_cluster and grad_instanced from 5 to GRAD_DEPTH, grad_sss from 4
# to GRAD_SSS_DEPTH, grad_ptracer from 5 to GRAD_PT_DEPTH): every step
# is the gathers' backward a bounce at any depth (PERF.md section 6)
GRAD_DEPTH, GRAD_SSS_DEPTH, GRAD_PT_DEPTH = 3, 2, 2
GRAD_CHECK_POINTS, GRAD_CHECK_PARTICLES = 64, 1 << 16
# the subsurface, guiding and motion slice: the dipole slab of
# tests/golden_scenes.py:144 as a scene file (tests/torch_sss_cases.py,
# irrSamples SSS_IRR) through the CLI at SSS_W x SSS_H x SSS_SPP, depth
# SSS_DEPTH, and its multipole (thickness 0.3, 3 extra dipoles) and
# adipole (ratio 3) twins; scenes/cornell.xml --guided and the moving box
# of tests/test_motion.py:25 (an animatedinstance, shutterClose 1, 4 time
# bins) at the same size, depth CLI_DEPTH; the goldens sss_slab and
# guided_cornell by tests/test_goldens.py's rule at GOLD_RES, GOLD_SPP,
# depth 4, seed 777 (the cache at seed 99; the guide a res-12 grid learned
# on the same camera rays at seed 777 + 5, tests/golden_scenes.py:203-240)
SSS_W, SSS_H, SSS_SPP, SSS_DEPTH, SSS_IRR = 512, 512, 16, 4, 512
SSS_CACHE_SEED, GUIDE_LEARN_SEED, GUIDE_GOLD_RES = 99, 777 + 5, 12
# tests/test_motion.py:80-110: the blurred image's bright (mean > 0.35)
# columns span more than MOTION_SMEAR px beyond the mid-shutter render's,
# its mean within MOTION_ENERGY of it
MOTION_SMEAR, MOTION_ENERGY, MOTION_BINS = 3, 0.1, 4
# what scene files could not name before (ROADMAP A.15, A.11;
# tests/torch_leftover_cases.py): cylinders.xml (scenes/cornell.xml's box
# with three analytic cylinders) through the CLI at CLI_W x CLI_H x
# CLI_SPP; cloth.xml (a weave-file floor, a procedural twill panel) at
# LEFT_SPP; config 3's binary-PLY twin with eight cylinders at W3 x H3 x
# SPP3 on cluster and on bvh; the box with a medium held in a cylinder
# through render_volpath_media at TANK_RES, TANK_SPP, TANK_DEPTH; and
# leftovers.xml (a LEFT_CELLS^2-cell hspan field, LEFT_FIBERS tessellated
# hair fibres of 16 points and 6 sides, a LEFT_TEX^2 JPEG ground, a
# blackbody area light) through the CLI at LEFT_SPP, as EXR and as JPEG;
# the first, the cloth and the leftovers (at the golden's own, smaller
# cell and fibre counts) gated by tests/test_goldens.py's rule against
# the JAX package's CPU renders
LEFT_SPP = 16
LEFT_CELLS, LEFT_FIBERS, LEFT_TEX = 256, 1000, 1024
# analytic hair and the integrators outside the CLI (ROADMAP A.12;
# tests/torch_leftover_cases.py write_hair_cornell_xml): HAIR_FIBERS
# fibres of 16 points in scenes/cornell.xml's box, analytic against
# tessellated within HAIR_TESS_REL in the mean (tests/test_shapes_extra.py
# :127) at W3 x H3 x SPP3; the integrators on cornell_box(INTEG_RES) at
# INTEG_SPP spp, depth INTEG_DEPTH, each at its defaults, and their gates
# at INTEG_GOLD_RES against tests/torch_goldens/integrators.npz: the port
# on the CPU reads at most 1.4e-3 there (sppm; the others 2e-5 or less),
# the limit is INTEG_REL_RMSE_MAX
HAIR_FIBERS, HAIR_TESS_REL = 1000, 0.08
INTEG_RES, INTEG_SPP, INTEG_DEPTH, INTEG_GOLD_RES = 512, 4, 5, 48
INTEG_REL_RMSE_MAX = 0.01
FOG = dict(sigma_s=(0.0015,) * 3, sigma_a=(0.0003,) * 3, g=0.4)
FOG_GOLDEN_SPP = 1024          # tests/torch_goldens/volpath_fog.npz
GOLDEN_REL_RMSE_MAX = 0.10     # bench.py validate_golden, 8x8 blocks
# bench.py's gate for config 2: specular paths carry a ray's rounding
# into its whole contribution, so 16x16 blocks and a wider limit
CFG2_BLOCK, CFG2_REL_RMSE_MAX = 16, 0.15
# bench.py expect_mean for configs 1 and 3 (bvh renders config 3's
# scene); the instanced band is +-40% of the reference's 64x64 render of
# its scene (tests/torch_goldens/instanced.npz, mean 0.5216), as wide as
# config 3's band is around its golden; the fog band the same +-40% of
# its golden's mean (0.0427)
MEAN_BAND = {"config1": (0.09, 0.21), "config2": (0.09, 0.21),
             "config3": (0.17, 0.41),
             "config3_v5": (0.17, 0.41), "config3_v6": (0.17, 0.41),
             "bvh": (0.17, 0.41), "instanced": (0.31, 0.73),
             "volpath": (0.0256, 0.0598), "cli_cornell": (0.09, 0.21),
             "xml_config3": (0.17, 0.41), "xml_config3_bvh": (0.17, 0.41),
             # +-40% of the CPU's 32x32x4 renders of each scene (PR 17:
             # 0.1107, 0.1064, 0.0861), of the fog golden's mean for
             # guided, of tests/goldens/volumetric_tank.npz's (0.1214)
             "hetero_xml": (0.066, 0.155), "flake": (0.064, 0.149),
             "guided": (0.0256, 0.0598), "tank": (0.073, 0.170),
             "tank_het": (0.052, 0.121),
             # +-40% of the JAX package's 48x48 renders (snow 1.3541,
             # bsdf_zoo 0.2576; tests/torch_goldens)
             "snow_xml": (0.812, 1.896), "bsdf_zoo": (0.155, 0.361),
             # +-40% of the JAX package's 48x48 renders (lights 0.3947,
             # the mip floor 0.4319; tests/torch_goldens) and of the
             # port's CPU renders at 32x32x4 (the orthographic lights
             # file 0.4896, the bvh floor 0.2702); the particle tracer's
             # is config 1's
             "lights_xml": (0.237, 0.553), "lights_ortho": (0.294, 0.685),
             "textured_mip": (0.259, 0.605),
             "textured_mip_mip": (0.259, 0.605),
             "textured_mip_aniso": (0.259, 0.605),
             "textured_bvh": (0.162, 0.378), "ptracer": (0.09, 0.21),
             # +-40% of the port's CPU renders at 48x48x4 of the slab's
             # files (dipole 0.4011, multipole 0.3141, adipole 0.6072)
             # and of the moving box's file (0.0736); --guided cornell as
             # cli_cornell; config 3's options as config 3
             "sss_xml": (0.241, 0.561), "sss_multipole": (0.188, 0.440),
             "sss_adipole": (0.364, 0.850), "motion_xml": (0.044, 0.103),
             "guided_cli": (0.09, 0.21), "config3_octant": (0.17, 0.41),
             "config3_pred": (0.17, 0.41),
             # +-40% of the port's CPU renders at 32x32x4 of the files of
             # tests/torch_leftover_cases.py (cylinders.xml 0.1550,
             # cloth.xml 0.1784, config 3 with cylinders 0.2597 on cluster
             # and on bvh, the cylinder's medium 0.1451 at depth 6,
             # leftovers.xml 0.2866)
             "cylinders_xml": (0.0930, 0.217), "cloth_xml": (0.107, 0.250),
             "cylinders_cluster": (0.156, 0.364),
             "cylinders_bvh": (0.156, 0.364),
             "cylinder_media": (0.0871, 0.203),
             "leftovers_xml": (0.172, 0.401),
             # +-40% of the port's CPU renders at 32x32x4 of the files of
             # write_hair_cornell_xml (1,000 fibres, 0.1518) and of
             # leftovers.xml with analytic fibres (0.2732)
             "hair_xml": (0.0911, 0.2125), "hair_cluster": (0.164, 0.383),
             # sppm estimates the radiance leftovers_xml's path tracer
             # does: its band
             "photons_cluster": (0.172, 0.401)}
# where a plain version takes over a second on the whole wavefront (the
# script's own runs on the H100, PERF.md section 6), kernel and plain
# version are compared and timed on its first PLAIN_CUT_ROWS rows (or
# 128 times as many lanes) instead, and the phase says so; a plain version
# slower than PLAIN_SLOW_S on the rows compared is timed over 3 runs, not 10
PLAIN_CUT_ROWS = 1024
PLAIN_CUT_LANES = PLAIN_CUT_ROWS * 128
PLAIN_SLOW_S = 0.1
# float32 operations per test as the kernels write them (no FMA): a
# Moller-Trumbore triangle test (two cross products, three dot products
# and a determinant, one division, the bound compares); a slab test of a
# box with the ray's reciprocals at hand (per axis two subtractions, two
# products, a min and a max, then the interval's reductions and compare);
# a ray moved into object space (a 3x4 map on origin and direction); a
# Pluecker triangle test of the v1 cluster kernel: of its four ordered
# 10-term sums the terms with the table's fixed +0.0 columns do not
# depend on the triangle (a lane takes them once, csrc/cluster.cu
# `Zeros`), so every test needs rows A, B and C at 13 operations each
# and the sign and eligibility rules (PLUCKER_OPS, 52), and an eligible
# one also row D (8), the division, t and its compares (PLUCKER_ELIG_OPS,
# 13): 65 in all, not the 94 of four whole sums
MT_OPS, BOX_OPS, XFORM_OPS = 53, 25, 21
PLUCKER_OPS, PLUCKER_ELIG_OPS = 52, 13
# bytes a kernel needs of a table entry it reads, where the table's rows
# are wider than what it reads: a K8 cluster of ex["tri"] (8 triangles of
# 10 floats: v0, e1, e2 and the prim id, of 128-float rows); the 8 child
# boxes of a parent in a child table ex["ct0"] or ex["ct1"] (6 floats
# each, of 128); a v1 cluster (512 Pluecker rows of 10 floats, of 16); a
# v1 cluster box (6 floats of aabb's 8)
K8_BYTES, CHILD_BOX_BYTES = 8 * 10 * 4, 8 * 6 * 4
V1_CLUSTER_BYTES, V1_BOX_BYTES = 512 * 10 * 4, 6 * 4
# the v1 exact path check: lanes whose hit (or occlusion) must agree with
# the exact-cull path's; the two test triangles in different forms, so a
# ray through an edge may take the neighbour. Their t agree within
# V1_T_RTOL: the Pluecker products cancel on small triangles away from
# the origin (up to 4e-4 relative on config 3's sphere, CPU run of the
# plain versions on a 96x96x4 camera wavefront)
V1_AGREE_MIN, V1_T_RTOL = 0.999, 1e-3
# the probe checks' item lists, and the side of r3_kernel's camera grid
PROBE_ITEMS = 512
PROBE_SIDE = 1024
# H100 SXM (NVIDIA's data sheet, at its 700 W limit): float32 outside
# the tensor cores, and HBM3; the dense tensor-core rates
PEAK_FP32_OPS, PEAK_BYTES = 67e12, 3.35e12
PEAK_TC_OPS = {"tf32": 495e12, "bf16": 989e12}
# each brute kernel's instance of csrc/intersect_brute.cu's brute_kernel
# <kClosest, kShade, kAny, kStride, kStill>, as the profile names it
BRUTE_INSTANCE = {"shaded_any": "<true, true, true, 29, false>",
                  "shaded": "<true, true, false, 29, false>",
                  "any": "<false, false, true, 9, true>",
                  "closest": "<true, false, false, 9, false>"}


_T0 = time.perf_counter()
# {(kernel, stage): ms} of another tree's kernel_vs_plain lines
# (--parent FILE), reported beside this tree's as parent_ms; and their
# device_ms where they have it, as parent_device_ms
PARENT_MS = {}
PARENT_DEVICE_MS = {}
# each render phase's torch.profiler summary, by phase tag
PROFILES = {}


def read_parent(path):
    """The kernel_vs_plain times of another run's output file."""
    with open(path) as f:
        for ln in f:
            try:
                rec = json.loads(ln)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("phase") == \
                    "kernel_vs_plain":
                PARENT_MS[(rec["kernel"], rec["stage"])] = rec["ms"]
                if rec.get("device_ms") is not None:
                    PARENT_DEVICE_MS[(rec["kernel"], rec["stage"])] = \
                        rec["device_ms"]


def phase(tag, **kv):
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": tag, "t": time.perf_counter() - _T0, **kv}),
          flush=True)


def cuda_ms(fn, reps=10):
    """Median of `reps` CUDA-event timings of fn(), after one warm-up
    (mitsuba_tpu_torch.probes.timed_ms)."""
    from mitsuba_tpu_torch.probes import timed_ms

    return timed_ms(fn, reps)


def device_ms(fn, reps=10):
    """Device time (ms) per call of fn, the host's share left out
    (mitsuba_tpu_torch.probes.device_ms)."""
    from mitsuba_tpu_torch.probes import device_ms as profiled

    return profiled(fn, reps)


def launch_counts():
    from mitsuba_tpu_torch.ops import bvh as bp
    from mitsuba_tpu_torch.ops import cluster as cp
    from mitsuba_tpu_torch.ops import exact as ep
    from mitsuba_tpu_torch.ops import intersect as ip
    from mitsuba_tpu_torch.ops import probes as pr
    from mitsuba_tpu_torch.ops import stream as sp
    from mitsuba_tpu_torch.ops import worklist as wl

    return dict(shaded_any=ip.LAUNCHES, **ip.SPLIT_LAUNCHES, **ep.LAUNCHES,
                stream=sp.LAUNCHES, **bp.LAUNCHES, **wl.LAUNCHES,
                **cp.LAUNCHES, **pr.LAUNCHES)


def reset_launch_counts():
    from mitsuba_tpu_torch.ops import bvh as bp
    from mitsuba_tpu_torch.ops import cluster as cp
    from mitsuba_tpu_torch.ops import exact as ep
    from mitsuba_tpu_torch.ops import intersect as ip
    from mitsuba_tpu_torch.ops import probes as pr
    from mitsuba_tpu_torch.ops import stream as sp
    from mitsuba_tpu_torch.ops import worklist as wl

    ip.LAUNCHES = 0
    sp.LAUNCHES = 0
    for counts in (ip.SPLIT_LAUNCHES, ep.LAUNCHES, bp.LAUNCHES, wl.LAUNCHES,
                   cp.LAUNCHES, pr.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


def _nbytes(x):
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def bound(args, outs, ops, tables=None, peak_ops=PEAK_FP32_OPS):
    """The least time (ms) the card could take for this work: the larger
    of the bytes it must move (each input read once, each output written
    once) over the memory rate and its operations over the peak rate of
    their type (float32 unless peak_ops says otherwise), with which of the
    two bounds it. tables: {argument index: bytes} for the arguments the
    work reads only in part (the entries it visits, of each only the
    floats it uses); the others count in full."""
    tables = tables or {}
    nbytes = _nbytes(outs) + sum(
        tables[i] if i in tables else _nbytes(a) for i, a in enumerate(args))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=int(ops))


def _fields(out, name="out"):
    """(name, tensor) pairs of a result: a tensor, or a dict or tuple of
    results."""
    if isinstance(out, torch.Tensor):
        return [(name, out)]
    items = out.items() if isinstance(out, dict) else (
        (f"{name}{k}", x) for k, x in enumerate(out))
    return [f for k, x in items for f in _fields(x, k)]


def mismatches(got, ref, bitwise=False):
    """Bit-for-bit comparison of two results: per field the values that
    differ (NaN equal to NaN; with `bitwise`, float32 fields by their bits,
    so -0.0 differs from +0.0), and the largest difference of the floats
    finite in both."""
    mism, max_err = {}, 0.0
    for (k, a), (_k, b) in zip(_fields(got), _fields(ref)):
        diff = a != b
        if bitwise and a.dtype == torch.float32:
            diff = a.view(torch.int32) != b.view(torch.int32)
        elif a.is_floating_point():
            diff &= ~(torch.isnan(a) & torch.isnan(b))
            fin = torch.isfinite(a) & torch.isfinite(b)
            if bool(fin.any()):
                max_err = max(max_err, float((a - b)[fin].abs().max()))
        mism[k] = int(diff.sum())
    return mism, max_err


# ---------------------------------------------------------------------------
# config 1: the brute kernel
# ---------------------------------------------------------------------------

def camera_lanes(scene, spp, seed=0):
    """The wavefront of render(): lane = pixel * spp + sample."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, \
        camera_wavefront

    return camera_wavefront(scene, PathConfig(spp=spp), seed)[0]


def kernel_inputs(scene):
    """Config-1 camera rays as bounce rays, and shadow rays from their
    first hits toward random points on the light."""
    from mitsuba_tpu_torch.core import math as m
    from mitsuba_tpu_torch.ops import intersect as ip

    ray = camera_lanes(scene, SPP1)
    n = ray.o.shape[0]
    table = ip.make_shading_table(scene.geom)
    mint, maxt = ray.mint.contiguous(), ray.maxt.contiguous()
    rec, _ = ip.closest_hit_shaded_and_any_ref(
        table, ray.o, ray.d, mint, maxt, ray.o, ray.d, mint,
        torch.full_like(maxt, -1.0))
    origin = torch.where(rec["valid"][:, None],
                         ray.at(torch.where(rec["valid"], rec["t"], 0.0)),
                         ray.o)
    light = int(scene.emitters.rec_prim[0])
    gen = torch.Generator(device=scene.device).manual_seed(0)
    u = torch.rand((n, 2), generator=gen, device=scene.device)
    su = torch.sqrt(1.0 - u[:, 0])
    g = scene.geom
    target = g.v0[light] + g.e1[light] * (1.0 - su)[:, None] \
        + g.e2[light] * (su * u[:, 1])[:, None]
    to_l = target - origin
    dist = torch.sqrt(m.dot(to_l, to_l))
    eps = m.EPSILON * torch.clamp(origin.abs().amax(dim=-1), min=1.0)
    return (table, ray.o.contiguous(), ray.d.contiguous(), mint, maxt,
            origin.contiguous(), (to_l / dist[:, None]).contiguous(),
            eps.contiguous(), (dist * (1.0 - 1e-3)).contiguous())


def _brute_kernel(name):
    """A brute kernel's wrapper, plain version, the name of the
    ops.intersect function a render calls it by, and whether each of its
    ray sets is an any-hit set (#1: bounce, then shadow)."""
    from mitsuba_tpu_torch.ops import intersect as ip

    return {
        "shaded_any": (ip.closest_hit_shaded_and_any,
                       ip.closest_hit_shaded_and_any_ref,
                       "closest_hit_shaded_and_any", (False, True)),
        "shaded": (ip.closest_hit_shaded, ip.closest_hit_shaded_ref,
                   "closest_hit_shaded", (False,)),
        "any": (ip.any_hit, ip.any_hit_ref, "any_hit", (True,)),
        "closest": (ip.closest_hit, ip.closest_hit_ref, "closest_hit",
                    (False,)),
    }[name]


def _ray_sets(name, args):
    """(o, d, mint, maxt, any_hit) of each ray set of a brute call."""
    return [(*args[1 + 4 * k:5 + 4 * k], a)
            for k, a in enumerate(_brute_kernel(name)[3])]


def _brute_ops(name):
    # the tests these inputs need: every row for a live closest lane, the
    # rows up to its first hit for a live any-hit lane
    def ops(args, _work):
        return sum(_tests_needed(args[0], *rays)
                   for rays in _ray_sets(name, args)) * MT_OPS
    return ops


def _brute_ops_all(args, _work):
    # ... every row for every lane of each ray set
    return len(args) // 4 * args[1].shape[0] * args[0].shape[0] * MT_OPS


def check_brute(name, stage, args, **kv):
    """#1 (name "shaded_any", nine arguments), #2 ("shaded"), #3 ("any")
    or #4 ("closest", five each) against its plain version, every field of
    every lane by its bits, bounded by the live lanes' tests with all
    lanes' beside."""
    kern, plain = _brute_kernel(name)[:2]
    return check_pair(name, stage, kern, plain, args,
                      tuple(range(1, len(args))), _brute_ops(name),
                      unit="lanes", bitwise=True, alt_ops=_brute_ops_all,
                      device=True, **kv)


def compare_kernel(scene):
    return check_brute("shaded_any", "config-1 camera + shadow",
                       kernel_inputs(scene))


def compare_brute_cases(device):
    """#1-#4 on tests/torch_brute_cases.py's inputs (whole warps and
    tiles dead, single live lanes, every shadow lane dead, shadow rays
    occluded by the first and by the last row, exact ties of duplicated
    rows, |det| at 1e-9 and an ulp or two either side, zero and -0.0
    direction components, live lanes with a zero direction, T = 1 to 300,
    a ragged last warp), every field of every lane by its bits: #3 on the
    shadow rays and #4 on the bounce rays, over the (T, 9) table of the
    case's first 9 columns."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_brute_cases as bc

    for name, args in bc.cases(device=device).items():
        tri = args[0][:, :9].contiguous()
        check_brute("shaded_any", f"case {name}", args, time_plain=False)
        check_brute("shaded", f"case {name}", args[:5], time_plain=False)
        check_brute("any", f"case {name}", (tri,) + args[5:9],
                    time_plain=False)
        check_brute("closest", f"case {name}", (tri,) + args[1:5],
                    time_plain=False)


def _lane_live(d, mint, maxt, still=True):
    """The lanes that need tests: mint < maxt and a direction other than
    zero (det is 0 for every row of a zero direction). still=False: the
    lanes a brute kernel without kStill tests, mint < maxt alone."""
    live = mint < maxt
    return live & (d != 0).any(dim=1) if still else live


def _rows_to_first_hit(table, o, d, mint, maxt):
    """Per lane the rows an any-hit test needs: up to its first hit, all
    when it is not occluded (a dead lane is never occluded)."""
    from mitsuba_tpu_torch.ops import intersect as ip

    n_tris = table.shape[0]
    hit = ip._mt(table, o, d, mint, maxt)[3]
    return torch.where(hit.any(dim=1),
                       hit.to(torch.int8).argmax(dim=1) + 1, n_tris)


def _tests_issued(table, o, d, mint, maxt, any_hit, still):
    """The lane tests a launch issues, 32 a warp and row it runs, by the
    kernels' schedule: each block of ip.THREADS lanes compacts its live
    lanes (`_lane_live`, `still` its kStill) in lane order, a warp runs
    only where the block has a live lane
    at its first slot or beyond, a closest warp tests every row, and an
    any-hit warp stops at the vote before a group of ip.SHADOW_GROUP rows
    once each of its live slots is occluded."""
    from mitsuba_tpu_torch.ops import intersect as ip

    n_tris = table.shape[0]
    rows = (_rows_to_first_hit(table, o, d, mint, maxt) if any_hit
            else torch.full_like(mint, n_tris, dtype=torch.long))
    live = _lane_live(d, mint, maxt, still)
    pad = (-live.numel()) % ip.THREADS
    live = torch.cat([live, live.new_zeros(pad)]).view(-1, ip.THREADS)
    rows = torch.cat([rows, rows.new_zeros(pad)]).view(-1, ip.THREADS)
    # slot of each live lane in its block, and so its warp of slots
    warp = (live.long().cumsum(dim=1) - 1) // 32 + ip.THREADS // 32 * \
        torch.arange(live.shape[0], device=live.device)[:, None]
    per_warp = torch.zeros(live.numel() // 32, dtype=torch.long,
                           device=live.device)
    per_warp.scatter_reduce_(0, warp[live], rows[live].long(), "amax")
    g = ip.SHADOW_GROUP
    return 32 * int(torch.clamp((per_warp + g - 1) // g * g,
                                max=n_tris).sum())


def _brute_liveness(name, args):
    """Lanes, live lanes (the kernel's, `_lane_live`) and the share of
    32-lane warps with no live lane of each ray set of a brute launch, the
    share of warps that test once each block's live lanes are compacted
    (the kernels' blocks of ip.THREADS lanes), and the tests the ray set
    needs (`_tests_needed`) beside those the schedule issues."""
    from mitsuba_tpu_torch.ops import intersect as ip

    still = name == "any"         # #3, the instance with kStill

    def one(o, d, mint, maxt, any_hit):
        live = _lane_live(d, mint, maxt, still)
        pad = torch.cat([live, live.new_zeros((-live.numel()) % ip.THREADS)])
        warps = pad.reshape(-1, 32).any(dim=1)
        run = (pad.reshape(-1, ip.THREADS).sum(dim=1) + 31) // 32
        return dict(live=int(live.sum()),
                    dead_warp_share=1.0 - float(warps.float().mean()),
                    compacted_warp_share=float(run.sum()) / warps.numel(),
                    tests_needed=_tests_needed(args[0], o, d, mint, maxt,
                                               any_hit),
                    tests_issued=_tests_issued(args[0], o, d, mint, maxt,
                                               any_hit, still))
    res = dict(lanes=args[1].shape[0])
    for rays in _ray_sets(name, args):
        res["shadow" if rays[-1] else "bounce"] = one(*rays)
    return res


def brute_liveness(tag, scene, cfg, render_fn, name):
    """One render of phase `tag`, recording each launch of #1 (name
    "shaded_any"), #2 ("shaded") or #3 ("any") with its arguments; each
    is then replayed alone, held against its plain version bit for bit and
    timed (a kernel_vs_plain line a launch, with its lanes, live lanes,
    dead-warp shares and tests): the ms a render of the calls (CUDA events
    around each) and of their device time alone (`device_ms`)."""
    from mitsuba_tpu_torch.ops import intersect as ip

    fn = _brute_kernel(name)[2]
    _res, calls = record_calls(ip, (fn,),
                               lambda: render_fn(scene, cfg, seed=0))
    torch.cuda.synchronize()
    sums = dict(launches=0, ms=0.0, device_ms=0.0, bound_ms=0.0,
                bound_ms_all_lanes=0.0)
    launches = []
    for k, args in enumerate(calls[fn]):
        live = _brute_liveness(name, args)
        r = check_brute(name, f"{tag} launch {k}", args, time_plain=False,
                        liveness=live)
        sums["launches"] += 1
        for key in ("ms", "device_ms", "bound_ms", "bound_ms_all_lanes"):
            sums[key] += r[key]
        launches.append(dict(live, ms=r["ms"], parent_ms=r["parent_ms"],
                             device_ms=r["device_ms"],
                             parent_device_ms=r["parent_device_ms"],
                             bound_ms=r["bound_ms"]))
    phase("brute_liveness", path=tag, kernel=name, launches=launches,
          per_render=sums, unit="ms per render, each launch replayed alone: "
          "ms CUDA events around each call, device_ms the device's time")
    return sums


# ---------------------------------------------------------------------------
# config 3: the exact-cull kernels and the stream kernel
# ---------------------------------------------------------------------------

def wavefronts(scene):
    """The camera wavefront of `render` (pixel-Morton lanes on the cluster
    backend, scanline lanes elsewhere), a first diffuse bounce from its
    hits (cosine directions around the shading normal) and that bounce's
    shadow rays toward sampled emitter points or sky directions, both
    sorted as path_trace sorts them on the cluster backend."""
    from mitsuba_tpu_torch.core import math as m
    from mitsuba_tpu_torch.core import warp
    from mitsuba_tpu_torch.emitters import sample_direct
    from mitsuba_tpu_torch.integrators.path import (
        PathConfig, _bounce_order, _perm_ray, camera_wavefront,
    )
    from mitsuba_tpu_torch.render.intersect import ray_intersect
    from mitsuba_tpu_torch.render.records import Ray

    cam = camera_wavefront(scene, PathConfig(spp=SPP3), seed=0)[0]
    its = ray_intersect(scene.geom, cam, coherent=True)
    n = cam.o.shape[0]
    gen = torch.Generator(device=scene.device).manual_seed(0)
    u = torch.rand((n, 5), generator=gen, device=scene.device)
    wo = its.to_world(warp.square_to_cosine_hemisphere(u[:, 0:2]))
    eps = m.EPSILON * torch.clamp(its.p.abs().amax(dim=-1), min=1.0)
    ok = its.valid[:, None]
    bounce = Ray(o=torch.where(ok, its.p, cam.o),
                 d=torch.where(ok, wo, cam.d), mint=eps,
                 maxt=torch.where(its.valid, float("inf"), -1.0))
    ds = sample_direct(scene.emitters, scene.geom, its.p, u[:, 2], u[:, 3:5])
    shadow = Ray(o=its.p, d=ds.d, mint=eps,
                 maxt=torch.where(its.valid & ds.valid,
                                  ds.dist * (1.0 - 1e-3), -1.0))
    if scene.geom.backend != "cluster":
        return cam, bounce, shadow
    return (cam,
            _perm_ray(bounce, _bounce_order(scene.geom, bounce)),
            _perm_ray(shadow, _bounce_order(scene.geom, shadow)))


def query_rows(geom, ray):
    """The live 128-lane rows an exact query builds for `ray`."""
    from mitsuba_tpu_torch.ops.rows import pack_rays
    from mitsuba_tpu_torch.render.intersect import _cap_root_exit

    ray = _cap_root_exit(geom, ray)
    rays = pack_rays(ray.o, ray.d, ray.mint,
                     torch.clamp(ray.maxt, max=1e30))[0]
    return rays[(rays[:, 7] >= rays[:, 6]).any(dim=1)].contiguous()


@contextlib.contextmanager
def wrapped(module, names, wrap):
    """Within the block, module.<name> is wrap(name, original) for each of
    the names; the originals come back on leaving it."""
    orig = {k: getattr(module, k) for k in names}
    try:
        for k in names:
            setattr(module, k, wrap(k, orig[k]))
        yield
    finally:
        for k in names:
            setattr(module, k, orig[k])


def record_calls(module, names, fn):
    """Run fn() once, recording the positional arguments of each call of
    module.<name> for the given names, with its keyword arguments if it
    has any; returns (fn's result, {name: [args or (args, kwargs),
    ...]})."""
    calls = {k: [] for k in names}

    def recorder(name, orig):
        def call(*args, **kw):
            calls[name].append((args, kw) if kw else args)
            return orig(*args, **kw)
        return call

    with wrapped(module, names, recorder):
        res = fn()
    return res, calls


def record_build(rays, ex, caps):
    """Run the exact build once, recording the arguments of each refine
    (S1) and child-refine (S2, S3) call."""
    from mitsuba_tpu_torch.ops import exact as ep

    (ids, blk_tn, _ovf), calls = record_calls(
        ep, ("refine", "child_refine"),
        lambda: ep.build_exact_items(rays, ex, caps))
    return calls["refine"] + calls["child_refine"], ids, blk_tn


def _cut(args, row_args, rows):
    return tuple(a[:rows].contiguous() if i in row_args else a
                 for i, a in enumerate(args))


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def check_pair(name, stage, kern, plain, args, row_args, ops_of,
               counted=False, cut=None, cutter=None, unit="rows",
               tables=None, time_plain=True, bitwise=False, alt_ops=None,
               alt_name="all_lanes", device=False, **extra):
    """Hold kernel against plain version on args, bit for bit (every
    field of every lane); time both; bound the work. row_args: the
    arguments whose leading size is the rows (or lanes) of the call.
    ops_of(args, work) -> the float32 operations these inputs need, and
    tables(args, work) -> `bound`'s table bytes, where work is what the
    plain version counted on them (if `counted`, it takes a `work` dict).
    Both run on all rows, or with `cut` on the first `cut` rows
    (cutter(args, cut), or the row_args cut). `unit` names what the rows
    are; `extra` joins the phase's line. time_plain=False: the plain
    version's time is that of its one run for the comparison. bitwise:
    float32 fields compared by their bits (mismatches). alt_ops: another
    count of the operations, reported beside as `ops_<alt_name>` with its
    `bound_ms_<alt_name>`. device: also the device time of a call, the
    host's share left out (`device_ms`), for a kernel shorter than its
    wrapper's host work, where the events time the host."""
    n_rows = args[row_args[0]].shape[0]
    work = {}
    kw = {"work": work} if counted else {}
    rows = n_rows if cut is None else min(cut, n_rows)
    part = args if rows == n_rows else (
        cutter(args, rows) if cutter else _cut(args, row_args, rows))
    ref, plain_s = _timed(lambda: plain(*part, **kw))
    got = kern(*part)
    torch.cuda.synchronize()
    mism, max_err = mismatches(got, ref, bitwise)
    ms = cuda_ms(lambda: kern(*part))
    plain_ms = cuda_ms(lambda: plain(*part),
                       reps=3 if plain_s > PLAIN_SLOW_S else 10) \
        if time_plain else plain_s * 1e3
    res = dict(kernel=name, stage=stage, rows=rows, rows_of=n_rows,
               unit=unit, values=_fields(ref)[0][1].numel(),
               mismatches=mism, max_abs_err=max_err, ms=ms,
               parent_ms=PARENT_MS.get((name, stage)),
               plain_ms=plain_ms, work=work,
               **bound(part, ref, ops_of(part, work),
                       tables(part, work) if tables else None),
               library_ms=None, **extra)
    if alt_ops:
        alt = bound(part, ref, alt_ops(part, work),
                    tables(part, work) if tables else None)
        res.update({f"ops_{alt_name}": alt["ops"],
                    f"bound_ms_{alt_name}": alt["bound_ms"]})
    if device:
        res.update(device_ms=device_ms(lambda: kern(*part)),
                   parent_device_ms=PARENT_DEVICE_MS.get((name, stage)))
    phase("kernel_vs_plain", **res)
    bad = {k: c for k, c in mism.items() if c}
    if bad:
        raise AssertionError(f"{name} ({stage}): values differ in {bad}")
    return res


def _live_lanes_per_row(rays):
    # lanes that are not dead (maxt < mint): a dead lane's key is BIG
    # whatever the box, so these inputs need no test of it
    return (~(rays[:, 7] < rays[:, 6])).sum(dim=1)


def _refine_ops(args, _work):
    # a slab test of each row's live lanes against its live entries
    return int((_live_lanes_per_row(args[0]) * args[2]).sum()) * BOX_OPS


def _refine_ops_all(args, _work):
    # ... of all 128 lanes of a row (the count before dead lanes left it)
    return int(args[2].sum()) * 128 * BOX_OPS


def _child_refine_ops(args, _work):
    # ... against the 8 children of every live parent
    return 8 * _refine_ops(args, _work)


def _child_refine_ops_all(args, _work):
    return 8 * _refine_ops_all(args, _work)


def check_refine(wave, stage, args, **kv):
    """#5 (5 arguments) or #6 against its plain version on args, by the
    bits of every key (so a zero's sign counts), with both op counts."""
    from mitsuba_tpu_torch.ops import exact as ep

    if len(args) == 5:
        return check_pair("refine", f"{wave} {stage}", ep.refine,
                          ep.refine_ref, args, (0, 1, 2), _refine_ops,
                          bitwise=True, alt_ops=_refine_ops_all,
                          width=args[1].shape[1], **kv)
    return check_pair("child_refine", f"{wave} {stage}", ep.child_refine,
                      ep.child_refine_ref, args, (0, 1, 2),
                      _child_refine_ops, tables=_child_refine_tables,
                      bitwise=True, alt_ops=_child_refine_ops_all,
                      width=args[1].shape[1], **kv)


def _walk_ops(_args, work):
    return work["box_tests"] * BOX_OPS + work["tri_tests"] * MT_OPS


def _items_ops(_args, work):
    return work["tri_tests"] * MT_OPS


def _plucker_ops(_args, work):
    return (work["box_tests"] * BOX_OPS + work["tri_tests"] * PLUCKER_OPS
            + work["tri_eligible"] * PLUCKER_ELIG_OPS)


def _plucker_row_ops(_args, work):
    # ... with the tests of the row-wide rule: every live lane of a row
    # that votes for a cluster (#14's plain version's semantics)
    return (work["box_tests"] * BOX_OPS + work["row_tests"] * PLUCKER_OPS
            + work["row_eligible"] * PLUCKER_ELIG_OPS)


def _child_refine_tables(args, _work):
    # #6: the child boxes of the distinct live parents (argument 3)
    pids, live_p = args[1], args[2]
    live = torch.arange(pids.shape[1], device=pids.device) < live_p[:, None]
    return {3: int(torch.unique(pids[live]).numel()) * CHILD_BOX_BYTES}


def _k8_tables(_args, work):
    # the triangles of the K8 clusters read, argument 0 of #7 and #9
    return {0: work["clusters_read"] * K8_BYTES}


def _l1_items_tables(_args, work):
    # #8: also the child boxes of the L1 blocks read (argument 1)
    return {0: work["clusters_read"] * K8_BYTES,
            1: work["l1_read"] * CHILD_BOX_BYTES}


def _v1_tables(_args, work):
    # #14: G, aabb and tri_start (arguments 3-5)
    return {3: work["clusters_read"] * V1_CLUSTER_BYTES,
            4: work["superclusters_read"] * 8 * V1_BOX_BYTES,
            5: work["clusters_read"] * 4}


def compare_l1_walks(ex, rays, caps, wave, any_hit):
    """#9 (v6b, at the module's step width) and #8 (v6) on the L1 lists
    of `rays`; the plain versions of #9's any-hit walk and of #8 past the
    camera rows take over a second on all rows."""
    from mitsuba_tpu_torch.ops import exact as ep

    l1_ids, l1_keys, ovf = ep.build_exact_l1(rays, ex, caps)
    kind = "any" if any_hit else "closest"
    common = dict(counted=True, overflow_rows=int(ovf.sum()), e2=caps[2])
    blm = ep.step_width(caps[2], ep.V6B_BLM)
    return {
        ("l1_masked", wave, kind): check_pair(
            "l1_masked", f"{wave} {kind}", ep.l1_masked, ep.l1_masked_ref,
            (ex["tri"], rays, l1_ids, l1_keys, any_hit, blm), (1, 2, 3),
            _items_ops, tables=_k8_tables, blm=blm,
            cut=PLAIN_CUT_ROWS if any_hit else None, **common),
        ("l1_items", wave, kind): check_pair(
            "l1_items", f"{wave} {kind}", ep.l1_items, ep.l1_items_ref,
            (ex["tri"], ex["ct0"], rays, l1_ids, l1_keys, any_hit),
            (2, 3, 4), _walk_ops, tables=_l1_items_tables,
            cut=None if wave == "camera" else PLAIN_CUT_ROWS, **common),
    }


def _check_build(wave, calls):
    """#5 and #6 on the calls of one exact build (S1, S2, S3)."""
    out = {}
    for stage, args in zip(("S1", "S2", "S3"), calls):
        r = check_refine(wave, stage, args)
        out[(r["kernel"], wave, stage)] = r
    return out


def compare_refine_xl(geom, queries):
    """#5 and #6 on the XL re-run's S1 and S2 as each query launches
    them: the calls after the query's first S1 and S2 (the re-run takes
    the query's overflowing rows, their other lanes dead, at the XL
    caps)."""
    from mitsuba_tpu_torch.ops import exact as ep

    out = {}
    for wave, query in queries:
        _res, calls = record_calls(ep, ("refine", "child_refine"), query)
        xl = calls["refine"][1:2] + calls["child_refine"][1:2]
        for stage, args in zip(("XL S1", "XL S2"), xl):
            r = check_refine(wave, stage, args)
            out[(r["kernel"], wave, stage)] = r
    return out


def compare_refine_cases(device):
    """#5 and #6 on tests/torch_refine_cases.py's inputs (whole warps
    dead, a single live lane, zero and tiny direction components, keys
    tied at -0.0 and +0.0 within and across warps, negative keys, live
    prefixes of 0, 1 and the whole list with garbage ids past them, every
    cap width and the all-L2 root table), by the bits of every key."""
    from mitsuba_tpu_torch.ops import exact as ep
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_refine_cases as rc

    for name, (kernel, args) in rc.cases(device=device).items():
        ref = (ep.refine_ref if kernel == "refine" else
               ep.child_refine_ref)(*args)
        zero = ref == 0
        check_refine("cases", name, args, time_plain=False,
                     zero_keys=int(zero.sum()),
                     negative_zero_keys=int((zero & torch.signbit(ref)).sum()))


def compare_cluster_kernels(scene):
    from mitsuba_tpu_torch.ops import exact as ep
    from mitsuba_tpu_torch.ops import stream as sp
    from mitsuba_tpu_torch.render import intersect as ri

    geom = scene.geom
    ex = geom.ex_tables
    dif, coh, _xl = geom.ex_caps
    cam, bounce, shadow = wavefronts(scene)
    out = {}
    for wave, ray, caps in (("camera", cam, coh), ("bounce", bounce, dif)):
        rays = query_rows(geom, ray)
        calls, ids, blk_tn = record_build(rays, ex, caps)
        out.update(_check_build(wave, calls))
        r = check_pair("items", f"{wave} closest", ep.items, ep.items_ref,
                       (ex["tri"], rays, ids, blk_tn, False), (1, 2, 3),
                       _items_ops, counted=True, tables=_k8_tables)
        out[("items", wave, "closest")] = r
        out.update(compare_l1_walks(ex, rays, caps, wave, False))
        if wave == "bounce":
            # #9 at the XL caps (E2 = 768, the re-run's list width)
            l1_ids, l1_keys, ovf = ep.build_exact_l1(rays, ex, _xl)
            blm = ep.step_width(_xl[2], ep.V6B_BLM)
            out[("l1_masked", wave, "closest xl")] = check_pair(
                "l1_masked", "bounce closest XL", ep.l1_masked,
                ep.l1_masked_ref,
                (ex["tri"], rays, l1_ids, l1_keys, False, blm), (1, 2, 3),
                _items_ops, counted=True, tables=_k8_tables, blm=blm,
                cut=PLAIN_CUT_ROWS, overflow_rows=int(ovf.sum()),
                e2=_xl[2])
    rays = query_rows(geom, shadow)
    calls, ids, blk_tn = record_build(rays, ex, dif)
    out.update(_check_build("shadow", calls))
    out.update(compare_refine_xl(geom, (
        ("camera", lambda: ri._cluster_closest(geom, cam, True)),
        ("bounce", lambda: ri._cluster_closest(geom, bounce, False)),
        ("shadow", lambda: ri._cluster_any(geom, shadow)))))
    out[("items", "shadow", "any")] = check_pair(
        "items", "shadow any", ep.items, ep.items_ref,
        (ex["tri"], rays, ids, blk_tn, True), (1, 2, 3), _items_ops,
        counted=True, tables=_k8_tables)
    out.update(compare_l1_walks(ex, rays, dif, "shadow", True))
    st = geom.st_tables
    for wave, ray, any_hit in (("bounce", bounce, False),
                               ("shadow", shadow, True)):
        rays = query_rows(geom, ray)
        lids, ltns = sp.build_sc_lists(rays, st["sc_bmin"], st["sc_bmax"])
        out[("stream", wave, any_hit)] = check_pair(
            "stream", f"{wave} {'any' if any_hit else 'closest'}",
            sp.stream_rows, sp.stream_rows_ref,
            (rays, lids, ltns, st["sc_tri"], any_hit), (0, 1, 2), _walk_ops,
            counted=True, cut=PLAIN_CUT_ROWS)
    return out


def compare_walk_cases(device):
    """#9 and #8 at list widths 32, 384 and 768, #7 at 96, 512 and 1,024
    and #10 at K = 32 on tests/torch_walk_cases.py's rows (whole warps
    dead, escaping or occluded early, a dead row, planted exact ties),
    closest and any."""
    from mitsuba_tpu_torch.ops import exact as ep
    from mitsuba_tpu_torch.ops import stream as sp
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_walk_cases as wc

    for any_hit in (False, True):
        kind = "any" if any_hit else "closest"
        for e2 in (32, 384, 768):
            blm = ep.step_width(e2, ep.V6B_BLM)
            check_pair(
                "l1_masked", f"cases E2 {e2} {kind}", ep.l1_masked,
                ep.l1_masked_ref,
                wc.v6b_case(e2, any_hit, device=device) + (any_hit, blm),
                (1, 2, 3), _items_ops, counted=True, tables=_k8_tables,
                blm=blm, e2=e2)
            check_pair(
                "l1_items", f"cases E2 {e2} {kind}", ep.l1_items,
                ep.l1_items_ref,
                wc.l1_case(e2, any_hit, device=device) + (any_hit,),
                (2, 3, 4), _walk_ops, counted=True,
                tables=_l1_items_tables, e2=e2)
        for e3 in (96, 512, 1024):
            check_pair(
                "items", f"cases E3 {e3} {kind}", ep.items, ep.items_ref,
                wc.items_case(e3, any_hit, device=device) + (any_hit,),
                (1, 2, 3), _items_ops, counted=True, tables=_k8_tables,
                e3=e3)
        check_pair(
            "stream", f"cases {kind}", sp.stream_rows, sp.stream_rows_ref,
            wc.stream_case(any_hit, device=device) + (any_hit,), (0, 1, 2),
            _walk_ops, counted=True)


def compare_instanced_cases(device):
    """#12 (flat and instanced, K = 32 and 8; the list's tail trimmed,
    and cut short at w_cap) and #11 (both clamps) on
    tests/torch_instanced_cases.py's inputs (dead, occluded and sentinel
    warps, a dead row, a 540-slot row, planted ties; equal t in two
    leaves, a leaf past the last triangle, zero direction components, a
    few lanes walking the whole tree), closest and any; #12 also on the
    untrimmed segments, bit for bit the same."""
    from mitsuba_tpu_torch.ops import bvh as bp
    from mitsuba_tpu_torch.ops import worklist as wl
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_instanced_cases as ic

    for any_hit in (False, True):
        kind = "any" if any_hit else "closest"
        key = "wl_any" if any_hit else "wl_closest"
        for inst in (False, True):
            for k in (32, 8):
                for end in ("tail", "overflow"):
                    c = ic.wl_case(inst, k, end, device=device)
                    args = c[:7] + (any_hit,)
                    mode = "instanced" if inst else "flat"
                    res = check_pair(
                        key, f"cases {kind} {mode} K {k} {end}", wl.wl_rows,
                        wl.wl_rows_ref, args, (4,), _wl_ops, counted=True,
                        time_plain=False)
                    full = wl.wl_rows(args[0], c[8], *args[2:])
                    if not all(torch.equal(a, b) for a, b in zip(
                            _tensors(full), _tensors(wl.wl_rows(*args)))):
                        raise AssertionError(
                            f"{key} ({res['stage']}): untrimmed differs")
        key = "bvh_any" if any_hit else "bvh_closest"
        for name, (nodes, tris, *rays) in ic.bvh_cases(
                device=device).items():
            al = bp.align_tables(nodes, tris)
            for eps in (bp.RCP_EPS, 1e-20):
                check_pair(
                    key, f"cases {kind} {name} rcp_eps {eps:g}",
                    lambda *a, k_=key, e=eps, al_=al: getattr(bp, k_)(
                        *a, rcp_eps=e, aligned=al_),
                    lambda *a, work=None, ah=any_hit, e=eps: bp.walk_ref(
                        *a, ah, rcp_eps=e, work=work),
                    (nodes, tris, *rays), (2, 3, 4, 5), _walk_ops,
                    counted=True, unit="lanes", time_plain=False,
                    rcp_eps=eps)


# ---------------------------------------------------------------------------
# config 3's triangles through the v1 cluster intersector (#14)
# ---------------------------------------------------------------------------

def _cut_tiles(args, rows):
    """The first `rows` rows (whole tiles) of a v1 launch."""
    from mitsuba_tpu_torch.ops import cluster as cp

    t = rows // cp.BM
    return (args[0][:rows].contiguous(), args[1][:t].contiguous(),
            args[2][:t].contiguous()) + args[3:]


def _v1_check(key, stage, args, **kv):
    """#14 against its plain version on args, by the bits of every field,
    bounded by the tests of lanes whose own slab passes and, beside, by
    the row-wide tests (`bound_ms_row_tests`). Built with --fmad=false,
    each operation issues alone, and PEAK_FP32_OPS counts a fused
    multiply-add as two: the float32 pipe's instruction rate caps the
    kernel at twice either bound."""
    from mitsuba_tpu_torch.ops import cluster as cp

    rec = cp.plucker_records(args[3])      # as table_dict holds them

    def kern(*a):
        return cp.cluster_rows(*a, rec=rec)
    return check_pair(key, stage, kern, cp.cluster_rows_ref,
                      args, (0,), _plucker_ops, counted=True,
                      cutter=_cut_tiles, tables=_v1_tables, bitwise=True,
                      alt_ops=_plucker_row_ops, alt_name="row_tests",
                      **kv)


def compare_cluster_v1(cl, waves):
    """#14, closest on the camera and bounce wavefronts and any on the
    shadow rays, with the arguments cluster_closest and cluster_any
    launch it with (the first PLAIN_CUT_ROWS rows), with the live lanes
    of the rows compared."""
    from mitsuba_tpu_torch.ops import cluster as cp

    out = {}
    for wave, ray, any_hit in waves:
        key = "cluster_any" if any_hit else "cluster_closest"
        stage = f"{wave} {'any' if any_hit else 'closest'}"
        args, _n = cp.launch_args(cl, *_ray_args(ray), any_hit)
        part = _cut_tiles(args, PLAIN_CUT_ROWS)
        out[(key, wave)] = _v1_check(
            key, stage, args, cut=PLAIN_CUT_ROWS,
            live_lanes=int(_live_lanes_per_row(part[0]).sum()),
            listed=float(args[2].float().mean()),
            superclusters=int(cl["G"].shape[0]))
    return out


def compare_v1_cases(device):
    """#14 on tests/torch_v1_cases.py's inputs (six superclusters, rows of
    one tile voting differently, dead and occluded rows, lists of length
    0 and C_s, ties within and across clusters, maxt = inf through
    launch_args, the miss sentinel), closest and any, bit for bit."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_v1_cases as vc

    for any_hit, variant in ((False, {}), (True, {}),
                             (False, {"inf": True}), (True, {"inf": True}),
                             (False, {"sentinel": True}),
                             (False, {"seed": 1}), (True, {"seed": 1})):
        key = "cluster_any" if any_hit else "cluster_closest"
        stage = "cases {} {}".format(
            "any" if any_hit else "closest",
            " ".join(f"{k} {v}" for k, v in variant.items()) or "seed 0")
        args = vc.args(any_hit=any_hit, device=device, **variant)
        _v1_check(key, stage, args, time_plain=False,
                  live_lanes=int(_live_lanes_per_row(args[0]).sum()))


def cluster_v1_phase(scene, cl, cam, shadow):
    """The v1 entry points on config 3's camera rays (closest) and shadow
    rays (any), every launch count set to 0 just before and read just
    after; their hits held against the exact-cull path's."""
    from mitsuba_tpu_torch.ops import cluster as cp
    from mitsuba_tpu_torch.render import intersect as ri

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t, _u, _v, prim, valid = cp.cluster_closest(cl, *_ray_args(cam))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    occ = cp.cluster_any(cl, *_ray_args(shadow))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = launch_counts()
    te, _ue, _ve, pe, ve = ri._closest(scene.geom, cam, coherent=True)
    occ_e = ri.ray_test(scene.geom, shadow)
    n = valid.numel()
    both = valid & ve
    same = both & (prim == pe)
    t_ok = same & torch.isclose(t, te, rtol=V1_T_RTOL, atol=1e-5)
    res = dict(lanes=n, hit_lanes=int(valid.sum()),
               valid_agree=float((valid == ve).float().mean()),
               prim_agree=float(same.sum()) / max(1, int(both.sum())),
               t_agree=float(t_ok.sum()) / max(1, int(same.sum())),
               t_rtol=V1_T_RTOL,
               occluded=int(occ.sum()),
               occ_agree=float((occ == occ_e).float().mean()),
               closest_seconds=t1 - t0, any_seconds=t2 - t1,
               launches={k: launches[k] for k in cp.LAUNCHES},
               superclusters=int(cl["G"].shape[0]))
    phase("cluster_v1", **res)
    if not (torch.isfinite(t[valid]).all() and bool((prim[valid] >= 0).all())):
        raise AssertionError("cluster_v1: non-finite or negative hits")
    for k in ("valid_agree", "prim_agree", "t_agree", "occ_agree"):
        if not res[k] >= V1_AGREE_MIN:
            raise AssertionError(f"cluster_v1: {k} {res[k]}")
    for k, c in res["launches"].items():
        if c < 1:
            raise AssertionError(f"cluster_v1: kernel {k} was never launched")
    return res["launches"]


# ---------------------------------------------------------------------------
# the bvh and instanced paths: the BVH kernel and the work-list kernel
# ---------------------------------------------------------------------------

def _ray_args(ray):
    return tuple(x.contiguous() for x in (ray.o, ray.d, ray.mint, ray.maxt))


def compare_bvh_kernels(scene):
    """The BVH kernel, closest and any, on the bvh path's wavefronts."""
    from mitsuba_tpu_torch.ops import bvh as bp

    g = scene.geom
    cam, bounce, shadow = wavefronts(scene)
    out = {}
    for wave, ray, any_hit in (("camera", cam, False),
                               ("bounce", bounce, False),
                               ("shadow", shadow, True)):
        key = "bvh_any" if any_hit else "bvh_closest"
        tabs, kw = g.bvh_tables
        args = tabs + _ray_args(ray)
        out[(key, wave)] = check_pair(
            key, f"{wave} {'any' if any_hit else 'closest'}",
            lambda *a, k_=key: getattr(bp, k_)(*a, **kw),
            lambda *a, work=None, ah=any_hit: bp.walk_ref(*a, ah, work=work),
            args, (2, 3, 4, 5), _walk_ops, counted=True, unit="lanes")
    return out


def worklist_chunk(geom, ray):
    """The first row chunk of a work-list query of `ray`, as wl_closest
    and wl_any build it: the arguments of one kernel launch (items, row
    segments ending at the list's last used slot, the blocks, the rays
    and, instanced, block ids and maps), the chunk's overflow flags, and
    the untrimmed segments (the last row's run ending at w_cap)."""
    from mitsuba_tpu_torch.ops import worklist as wl
    from mitsuba_tpu_torch.ops.rows import pack_rays

    rays = pack_rays(ray.o, ray.d, ray.mint,
                     torch.clamp(ray.maxt, max=1e30))[0]
    ry = rays[:wl.MAX_ITEMS_PER_CALL // wl.W_FACTOR].contiguous()
    tab = geom.wl_tables
    items, total, ovf = wl.build_worklist(
        ry, tab["bmin"], tab["bmax"], tab["sc_bmin"], tab["sc_bmax"],
        ry.shape[0] * wl.W_FACTOR, wl.L_SC, wl.BEAM_S2)
    full = wl.row_segments(items, ry.shape[0])
    return (items, wl.row_segments(items, ry.shape[0], total), tab["tri"],
            tab["tri_start"], ry, tab.get("block_id"),
            tab.get("xform")), ovf, full


def _cut_chunk(args, rows):
    items, seg = args[0], args[1]
    return (items[:int(seg[rows])].contiguous(),
            seg[:rows + 1].contiguous()) + args[2:4] + (
        args[4][:rows].contiguous(),) + args[5:]


def _wl_ops(args, work):
    visit = XFORM_OPS if args[5] is not None else 0
    if not args[7]:
        visit += BOX_OPS               # closest: the can-improve slab test
    return work["visits"] * visit + work["tri_tests"] * MT_OPS


def compare_worklist_kernels(scene, flat):
    """The work-list kernel, closest and any, instanced on the instanced
    path's wavefronts and flat on the same rays against `flat` (the same
    spheres baked into world space); then the BVH kernel as the path's
    overflow fallback, on the launches its first bounce makes."""
    from mitsuba_tpu_torch.ops import bvh as bp
    from mitsuba_tpu_torch.ops import worklist as wl
    from mitsuba_tpu_torch.render import intersect as ri

    cam, bounce, shadow = wavefronts(scene)
    out = {}
    for wave, ray, any_hit in (("camera", cam, False),
                               ("bounce", bounce, False),
                               ("shadow", shadow, True)):
        key = "wl_any" if any_hit else "wl_closest"
        for mode, geom in (("instanced", scene.geom), ("flat", flat.geom)):
            args, ovf, _full = worklist_chunk(geom, ray)
            out[(key, wave, mode)] = check_pair(
                key, f"{wave} {'any' if any_hit else 'closest'} {mode}",
                wl.wl_rows, wl.wl_rows_ref, args + (any_hit,), (4,), _wl_ops,
                counted=True, cut=PLAIN_CUT_ROWS, cutter=_cut_chunk,
                overflow_rows=int(ovf.sum()))
    _res, calls = record_calls(bp, ("bvh_closest", "bvh_any"), lambda: (
        ri.ray_intersect(scene.geom, bounce), ri.ray_test(scene.geom, shadow)))
    # the static triangles' walk at the kernel's clamp, and the instance
    # walks at the reference walk's (keyword rcp_eps)
    static = {k: [c for c in v if "rcp_eps" not in c[1]]
              for k, v in calls.items()}
    inst = {k: [c for c in v if "rcp_eps" in c[1]]
            for k, v in calls.items()}
    phase("fallback_calls", **{f"{k}_{w}": len(c[k])
                               for w, c in (("static", static),
                                            ("instances", inst))
                               for k in c})
    for key, any_hit in (("bvh_closest", False), ("bvh_any", True)):
        kind = "any" if any_hit else "closest"
        for args, kw in static[key][:1]:
            out[(key, "fallback")] = check_pair(
                key, f"fallback {kind}",
                lambda *a, k=key, kw_=kw: getattr(bp, k)(*a, **kw_),
                lambda *a, work=None, ah=any_hit: bp.walk_ref(
                    *a, ah, work=work),
                args, (2, 3, 4, 5), _walk_ops, counted=True, unit="lanes")
        for args, kw in inst[key][:1]:
            eps = kw["rcp_eps"]
            out[(key, "instances")] = check_pair(
                key, f"instance walk {kind}",
                lambda *a, k=key, kw_=kw: getattr(bp, k)(*a, **kw_),
                lambda *a, work=None, ah=any_hit, e=eps: bp.walk_ref(
                    *a, ah, rcp_eps=e, work=work),
                args, (2, 3, 4, 5), _walk_ops, counted=True,
                cut=None if any_hit else PLAIN_CUT_LANES,
                cutter=_live_lanes, unit="lanes", rcp_eps=eps)
    return out


def _live_lanes(args, n):
    """The first n live lanes (maxt >= mint) of a fallback call: its
    overflow lanes; the others are dead."""
    idx = torch.nonzero(args[5] >= args[4])[:n, 0]
    return args[:2] + tuple(a[idx].contiguous() for a in args[2:])


def compare_worklist_full_chunks(scene, waves):
    """#12 on a whole row chunk of the instanced path's wavefronts, the
    last row included: the kernel on the segments that end at the list's
    last used slot, and again on the untrimmed ones (the last row's run
    ending at w_cap), each bit for bit against the plain version on the
    trimmed segments (the plain version walks the untrimmed tail slot by
    slot, far too slowly: tests/test_torch_worklist_trim.py holds it
    equal on both); the plain version run once, the kernel timed on
    both."""
    from mitsuba_tpu_torch.ops import worklist as wl

    out = {}
    for wave, ray, any_hit in waves:
        key = "wl_any" if any_hit else "wl_closest"
        kind = "any" if any_hit else "closest"
        stage = f"{wave} {kind} instanced full chunk"
        args, ovf, full = worklist_chunk(scene.geom, ray)
        kargs = args + (any_hit,)
        uargs = (args[0], full) + args[2:] + (any_hit,)
        work = {}
        ref, plain_s = _timed(lambda: wl.wl_rows_ref(*kargs, work=work))
        got = wl.wl_rows(*kargs)
        got_full = wl.wl_rows(*uargs)
        torch.cuda.synchronize()
        mism, max_err = mismatches(got, ref)
        mism_full, _e = mismatches(got_full, ref)
        n = args[4].shape[0]
        res = dict(kernel=key, stage=stage, rows=n, rows_of=n, unit="rows",
                   values=_fields(ref)[0][1].numel(), mismatches=mism,
                   mismatches_untrimmed=mism_full, max_abs_err=max_err,
                   ms=cuda_ms(lambda: wl.wl_rows(*kargs)),
                   untrimmed_ms=cuda_ms(lambda: wl.wl_rows(*uargs)),
                   parent_ms=PARENT_MS.get((key, stage)),
                   plain_ms=plain_s * 1e3, plain_runs=1, work=work,
                   slots=int(args[0].shape[0]),
                   last_row_slots=int(args[1][-1] - args[1][-2]),
                   last_row_slots_untrimmed=int(full[-1] - full[-2]),
                   overflow_rows=int(ovf.sum()),
                   **bound(kargs, ref, _wl_ops(kargs, work)),
                   library_ms=None)
        phase("kernel_vs_plain", **res)
        bad = {k: c for m in (mism, mism_full) for k, c in m.items() if c}
        if bad:
            raise AssertionError(f"{key} ({stage}): values differ in {bad}")
        out[(key, wave)] = res
    return out


def replay_launches(tag, scene, cfg, reps=5):
    """One render recording each launch of #11 (static triangles, or the
    instance walks: the reference walk's clamp, keyword rcp_eps) and of
    #12 with its arguments and its list's `total`; then each launch
    replayed alone on its arguments and timed (CUDA events, median of
    `reps`): the device ms a render spends in each, and #12's on the
    segments the render ran, trimmed at the list's last used slot and
    untrimmed (bit for bit the same outputs), so that its unused-slot
    tail is separated from its walk. Also each launch's rows or lanes,
    live lanes and share of warps with no live lane."""
    from mitsuba_tpu_torch.integrators.path import render
    from mitsuba_tpu_torch.ops import bvh as bp
    from mitsuba_tpu_torch.ops import worklist as wl

    calls = {"bvh_closest": [], "bvh_any": [], "wl_rows": [],
             "build_worklist": []}

    def recorder(name, orig):
        def call(*args, **kw):
            res = orig(*args, **kw)
            calls[name].append((args, kw, res if name == "build_worklist"
                                else None))
            return res
        return call

    with wrapped(bp, ("bvh_closest", "bvh_any"), recorder), \
            wrapped(wl, ("wl_rows", "build_worklist"), recorder):
        render(scene, cfg, seed=0)
    torch.cuda.synchronize()
    sums, launches = {}, []

    def add(cls, ms, **kv):
        acc = sums.setdefault(cls, dict(launches=0, ms=0.0))
        acc["launches"] += 1
        acc["ms"] += ms
        for k, x in kv.items():
            acc[k] = acc.get(k, 0.0) + x

    for name in ("bvh_closest", "bvh_any"):
        fn = getattr(bp, name)
        for args, kw, _ in calls[name]:
            if args[2].shape[0] == 0:
                continue
            cls = f"{name} {'instance walk' if 'rcp_eps' in kw else 'walk'}"
            ms = cuda_ms(lambda: fn(*args, **kw), reps)
            add(cls, ms)
            live = args[5] >= args[4]
            warps = torch.cat([live, live.new_zeros((-live.numel()) % 32)]
                              ).reshape(-1, 32).any(dim=1)
            launches.append(dict(
                kernel=cls, lanes=live.numel(), live_lanes=int(live.sum()),
                dead_warp_share=1.0 - float(warps.float().mean()), ms=ms))
    builds = [c[2] for c in calls["build_worklist"]]
    for (args, _kw, _), (items, total, _ovf) in zip(calls["wl_rows"],
                                                     builds):
        any_hit = bool(args[7])
        cls = "wl_any" if any_hit else "wl_closest"
        rays = args[4]
        full = wl.row_segments(items, rays.shape[0])
        trim = wl.row_segments(items, rays.shape[0], total)
        a_full = (items, full) + tuple(args[2:])
        a_trim = (items, trim) + tuple(args[2:])
        same = all(torch.equal(x, y) for x, y in zip(
            _tensors(wl.wl_rows(*a_full)), _tensors(wl.wl_rows(*a_trim))))
        if not same:
            raise AssertionError(f"{tag}: {cls} differs on trimmed segments")
        ms = cuda_ms(lambda: wl.wl_rows(*args), reps)
        ms_full = cuda_ms(lambda: wl.wl_rows(*a_full), reps)
        ms_trim = cuda_ms(lambda: wl.wl_rows(*a_trim), reps)
        add(cls, ms, ms_untrimmed=ms_full, ms_trimmed=ms_trim,
            tail_slots=int(full[-1] - trim[-1]))
        live = rays[:, 6] <= rays[:, 7]
        warps = live.reshape(rays.shape[0], -1, 32).any(dim=2)
        launches.append(dict(
            kernel=cls, rows=rays.shape[0], live_lanes=int(live.sum()),
            dead_warp_share=1.0 - float(warps.float().mean()),
            slots=int(items.shape[0]), total=int(total), ms=ms,
            ms_untrimmed=ms_full, ms_trimmed=ms_trim))
    phase("launch_replay", path=tag, unit="device ms per render (CUDA "
          "events, each launch replayed alone)", reps=reps, per_render=sums,
          launches=launches)
    return sums


# ---------------------------------------------------------------------------
# fog: the split brute kernels #2, #3 and #4
# ---------------------------------------------------------------------------

def fog_wavefronts(scene, cfg):
    """The arguments of the fog render's second-bounce launches of #2 and
    #3: its bounce rays over the (T, 29) table and the NEE shadow rays
    of the same bounce over the (T, 9) table."""
    from mitsuba_tpu_torch.integrators.volpath import render_volpath
    from mitsuba_tpu_torch.media import make_homogeneous
    from mitsuba_tpu_torch.ops import intersect as ip

    _res, calls = record_calls(
        ip, ("closest_hit_shaded", "any_hit"),
        lambda: render_volpath(scene, make_homogeneous(**FOG), cfg, seed=0))
    return calls["closest_hit_shaded"][1], calls["any_hit"][1]


def _tests_needed(table, o, d, mint, maxt, any_hit):
    """Triangle tests these rays need: every triangle for a live closest
    lane; for a live any-hit lane the triangles up to its first hit (all
    when unoccluded); none for a lane that can never hit (maxt <= mint:
    no t lies between; a zero direction: det is 0 for every row)."""
    live = _lane_live(d, mint, maxt)
    if not any_hit:
        return int(live.sum()) * table.shape[0]
    return int(torch.where(
        live, _rows_to_first_hit(table, o, d, mint, maxt), 0).sum())


def compare_split_kernels(scene, cfg):
    """#2, #3 and #4 on the fog render's second bounce: #2 and #4 on its
    bounce rays, #3 on its NEE shadow rays, with their lanes, live lanes
    and tests."""
    shaded_args, any_args = fog_wavefronts(scene, cfg)
    closest_args = (scene.geom.brute_tables[1],) + tuple(shaded_args[1:])
    return {name: check_brute(name, stage, args,
                              liveness=_brute_liveness(name, args))
            for name, stage, args in (
                ("shaded", "fog bounce 1 closest", shaded_args),
                ("any", "fog bounce 1 NEE shadow", any_args),
                ("closest", "fog bounce 1 closest", closest_args))}


# ---------------------------------------------------------------------------
# the probes: #13 and the cost probes of csrc/probes.cu (#15)
# ---------------------------------------------------------------------------

def _probe_inputs(device):
    """Seeded inputs of the probe checks, at the scripts' shapes."""
    rng = np.random.default_rng(0)

    def t(x, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(x, dtype), device=device)

    n = PROBE_ITEMS
    return dict(
        counter=torch.zeros(1, dtype=torch.int32, device=device),
        ids=t(rng.integers(0, 64, n), np.int32),
        flags=t(rng.integers(0, 2, n), np.int32),
        g={kb: t(rng.standard_normal((64, kb * 16, 16))) for kb in (8, 32)},
        tri_grid=t(rng.standard_normal((2048, 4, 128))),
        grid_ids=t(rng.integers(0, 2048, n), np.int32),
        fma_a=t(rng.random((8, 128)) * 0.1 + 0.9),
        fma_b=t(rng.random((8, 128)) * 1e-6),
        tri={k: t(rng.random((k, 16))) for k in (128, 32)},
        rays=t(rng.random((8, 128))),
        mm={(m, k): (t(rng.standard_normal((m, k))),
                     t(rng.standard_normal((k, 128))))
            for m, k in ((4096, 10), (512, 128))},
        table=t(rng.random(32768)),
        idx=t(rng.integers(0, 32768, 1 << 20), np.int32))


def _distinct(ids, nbytes):
    return int(torch.unique(ids).numel()) * nbytes


def _cut_probe_list(args, rows):
    items, seg, tri, rays = args
    return (items[:int(seg[rows])].contiguous(), seg[:rows + 1].contiguous(),
            tri, rays[:rows].contiguous())


def _probe_list_work(args):
    """#13's valid items and the distinct cluster blocks they fetch."""
    from mitsuba_tpu_torch.ops import worklist as wl

    items = args[0]
    valid = items[(items & wl._VALID_BIT) != 0]
    return int(valid.numel()), valid & (wl._FIRST_BIT - 1)


def check_within(name, stage, kern, plain, args, ops, judge, peak_ops,
                 **extra):
    """Hold kernel against plain version within a tolerance: judge(got,
    ref) -> {"ok": bool, ...the measures it gates}; time both, bound the
    work at the operations' own peak rate."""
    ref, plain_s = _timed(lambda: plain(*args))
    got = kern(*args)
    torch.cuda.synchronize()
    verdict = judge(got, ref)
    mism, max_err = mismatches(got, ref)
    ms = cuda_ms(lambda: kern(*args))
    plain_ms = cuda_ms(lambda: plain(*args),
                       reps=3 if plain_s > PLAIN_SLOW_S else 10)
    res = dict(kernel=name, stage=stage, mismatches=mism,
               max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               **bound(args, ref, ops, peak_ops=peak_ops), library_ms=None,
               **verdict, **extra)
    phase("kernel_vs_plain", **res)
    if not verdict["ok"]:
        raise AssertionError(f"{name} ({stage}): outside its tolerance "
                             f"{verdict}")
    return res


def _tc_judge(kind):
    from mitsuba_tpu_torch.ops import probes as pr

    tol = pr.TOLERANCE[f"mm_{kind}"]

    def judge(got, ref):
        errs = [pr.rel_err(a, b.expand_as(a)) for a, b in zip(got, ref)]
        return dict(ok=max(errs) <= tol, rel_err=errs, tolerance=tol)
    return judge


def _packed_judge(name):
    """V4: accepts bit for bit, sums within TOLERANCE; V2: accepts on all
    but V2_HITS_DIFFER_MAX of the entries, sums within TOLERANCE there."""
    from mitsuba_tpu_torch.ops import probes as pr

    tol = pr.TOLERANCE[name]

    def judge(got, ref):
        same = got[1][0] == ref[1]
        share = float(same.float().mean())
        err = pr.rel_err(got[0][0][same], ref[0][same])
        need = 1.0 if name == "v4" else 1.0 - pr.V2_HITS_DIFFER_MAX
        return dict(ok=share >= need and err <= tol, accepts_equal=share,
                    accepts_equal_min=need, rel_err=err, tolerance=tol)
    return judge


def compare_probes(device, case):
    """Each probe kernel against its plain version on the card, at step
    counts where the plain version takes well under a second; #13 on the
    first 1,024 rows of config 3's work list (r3_kernel's list)."""
    from mitsuba_tpu_torch.ops import probes as pr
    from mitsuba_tpu_torch.ops import worklist as wl
    from mitsuba_tpu_torch.ops.rows import pack_rays

    x = _probe_inputs(device)
    n, on = PROBE_ITEMS, int((x["flags"] > 0).sum())
    out = {}

    def exact(key, name, stage, kern, plain, args, ops, tables=None,
              unit="items"):
        out[key] = check_pair(name, stage, kern, plain, args, (0,),
                              lambda _a, _w: ops,
                              tables=(lambda _a, _w: tables) if tables
                              else None, unit=unit)
        out[key]["device_ms"] = device_ms(lambda: kern(*args))

    exact("count", "count", "64 launches", pr.count, pr.count_ref,
          (x["counter"], 64), 0, unit="launches")
    exact("gate", "gate", f"{n} items, {on} open", pr.gate, pr.gate_ref,
          (x["g"][32], x["ids"], x["flags"]), on * 8 * 16,
          {0: _distinct(x["ids"][x["flags"] > 0], 8 * 16 * 4)})
    for kb in (8, 32):
        exact(("rotate", kb), "rotate", f"{n} items, {kb} KB", pr.rotate,
              pr.rotate_ref, (x["g"][kb], x["ids"]), n * 8 * 16,
              {0: _distinct(x["ids"], kb * 1024)})
    for fetch in (False, True):
        exact(("grid", fetch), "grid", f"{n} items, fetch {fetch}", pr.grid,
              pr.grid_ref, (x["tri_grid"], x["grid_ids"], fetch), n * 128,
              {0: _distinct(x["grid_ids"] if fetch else x["grid_ids"][:1],
                            2048)})
    exact("fma", "fma", "512 FMA x 1 step", pr.fma, pr.fma_ref,
          (x["fma_a"], x["fma_b"], 512, 1), 2 * 512 * 1024, unit="rows")
    exact("mt", "mt", "128 triangles x 2 steps", pr.mt, pr.mt_ref,
          (x["tri"][128], x["rays"], 2), MT_OPS * 128 * 128 * 2)
    exact("v0", "v0", "4 reps", pr.v0, pr.v0_ref, (x["rays"], 4),
          2 * 8 * 4 * 8 * 128 * 4, unit="rows")
    exact("v1", "v1", "32 triangles x 4 reps", pr.v1, pr.v1_ref,
          (x["tri"][32], x["rays"], 4), MT_OPS * 32 * 128 * 4)
    for name in ("v2", "v4"):
        out[name] = check_within(
            name, "32 triangles x 4 reps", getattr(pr, name),
            lambda t, r, n_, d=name == "v4": pr.packed_ref(t, r, n_, d),
            (x["tri"][32], x["rays"], 4), MT_OPS * 32 * 128 * 4,
            _packed_judge(name), PEAK_FP32_OPS)
        out[name]["device_ms"] = device_ms(
            lambda n_=name: getattr(pr, n_)(x["tri"][32], x["rays"], 4))
    G, M = x["mm"][(4096, 10)]
    exact("mm_cuda", "mm_cuda", "(4096, 10) x (10, 128), 1 step",
          pr.mm_cuda, pr.mm_cuda_ref, (G, M, 1), 2 * 4096 * 10 * 128,
          unit="rows")
    for (m, k), (G, M) in x["mm"].items():
        for kind in ("tf32", "bf16"):
            out[(f"mm_{kind}", m, k)] = check_within(
                f"mm_{kind}", f"({m}, {k}) x ({k}, 128), 1 step",
                lambda g_, m_, s_, kd=kind: pr.mm_tc(g_, m_, s_, kd),
                lambda g_, m_, s_, kd=kind: pr.mm_tc_ref(g_, m_, s_, kd),
                (G, M, 1), 2 * m * k * 128, _tc_judge(kind),
                PEAK_TC_OPS[kind])
            out[(f"mm_{kind}", m, k)]["device_ms"] = device_ms(
                lambda g_=G, m_=M, kd=kind: pr.mm_tc(g_, m_, 1, kd))
    for name in ("gather_smem", "gather_global"):
        exact(name, name, "K 32,768, N 2^20", getattr(pr, name),
              pr.gather_ref, (x["table"], x["idx"]), 0, unit="lanes")

    tab, o, d, mint, maxt = case
    rays = pack_rays(o, d, mint, torch.clamp(maxt, max=1e30))[0]
    items, _total, ovf = wl.build_worklist(
        rays, tab["bmin"], tab["bmax"], tab["sc_bmin"], tab["sc_bmax"],
        rays.shape[0] * wl.PROBE_W_FACTOR, wl.PROBE_L_SC, wl.BEAM_S2)
    k_cl = tab["tri"].shape[1]

    def list_ops(args, _w):
        return _probe_list_work(args)[0] * 128 * (BOX_OPS + 2)

    def list_tables(args, _w):
        return {2: _distinct(_probe_list_work(args)[1], k_cl * 16 * 4)}

    args = (items, wl.row_segments(items, rays.shape[0]), tab["tri"], rays)
    out["wl_probe"] = check_pair(
        "wl_probe", "config 3 camera list", wl.wl_probe_rows,
        wl.wl_probe_ref, args, (3,), list_ops, cut=PLAIN_CUT_ROWS,
        cutter=_cut_probe_list, tables=list_tables,
        overflow_rows=int(ovf.sum()))
    part = _cut_probe_list(args, PLAIN_CUT_ROWS)
    out["wl_probe"]["device_ms"] = device_ms(
        lambda: wl.wl_probe_rows(*part))
    # #13 on tests/torch_instanced_cases.py's flat lists (a dead row, a
    # row with no valid item, a 540-slot row with an invalid slot, lists
    # with an unused tail and cut short), and on the untrimmed segments
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_instanced_cases as ic

    for k in (32, 8):
        for end in ("tail", "overflow"):
            c = ic.wl_case(False, k, end, device=device)
            check_pair("wl_probe", f"cases flat K {k} {end}",
                       wl.wl_probe_rows, wl.wl_probe_ref,
                       (c[0], c[1], c[2], c[4]), (3,), list_ops,
                       time_plain=False, bitwise=True)
            if not torch.equal(wl.wl_probe_rows(c[0], c[8], c[2], c[4]),
                               wl.wl_probe_rows(c[0], c[1], c[2], c[4])):
                raise AssertionError(f"wl_probe (K {k} {end}): untrimmed "
                                     "differs")
    phase("probe_device_ms", unit="ms per call, the checks' inputs",
          **{str(k): r["device_ms"] for k, r in out.items()
             if "device_ms" in r})
    return out


def probes_phase(device, case):
    """The five probe drivers at the scripts' sizes, every launch count
    set to 0 just before and read just after: one line per probe."""
    from mitsuba_tpu_torch.ops import probes as pr
    from mitsuba_tpu_torch.probes import (
        kernel_cost, r3_kernel, r3_mt, r3_refinebits, r5_megakernel,
    )

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lines = []
    for mod, kw in ((kernel_cost, {}), (r3_kernel, {"case": case}),
                    (r3_mt, {}), (r3_refinebits, {}), (r5_megakernel, {})):
        lines += mod.run(device, **kw)
    torch.cuda.synchronize()
    launches = launch_counts()
    for ln in lines:
        phase("probe", **ln)
    phase("probes", seconds=time.perf_counter() - t0, lines=len(lines),
          launches={k: launches[k]
                    for k in list(pr.LAUNCHES) + ["wl_probe", "refine"]})
    for k in list(pr.LAUNCHES) + ["wl_probe", "refine"]:
        if launches[k] < 1:
            raise AssertionError(f"probes: kernel {k} was never launched")
    for ln in lines:
        ms = ln.get("ms")
        if ms is not None and not all(np.isfinite(v) and v > 0
                                      for v in np.atleast_1d(ms)):
            raise AssertionError(f"probes: bad times in {ln}")
    return launches


def library_phase(device):
    """The library yardsticks, timed here only: one torch.matmul on each
    product's shapes (float32, TF32, bf16) and table[idx] on the
    gathers'."""
    x = _probe_inputs(device)
    res = {}

    def both(key, fn):
        res[key] = cuda_ms(fn)
        res[f"{key}_device"] = device_ms(fn)

    mm = dict(x["mm"])
    mm[(512, 10)] = (x["mm"][(4096, 10)][0][:512].contiguous(),
                     x["mm"][(4096, 10)][1])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        for (m, k), (G, M) in mm.items():
            torch.backends.cuda.matmul.allow_tf32 = False
            both(f"matmul_fp32_{m}x{k}", lambda: torch.matmul(G, M))
            torch.backends.cuda.matmul.allow_tf32 = True
            both(f"matmul_tf32_{m}x{k}", lambda: torch.matmul(G, M))
            gb, mb = G.bfloat16(), M.bfloat16()
            both(f"matmul_bf16_{m}x{k}", lambda: torch.matmul(gb, mb))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    rng = np.random.default_rng(0)
    for k in (512, 2048, 8192, 32768):
        table = torch.as_tensor(rng.random(k).astype(np.float32),
                                device=device)
        idx = torch.as_tensor(rng.integers(0, k, 1 << 20).astype(np.int32),
                              device=device)
        both(f"gather_{k}", lambda: table[idx])
    phase("library", unit="ms per call: CUDA events; _device: device time "
          "(probes.device_ms)", **res)
    return res


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

def golden_gate(tag, scene, golden, also=None, cfg=None, render_fn=None,
                band=None, block=8, limit=GOLDEN_REL_RMSE_MAX):
    """64x64, 16 spp, depth 5, seed 0 (bench.py validate_golden), gated
    on `golden` (a path under the repo): the relative RMSE of the
    block x block means at most `limit`; `also` is a second golden whose
    distance is reported, not gated. cfg: another PathConfig; render_fn:
    another renderer (scene, cfg, seed) -> (image, aux); band: the image
    mean's band, gated when given."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, render

    cfg = cfg or PathConfig(max_depth=5, spp=16)
    img, _ = (render_fn or render)(scene, cfg, seed=0)
    img = img.cpu().numpy()

    def blocks(a):
        h, w, c = a.shape
        return a.reshape(h // block, block, w // block, block,
                         c).mean(axis=(1, 3))

    def rel_rmse(path):
        ref = np.load(os.path.join(ROOT, path))["mean"]
        rb, ib = blocks(ref), blocks(img)
        return (float(np.sqrt(np.mean((ib - rb) ** 2))
                      / max(rb.mean(), 1e-9)), float(ref.mean()))

    rel, ref_mean = rel_rmse(golden)
    extra = {}
    if also is not None:
        extra = dict(zip(("also_rel_rmse", "also_mean"), rel_rmse(also)),
                     also=also)
    mean = float(img.mean())
    phase(tag, golden=golden, spp=cfg.spp, sort_rays=cfg.sort_rays,
          block=block, rel_rmse=rel, limit=limit, mean=mean,
          golden_mean=ref_mean, band=band,
          finite=bool(np.isfinite(img).all()), **extra)
    if not rel <= limit or not np.isfinite(img).all():
        raise AssertionError(f"{tag}: rel RMSE {rel} > {limit}")
    if band is not None and not band[0] < mean < band[1]:
        raise AssertionError(f"{tag}: mean {mean} outside {band}")


def device_profile(fn):
    """Device busy time (ms) of one call of fn under torch.profiler (the
    sum of its CUDA kernels' times), its wall time (ms), and the kernels
    taking the most device time. Only the device is traced: the host's
    operator events would multiply the trace (and the time to read it)
    several times over on the paths with hundreds of thousands of
    launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # each kernel's device time and launches, summed by name over the
    # trace's device events (what key_averages gives for them, without
    # the event object it builds a record, which takes longer than the
    # profiled call itself on the paths of 10^5 launches)
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        a = acc.setdefault(e.name(), [0, 0])
        a[0] += e.duration_ns()
        a[1] += 1
    rows = sorted(((ns / 1e6, k, c) for k, (ns, c) in acc.items() if ns > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    # the port's own kernels (csrc/*.cu, in no namespace), by function
    # name: their device ms and launches in this call, and a templated
    # kernel's by instantiation (#9, #10: <false> closest, <true> any)
    own = {}
    for ms, k, c in rows:
        name = k.replace("void ", "").split("(")[0].strip()
        base = name.split("<")[0].strip()
        if base.endswith("_kernel") and "::" not in base:
            acc = own.setdefault(base, dict(ms=0.0, calls=0))
            acc["ms"] += ms
            acc["calls"] += c
            if name != base:
                inst = acc.setdefault("instances", {}).setdefault(
                    name[len(base):], dict(ms=0.0, calls=0))
                inst["ms"] += ms
                inst["calls"] += c
    # the backward of index gathers (the albedo gather's, reflectance
    # [mclip], and the other tables' whose fields require grad)
    gather_bwd = sum(ms for ms, k, _ in rows if "indexing_backward" in k)
    return dict(wall_ms=wall, device_busy_ms=busy,
                busy_share=busy / wall if wall else 0.0,
                gather_backward_ms=gather_bwd,
                kernels=sum(r[2] for r in rows), own=own,
                top=[dict(name=k[:80], ms=ms, calls=c)
                     for ms, k, c in rows[:12]])


def timed_calls(module, names, fn):
    """Run fn() once with each module.<name> wrapped to synchronise and
    time itself; returns {name: {calls, seconds, lanes}}."""
    stats = {k: dict(calls=0, seconds=0.0, lanes=0) for k in names}

    def timer(name, orig):
        def call(geom, ray, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = orig(geom, ray, *args)
            torch.cuda.synchronize()
            st = stats[name]
            st["calls"] += 1
            st["seconds"] += time.perf_counter() - t0
            st["lanes"] += ray.o.shape[0]
            return res
        return call

    with wrapped(module, names, timer):
        fn()
    return stats


@contextlib.contextmanager
def overflow_lanes():
    """Count, within the block, the lanes that reach the cluster path's XL
    re-run and its stream fallback (the overflow mask each is passed)."""
    from mitsuba_tpu_torch.render import intersect as ri

    names = ("_retier_closest", "_retier_any", "_fallback_closest_stream",
             "_fallback_any_stream")
    count = {k.lstrip("_"): 0 for k in names}

    def counter(name, orig):
        def call(*args):
            count[name.lstrip("_")] += int(args[-1].sum())
            return orig(*args)
        return call

    with wrapped(ri, names, counter):
        yield count


@contextlib.contextmanager
def split_lanes():
    """Count, within the block, the lanes passed to #2 and #3."""
    from mitsuba_tpu_torch.ops import intersect as ip

    count = [0]

    def counter(_name, orig):
        def call(table, o, *args):
            count[0] += o.shape[0]
            return orig(table, o, *args)
        return call

    with wrapped(ip, ("closest_hit_shaded", "any_hit"), counter):
        yield count


def render_phase(tag, scene, cfg, need, render_fn=None, forbid=()):
    """One warm-up render, then timed renders with every launch count set
    to 0 just before and read just after; then a profiled render and, on
    an instanced scene, a render timing its fallback's parts. render_fn:
    another renderer (scene, cfg, seed) -> (image, aux), whose rays are
    the lanes passed to #2 and #3; forbid: kernels that must not launch."""
    from mitsuba_tpu_torch.integrators.path import render
    from mitsuba_tpu_torch.render import intersect as ri

    render_fn = render_fn or render
    band = MEAN_BAND[tag]
    extra = {}
    with overflow_lanes() as ovf:
        render_fn(scene, cfg, seed=0)           # warm-up
    torch.cuda.synchronize()
    if scene.geom.backend == "cluster" and not scene.geom.has_instances:
        extra["overflow_lanes"] = ovf
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    secs, rays = [], []
    for seed in range(TIMED[tag]):
        with split_lanes() as lanes:
            t0 = time.perf_counter()
            img, aux = render_fn(scene, cfg, seed=seed)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        rays.append(int(aux["rays_traced"]) if "rays_traced" in aux
                    else lanes[0])
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = device_profile(lambda: render_fn(scene, cfg, seed=0))
    PROFILES[tag] = prof
    if scene.geom.has_instances:
        # the fallback of overflowing rows: the BVH kernel on the static
        # triangles plus the exact instance walks (the same kernel on each
        # group's tables) and the glue around them
        t0 = time.perf_counter()
        extra["fallback_glue"] = timed_calls(
            ri, ("_fallback_closest", "_fallback_any", "_instances_closest",
                 "_instances_any"), lambda: render_fn(scene, cfg, seed=0))
        extra["fallback_glue"]["render_seconds"] = time.perf_counter() - t0
    mean = float(img.mean())
    phase(tag, width=scene.width, height=scene.height, spp=cfg.spp,
          depth=cfg.max_depth, triangles=scene.geom.n_tris,
          seconds=secs, rays_traced=rays,
          mrays_per_s=[r / s / 1e6 for r, s in zip(rays, secs)],
          launches=launches, mean=mean, band=band, peak_mem_gib=peak,
          profile=prof, **extra)
    if tuple(img.shape) != (scene.height, scene.width, 3) \
            or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{tag} image is not finite or misshapen")
    if not band[0] < mean < band[1]:
        raise AssertionError(f"{tag} mean {mean} outside {band}")
    for k in need:
        if launches[k] < 1:
            raise AssertionError(f"{tag}: kernel {k} was never launched")
    for k in forbid:
        if launches[k]:
            raise AssertionError(f"{tag}: kernel {k} was launched")
    return launches


def _liveness(kernel, rays, any_hit, **kv):
    """Rows, live lanes (mint <= maxt) and the share of 32-lane warps
    with no live lane of one walk launch."""
    live = rays[:, 6] <= rays[:, 7]
    warps = live.reshape(rays.shape[0], -1, 32).any(dim=2)
    return dict(kernel=kernel, any_hit=bool(any_hit), rows=rays.shape[0],
                live_lanes=int(live.sum()),
                dead_warp_share=1.0 - float(warps.float().mean()), **kv)


def _item_walk_launch(tag, k, name, args, query):
    """Launch k of #7 (name "items") or #8 ("l1_items") of a render,
    replayed alone: held against its plain version bit for bit and timed
    (a kernel_vs_plain line), with its liveness and the steps (#7) or L1
    blocks (#8) it tests; #8 also the children admitted per tested L1
    block, by the row (each tested on all 128 lanes) and by each live
    lane's own slab."""
    from mitsuba_tpu_torch.ops import exact as ep

    any_hit = args[-1]
    if name == "items":
        r = check_pair("items", f"{tag} launch {k}", ep.items, ep.items_ref,
                       args, (1, 2, 3), _items_ops, counted=True,
                       tables=_k8_tables, time_plain=False, query=query)
        return _liveness("items", args[1], any_hit, query=query,
                         width=args[2].shape[1],
                         steps_tested=r["work"]["steps_tested"], ms=r["ms"],
                         parent_ms=r["parent_ms"], bound_ms=r["bound_ms"])
    r = check_pair("l1_items", f"{tag} launch {k}", ep.l1_items,
                   ep.l1_items_ref, args, (2, 3, 4), _walk_ops, counted=True,
                   tables=_l1_items_tables, time_plain=False, query=query)
    w = r["work"]
    return _liveness(
        "l1_items", args[2], any_hit, query=query, width=args[3].shape[1],
        l1_tested=w["l1_tested"],
        children_per_l1_row=w["children_row"] / max(1, w["l1_tested"]),
        children_per_l1_lane=w["children_lane"] / max(1, w["lane_l1s"]),
        ms=r["ms"], parent_ms=r["parent_ms"], bound_ms=r["bound_ms"])


def walk_liveness(tag, scene, cfg, reps=5, replay_refine=True):
    """One render, recording each launch of #9 and #10: its rows, live
    lanes and the share of warps with no live lane; each launch of #7 and
    #8, replayed alone (`_item_walk_launch`): their ms a render; and, with
    replay_refine, each of #5 and #6, labelled by the query that runs
    them (closest or any, at the coherent, diffuse or XL caps), with
    their live entries, each replayed alone and timed (CUDA events,
    median of `reps`): their device ms a render by label."""
    from mitsuba_tpu_torch.integrators.path import render
    from mitsuba_tpu_torch.ops import exact as ep
    from mitsuba_tpu_torch.ops import stream as sp

    calls = {"l1_masked": [], "items": [], "l1_items": [], "stream_rows": [],
             "refine": [], "child_refine": []}
    names = dict(zip(scene.geom.ex_caps, ("diffuse", "coherent", "xl")))
    query = [None]

    def recorder(name, orig):
        def call(*args):
            calls[name].append((args, query[0]))
            return orig(*args)
        return call

    def labeller(_name, orig):
        def call(ex, rays, caps, any_hit, walk):
            query[0] = f"{'any' if any_hit else 'closest'} " \
                f"{names.get(tuple(caps), str(caps))}"
            return orig(ex, rays, caps, any_hit, walk)
        return call

    with wrapped(ep, ("l1_masked", "items", "l1_items"), recorder), \
            wrapped(ep, ("refine", "child_refine"), recorder), \
            wrapped(ep, ("_walk",), labeller), \
            wrapped(sp, ("stream_rows",), recorder):
        render(scene, cfg, seed=0)
    launches = [_liveness("l1_masked", a[1], a[4], e2=a[2].shape[1])
                for a, _q in calls["l1_masked"]]
    launches += [_liveness("stream", a[0], a[4], list_width=a[1].shape[1])
                 for a, _q in calls["stream_rows"]]
    walks = {}
    for name in ("items", "l1_items"):
        for k, (args, q) in enumerate(calls[name]):
            rec = _item_walk_launch(tag, k, name, args, q)
            launches.append(rec)
            acc = walks.setdefault(name, dict(launches=0, ms=0.0,
                                              bound_ms=0.0))
            acc["launches"] += 1
            acc["ms"] += rec["ms"]
            acc["bound_ms"] += rec["bound_ms"]
    refine, sums = [], {}
    for name in ("refine", "child_refine") if replay_refine else ():
        fn = getattr(ep, name)
        for args, q in calls[name]:
            ms = cuda_ms(lambda: fn(*args), reps)
            acc = sums.setdefault(f"{name} {q}", dict(launches=0, ms=0.0))
            acc["launches"] += 1
            acc["ms"] += ms
            refine.append(_liveness(
                name, args[0], q.startswith("any"), query=q,
                width=args[1].shape[1], live_entries=int(args[2].sum()),
                ms=ms))
    phase("walk_liveness", path=tag, launches=launches,
          walk_per_render=walks, refine_launches=refine,
          refine_per_render=sums,
          refine_unit="device ms per render (CUDA events, each launch "
          "replayed alone)")
    return walks


def fog_render(scene, cfg, seed=0):
    from mitsuba_tpu_torch.integrators.volpath import render_volpath
    from mitsuba_tpu_torch.media import make_homogeneous

    return render_volpath(scene, make_homogeneous(**FOG), cfg, seed=seed)


def morton_render(scene, cfg, seed=0):
    """render() with the camera lanes in pixel-Morton order, as bench.py
    runs configs 2 and 3 (bench_scene(..., morton=True))."""
    from mitsuba_tpu_torch.integrators.path import (
        camera_samples, path_trace,
    )
    from mitsuba_tpu_torch.render.film import develop
    from mitsuba_tpu_torch.render.rfilter import make_rfilter

    ray, sampler, offset, inv_lane = camera_samples(scene, cfg, seed,
                                                    morton=True)
    L, aux = path_trace(scene, ray, sampler, cfg)
    return develop(L[inv_lane], offset[inv_lane], cfg.spp, scene.height,
                   scene.width, make_rfilter(cfg.rfilter)), aux


def config4_checks(device, res=GRAD_CHECK_RES):
    """Config 4's checks on the card at res x res (`grad_checks_phase` on
    config 1's box), and every kernel wrapper's refusal of a ray that
    requires grad, on the card as on the CPU."""
    from mitsuba_tpu_torch.ops import intersect as ip
    from mitsuba_tpu_torch.render.scene import cornell_box

    gc, _ = _grad_cases()
    scene = cornell_box(res, res, device=device)
    o = torch.zeros((64, 3), device=device, requires_grad=True)
    d = torch.ones((64, 3), device=device)
    t = torch.ones(64, device=device)
    refused = []
    for name, call in (
            ("shaded_any", lambda: ip.closest_hit_shaded_and_any(
                scene.geom.brute_tables[0], o, d, t * 0, t, o, d, t * 0, t)),
            ("any", lambda: ip.any_hit(scene.geom.brute_tables[1], o, d,
                                       t * 0, t))):
        try:
            call()
        except NotImplementedError:
            refused.append(name)
    out = grad_checks_phase("config4_checks", scene, gc.mean_l, res,
                            refused=refused)
    if len(refused) != 2:
        raise AssertionError(f"config4_checks: refused only {refused}")
    return out


def _grad_cases():
    """tests/torch_grad_cases.py (no JAX) and tests/torch_sss_cases.py."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_grad_cases as gc
    import torch_sss_cases as sc

    return gc, sc


def grad_phase(tag, scene, cfg, loss_fn, fields, kernels, recompute=None,
               **extra):
    """The gradient of loss_fn(scene, cfg, seed 0) with respect to each
    (table, field) of `fields`, one checkpoint a bounce: a first step
    under the profiler (its top kernels and the index gathers' backward
    share), every launch count set to 0 just before it and read after
    its forward and after its backward (the kernels' launches in the
    forward and in the backward's recompute apart), with the step's peak
    memory; then the forward alone (its peak), best of GRAD_ROUNDS, and
    the value-and-gradient step GRAD_ROUNDS - 1 times more (once more
    where the profiled step took over GRAD_LONG_S), best of those and
    the profiled step's wall time, the card synchronised before each
    clock read. Fails on a gradient that is not finite or is all zero, on a
    kernel of `kernels` that did not launch in the forward, and on one of
    `recompute` (by default `kernels`: those the checkpointed bounces
    run) that did not launch again in the backward."""
    gc, _ = _grad_cases()
    recompute = kernels if recompute is None else recompute

    def with_grad():
        xs, sc = {}, scene
        for table, field in fields:
            x = getattr(getattr(scene, table), field).detach().clone() \
                .requires_grad_(True)
            xs[f"{table}.{field}"] = x
            sc = gc.with_field(sc, table, **{field: x})
        return sc, xs

    def fwd():
        return float(loss_fn(scene, cfg, 0))

    def step():
        sc, xs = with_grad()
        loss = loss_fn(sc, cfg, 0)
        loss.backward()
        return float(loss.detach()), xs

    def best(fn, n=GRAD_ROUNDS):
        secs = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return min(secs), secs

    first = {}

    def counted_step():
        reset_launch_counts()
        sc, xs = with_grad()
        loss = loss_fn(sc, cfg, 0)
        torch.cuda.synchronize()
        first["forward"] = launch_counts()
        loss.backward()
        torch.cuda.synchronize()
        first["all"] = launch_counts()
        first["grads"] = {k: x.grad for k, x in xs.items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prof = device_profile(counted_step)
    prof_s = time.perf_counter() - t0
    PROFILES[tag] = prof
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd_l, all_l, grads = first["forward"], first["all"], first["grads"]
    bwd_l = {k: all_l[k] - fwd_l[k] for k in all_l}
    torch.cuda.reset_peak_memory_stats()
    t_fwd, fwd_secs = best(fwd)
    peak_fwd = torch.cuda.max_memory_allocated() / 2 ** 30
    grad_secs = [prof["wall_ms"] / 1e3]
    grad_secs += best(step, GRAD_ROUNDS - 1 if grad_secs[0] < GRAD_LONG_S
                      else 1)[1]
    t_grad = min(grad_secs)
    finite = {k: bool(torch.isfinite(g).all()) for k, g in grads.items()}
    gmax = {k: float(g.abs().max()) for k, g in grads.items()}
    res = dict(width=scene.width, height=scene.height, depth=cfg.max_depth,
               remat=cfg.remat, **extra, forward_s=t_fwd,
               value_and_grad_s=t_grad, forward_seconds=fwd_secs,
               value_and_grad_seconds=grad_secs,
               profiled_step_seconds=prof_s,
               bwd_fwd_ratio=t_grad / t_fwd,
               **({"spp_per_s": extra["spp"] / t_grad} if "spp" in extra
                  else {}),
               peak_mem_gib=peak,
               peak_mem_forward_gib=peak_fwd,
               launches=dict(forward={k: v for k, v in fwd_l.items() if v},
                             backward={k: v for k, v in bwd_l.items() if v}),
               kernels=list(kernels), recompute=list(recompute),
               finite=finite, grad_abs_max=gmax,
               gather_backward_ms=prof["gather_backward_ms"],
               gather_backward_share=prof["gather_backward_ms"]
               / prof["wall_ms"], device_busy_ms=prof["device_busy_ms"],
               busy_share=prof["busy_share"], profile_wall_ms=prof["wall_ms"],
               profile_kernels=prof["kernels"], top=prof["top"])
    phase(tag, **res)
    bad = [k for k in grads if not finite[k] or not gmax[k] > 0]
    if bad:
        raise AssertionError(f"{tag}: gradient of {bad} not finite or zero")
    missing = [k for k in kernels if fwd_l[k] < 1] \
        + [f"{k} (recompute)" for k in recompute if bwd_l[k] < 1]
    if missing:
        raise AssertionError(f"{tag}: {missing} not launched: "
                             f"{res['launches']}")
    return res


def grad_phases(device, scene_bvh, scene3, scene_inst):
    """The gradients off brute at full size (grad_phase), each path's
    checks at GRAD_CHECK_RES^2 after it (`grad_checks_phase`)."""
    from mitsuba_tpu_torch.integrators.path import PathConfig
    from mitsuba_tpu_torch.io.xml import load_scene
    from mitsuba_tpu_torch.render.scene import cornell_box, instanced_scene

    gc, sc = _grad_cases()
    cfg = PathConfig(max_depth=GRAD_DEPTH, spp=SPP3, remat=True)
    sky = (("materials", "reflectance"), ("emitters", "env_image"))
    area = (("materials", "reflectance"), ("emitters", "radiance"))
    check = dict(res=GRAD_CHECK_RES)
    out = {"grad_bvh": grad_phase(
        "grad_bvh", scene_bvh, cfg, gc.mean_l, sky,
        ["bvh_closest", "bvh_any"], spp=cfg.spp)}
    grad_checks_phase("grad_bvh_checks", gc.mesh_scene(
        gc.port_modules(), GRAD_CHECK_RES, "bvh", device=device),
        gc.mean_l, **check)
    out["grad_cluster"] = grad_phase(
        "grad_cluster", scene3, cfg, gc.mean_l, sky,
        ["refine", "child_refine", "l1_masked", "stream"], spp=cfg.spp)
    grad_checks_phase("grad_cluster_checks", gc.mesh_scene(
        gc.port_modules(), GRAD_CHECK_RES, "cluster", device=device),
        gc.mean_l, **check)
    out["grad_instanced"] = grad_phase(
        "grad_instanced", scene_inst, cfg, gc.mean_l, area,
        ["wl_closest", "wl_any", "bvh_closest", "bvh_any"], spp=cfg.spp)
    grad_checks_phase("grad_instanced_checks", instanced_scene(
        GRAD_CHECK_RES, GRAD_CHECK_RES, 16, 32, device=device), gc.mean_l,
        **check)
    with tempfile.TemporaryDirectory() as tmp:
        xml = sc.write_slab_xml(tmp, "dipole")
        slab, _ = load_scene(xml, params=dict(
            depth=SSS_DEPTH, spp=SSS_SPP, width=SSS_W, height=SSS_H,
            irr=SSS_IRR), device=device)
    out["grad_sss"] = grad_phase(
        "grad_sss", slab, PathConfig(max_depth=GRAD_SSS_DEPTH,
                                     spp=SSS_SPP),
        gc.cached_mean_l, area + (("subsurface", "sigma_tr"),),
        # #3 runs in the cache's direct samples only, which no bounce's
        # checkpoint holds (512 lanes keep their activations)
        ["shaded_any", "any"], recompute=["shaded_any"], spp=SSS_SPP,
        points=SSS_IRR,
        lanes=SSS_W * SSS_H * SSS_SPP)
    if not out["grad_sss"]["peak_mem_gib"] < 40:
        raise AssertionError(f"grad_sss: peak {out['grad_sss']}")
    del slab
    grad_checks_phase("grad_sss_checks", sc.slab_scene(
        sc.port_modules(), GRAD_CHECK_RES, n_points=GRAD_CHECK_POINTS,
        device=device), gc.cached_mean_l, fd_table="subsurface",
        fd_field="sigma_tr", fd_eps=1e-3, depth=SSS_DEPTH, **check)
    out["grad_ptracer"] = grad_phase(
        "grad_ptracer", cornell_box(PT_RES, PT_RES, device=device),
        PathConfig(max_depth=GRAD_PT_DEPTH, remat=True),
        gc.ptracer_mean(PT_PARTICLES),
        (("emitters", "radiance"), ("materials", "reflectance")),
        ["shaded", "any"], particles=PT_PARTICLES)
    grad_checks_phase("grad_ptracer_checks", cornell_box(
        GRAD_CHECK_RES, GRAD_CHECK_RES, device=device),
        gc.ptracer_mean(GRAD_CHECK_PARTICLES), **check)
    return out


def grad_checks_phase(tag, scene, loss_fn, res, fd_table="materials",
                      fd_field="reflectance", fd_eps=None, depth=5, **extra):
    """tests/torch_grad_cases.py grad_checks on the card at res x res, 4
    spp (remat on; central differences on three entries of fd_field);
    `extra` joins the phase's line."""
    from mitsuba_tpu_torch.integrators.path import PathConfig

    gc, _ = _grad_cases()
    cfg = PathConfig(max_depth=depth, spp=4, remat=True)
    x = getattr(getattr(scene, fd_table), fd_field)
    entries = ([(0, c) for c in range(3)] if fd_table == "subsurface"
               else [(i, c) for i, c in ((0, 0), (1, 1), (1, 2))
                     if i < x.shape[0]])
    kw = {} if fd_eps is None else dict(fd_eps=fd_eps)
    out, bad = gc.grad_checks(loss_fn, scene, cfg, entries,
                              fd_table=fd_table, fd_field=fd_field, **kw)
    phase(tag, width=res, height=res, spp=cfg.spp, depth=cfg.max_depth,
          fd_field=f"{fd_table}.{fd_field}", **out, **extra,
          limits=dict(fd=gc.FD_RTOL, linearity=gc.LIN_RTOL,
                      remat=gc.REMAT_RTOL, cpu=gc.CPU_RTOL))
    if bad:
        raise AssertionError(f"{tag}: {bad}")
    return out


# ---------------------------------------------------------------------------
# the scene-file front end: io.xml, io.bitmap, cli
# ---------------------------------------------------------------------------

def cli_phase(tag, device, tmp, name, w=CLI_W, h=CLI_H, spp=CLI_SPP,
              depth=CLI_DEPTH, xml=None, need=("shaded_any",), jpeg=False):
    """`python -m mitsuba_tpu_torch scenes/<name>.xml` (or the file `xml`)
    through
    mitsuba_tpu_torch.cli.main, launch counts set to 0 just before and
    read just after; then the same scene loaded by io.xml.load_scene and
    rendered by render, with the file's pattern and filter, twice (timed,
    launch counts and peak memory) and once under the profiler (device
    busy share). The EXR the CLI wrote, read back by io.bitmap.read_exr,
    must equal the seed-0 render bit for bit. A brute scene launches #1
    `depth` times a render; another names the kernels it `need`s, each
    launched in the CLI's run and in each render. `jpeg`: the CLI runs
    again with a .jpg output, whose bytes must be the port's JPEG of the
    render's sRGB image."""
    from mitsuba_tpu_torch.cli import main as cli_main
    from mitsuba_tpu_torch.core.spectrum import to_srgb
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.io.bitmap import read_exr
    from mitsuba_tpu_torch.io.jpeg import write_jpeg
    from mitsuba_tpu_torch.io.xml import load_scene

    shown = f"scenes/{name}.xml" if xml is None else os.path.basename(xml)
    xml = xml or os.path.join(ROOT, "scenes", f"{name}.xml")
    out = os.path.join(tmp, f"{name}.exr")
    defs = dict(depth=depth, spp=spp, width=w, height=h)
    argv = [xml] + [a for k, v in defs.items() for a in ("-D", f"{k}={v}")]
    reset_launch_counts()
    t0 = time.perf_counter()
    if cli_main(argv + ["-o", out]) != 0:
        raise AssertionError("cli_cornell: the CLI exited non-zero")
    cli_s = time.perf_counter() - t0
    cli_launches = launch_counts()
    t0 = time.perf_counter()
    scene, cfg = load_scene(xml, params=defs, device=device)
    load_s = time.perf_counter() - t0
    pc = PathConfig(max_depth=cfg["maxDepth"], spp=cfg["sampleCount"],
                    pattern=cfg["pattern"], rfilter=cfg["rfilter"],
                    remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, rays, launches, means, all_launches = [], [], [], [], []
    for seed in (0, 1):
        reset_launch_counts()
        t0 = time.perf_counter()
        img, aux = render(scene, pc, seed=seed)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        all_launches.append(launch_counts())
        launches.append(all_launches[-1]["shaded_any"])
        rays.append(int(aux["rays_traced"]))
        means.append(float(img.mean()))
        if seed == 0:
            exr = read_exr(out)
            ref = img.cpu().numpy()
            same = bool(np.array_equal(exr, ref))
            finite = bool(np.isfinite(ref).all())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = device_profile(lambda: render(scene, pc, seed=0))
    band = MEAN_BAND[tag]
    extra = {}
    if jpeg:
        jpg = os.path.join(tmp, f"{name}.jpg")
        t0 = time.perf_counter()
        if cli_main(argv + ["-o", jpg]) != 0:
            raise AssertionError(f"{tag}: the CLI exited non-zero (.jpg)")
        want = os.path.join(tmp, f"{name}_want.jpg")
        write_jpeg(want, (to_srgb(ref) * 255 + 0.5).astype(np.uint8))
        with open(jpg, "rb") as a, open(want, "rb") as b:
            extra.update(jpeg_seconds=time.perf_counter() - t0,
                         jpeg_bytes=os.path.getsize(jpg),
                         jpeg_equals_render=a.read() == b.read())
        if not extra["jpeg_equals_render"]:
            raise AssertionError(f"{tag}: the JPEG is not the render's")
    phase(tag, command=["python", "-m", "mitsuba_tpu_torch",
                        shown] + argv[1:]
          + ["-o", f"{name}.exr"], width=w, height=h, spp=spp, depth=depth,
          lanes=w * h * spp, pattern=pc.pattern, rfilter=pc.rfilter,
          backend=scene.geom.backend, triangles=scene.geom.n_tris,
          spheres=scene.geom.n_spheres, cylinders=scene.geom.n_cylinders,
          cli_seconds=cli_s,
          cli_launches_shaded_any=cli_launches["shaded_any"],
          cli_launches={k: v for k, v in cli_launches.items() if v},
          render_launches=[{k: v for k, v in la.items() if v}
                           for la in all_launches],
          load_seconds=load_s, seconds=secs, rays_traced=rays,
          mrays_per_s=[r / t / 1e6 for r, t in zip(rays, secs)],
          launches_shaded_any=launches, means=means, band=band,
          peak_mem_gib=peak, exr_equals_render=same,
          device_busy_ms=prof["device_busy_ms"],
          busy_share=prof["busy_share"], profile_wall_ms=prof["wall_ms"],
          kernels=prof["kernels"],
          own_ms=prof["own"].get("brute_kernel", {}).get("ms"),
          own=prof["own"], top=prof["top"], **extra)
    if not same or not finite:
        raise AssertionError(f"{tag}: the EXR differs from the render "
                             "or is not finite")
    if tuple(need) == ("shaded_any",):
        if cli_launches["shaded_any"] != depth \
                or launches != [depth, depth]:
            raise AssertionError(f"{tag}: #1 launched "
                                 f"{cli_launches['shaded_any']}, {launches}")
    else:
        for k in need:
            if cli_launches[k] < 1 or min(la[k] for la in all_launches) < 1:
                raise AssertionError(f"{tag}: kernel {k} was never "
                                     "launched")
    if not all(band[0] < m < band[1] for m in means):
        raise AssertionError(f"{tag}: means {means} outside {band}")
    PROFILES[tag] = prof
    if tuple(need) == ("shaded_any",):
        return dict(cli=cli_launches["shaded_any"], render=launches[0])
    return dict(cli=cli_launches, render=all_launches[0])


def golden_cornell_xml(device, res=GOLD_RES, spp=GOLD_SPP):
    """tests/test_goldens.py's gate on scenes/cornell.xml loaded by the
    port: per-pixel mean and variance over spp samples (lanes in scanline
    order, seed 777) against tests/goldens/cornell.npz, the reference's
    256-spp render of the same box built in Python (tests/golden_scenes.py
    scene_cornell; the XML box differs from it only in shape and material
    order, so the two agree only statistically). The gate is the test's
    own |t| rule, not utils.ttest.welch_ttest_images: that function's
    p-values (a copy of the reference's) are wrong (ROADMAP C)."""
    from mitsuba_tpu_torch.integrators.path import (
        PathConfig, camera_wavefront, path_trace,
    )
    from mitsuba_tpu_torch.io.xml import load_scene

    scene, _ = load_scene(os.path.join(ROOT, "scenes", "cornell.xml"),
                          params=dict(depth=GOLD_DEPTH, spp=spp, width=res,
                                      height=res), device=device)
    cfg = PathConfig(max_depth=GOLD_DEPTH, spp=spp, remat=False)
    ray, sampler, _ = camera_wavefront(scene, cfg, GOLD_SEED, morton=False)
    L, _ = path_trace(scene, ray, sampler, cfg)
    Ls = L.reshape(res, res, spp, 3).double()
    mean = Ls.mean(dim=2).cpu().numpy()
    var = Ls.var(dim=2, unbiased=True).cpu().numpy()
    g = np.load(os.path.join(ROOT, "tests", "goldens", "cornell.npz"))
    se = np.sqrt(var / spp + g["var"] / int(g["spp"]))
    t = (mean - g["mean"]) / np.maximum(se, 1e-6)
    frac = float((np.abs(t) > GOLD_CRIT).any(axis=-1).mean())
    phase("golden_cornell_xml", golden="tests/goldens/cornell.npz",
          width=res, height=res, spp=spp, depth=GOLD_DEPTH, seed=GOLD_SEED,
          golden_spp=int(g["spp"]), fail_fraction=frac,
          limit=GOLD_FAIL_MAX, crit=GOLD_CRIT, mean=float(mean.mean()),
          golden_mean=float(g["mean"].mean()),
          finite=bool(np.isfinite(mean).all()))
    if not frac < GOLD_FAIL_MAX or not np.isfinite(mean).all():
        raise AssertionError(f"golden_cornell_xml: fail fraction {frac}")


def golden_stats(tag, scene, depth, spp=GOLD_SPP, seed=GOLD_SEED,
                 pattern="independent", **options):
    """tests/test_goldens.py's gate of a render against the golden
    STATS_GOLDENS[tag]: per-pixel mean and variance of spp samples (lanes
    in scanline order, box-developed by render.film.develop_with_variance),
    a pixel failing at |t| > GOLD_CRIT, the image at GOLD_FAIL_MAX."""
    from mitsuba_tpu_torch.integrators.path import (
        PathConfig, camera_samples, path_trace,
    )
    from mitsuba_tpu_torch.render.film import develop_with_variance

    cfg = PathConfig(max_depth=depth, spp=spp, pattern=pattern,
                     remat=False, **options)
    ray, sampler, _, _ = camera_samples(scene, cfg, seed, morton=False)
    L, _ = path_trace(scene, ray, sampler, cfg)
    mean, var, _ = develop_with_variance(L.double(), spp, scene.height,
                                         scene.width)
    mean, var = mean.cpu().numpy(), var.cpu().numpy()
    golden = STATS_GOLDENS[tag]
    g = np.load(os.path.join(ROOT, golden))
    se = np.sqrt(var / spp + g["var"] / int(g["spp"]))
    t = (mean - g["mean"]) / np.maximum(se, 1e-6)
    frac = float((np.abs(t) > GOLD_CRIT).any(axis=-1).mean())
    phase(tag, golden=golden, width=scene.width, height=scene.height,
          spp=spp, depth=depth, seed=seed, pattern=pattern,
          options=options, golden_spp=int(g["spp"]), fail_fraction=frac, limit=GOLD_FAIL_MAX,
          crit=GOLD_CRIT, mean=float(mean.mean()),
          golden_mean=float(g["mean"].mean()),
          finite=bool(np.isfinite(mean).all()))
    if not frac < GOLD_FAIL_MAX or not np.isfinite(mean).all():
        raise AssertionError(f"{tag}: fail fraction {frac}")


def materials_phases(device, tmp):
    """The materials slice: snow.xml through the CLI (cli_phase) and its
    golden, the Ward / Phong / rough-glass spheres of
    tests/golden_scenes.py:51 and the bsdf_zoo against theirs, the zoo's
    render phase, and its first bounce on the card against the CPU.
    Returns each render phase's launch counts."""
    from mitsuba_tpu_torch.integrators.path import PathConfig
    from mitsuba_tpu_torch.io.xml import load_scene

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_bsdf_cases as zc

    out = {"snow_xml": cli_phase("snow_xml", device, tmp, "snow")}
    g = np.load(os.path.join(ROOT, STATS_GOLDENS["golden_snow"]))
    res = g["mean"].shape[0]
    scene, cfg = load_scene(
        os.path.join(ROOT, "scenes", "snow.xml"), params=dict(
            depth=int(g["depth"]), spp=GOLD_SPP, width=res, height=res),
        device=device)
    golden_stats("golden_snow", scene, int(g["depth"]),
                 pattern=cfg["pattern"])
    mods = zc.port_modules()
    golden_stats("golden_ward_spheres",
                 zc.ward_spheres_scene(mods, res, device=device),
                 zc.WARD_SPHERES_DEPTH)
    golden_stats("golden_bsdf_zoo", zc.zoo_scene(mods, res, device=device),
                 zc.ZOO_DEPTH)
    zoo = zc.zoo_scene(mods, ZOO_RES, device=device)
    out["bsdf_zoo"] = render_phase(
        "bsdf_zoo", zoo, PathConfig(max_depth=ZOO_DEPTH, spp=ZOO_SPP),
        ["shaded_any"], forbid=["shaded", "any"])
    zoo_vs_cpu(zc.zoo_scene(mods, ZOO_CPU_RES, device=device))
    return out


def zoo_vs_cpu(scene):
    """The zoo's first bounce on the card against the port on the CPU
    (the plain versions), ZOO_CPU_RES x ZOO_CPU_RES px, ZOO_CPU_SPP spp:
    each lane's material id, wo, weight, pdf and delta and transmission
    flags. The libraries' sin, cos, exp, log and pow may round an ulp
    apart, so the largest difference is printed and gated loosely: ids on
    every lane, flags on 99% of lanes, and the lanes whose flags agree
    within 1e-3 of the largest value."""
    from mitsuba_tpu_torch.bsdfs import bsdf_sample
    from mitsuba_tpu_torch.integrators.path import PathConfig, camera_samples
    from mitsuba_tpu_torch.render.intersect import ray_intersect

    def first_bounce(sc):
        cfg = PathConfig(max_depth=1, spp=ZOO_CPU_SPP)
        ray, sampler, _, _ = camera_samples(sc, cfg, seed=0, morton=False)
        its = ray_intersect(sc.geom, ray)
        u = sampler.next_2d()
        albedo = sc.materials.reflectance[
            torch.clamp(its.material_id, min=0).long()]
        s = bsdf_sample(sc.materials, its.material_id, its.wi, u, u[:, 0],
                        albedo=albedo)
        s["material_id"] = its.material_id
        return {k: v.cpu() for k, v in s.items()}

    card, cpu = first_bounce(scene), first_bounce(scene.to("cpu"))
    same_id = float((card["material_id"] == cpu["material_id"]).float()
                    .mean())
    flags = (card["delta"] == cpu["delta"]) \
        & (card["transmission"] == cpu["transmission"]) \
        & (card["valid"] == cpu["valid"])
    diff = {}
    for k in ("wo", "weight", "pdf"):
        d = (card[k] - cpu[k]).abs()
        d = d.reshape(d.shape[0], -1).amax(-1)[flags]
        diff[k] = dict(max_abs=float(d.max()), rel_to_max=float(
            d.max() / cpu[k].abs().max().clamp(min=1e-30)),
            lanes_over_1e_5=int((d > 1e-5).sum()))
    phase("bsdf_zoo_vs_cpu", width=scene.width, height=scene.height,
          spp=ZOO_CPU_SPP, lanes=int(flags.numel()),
          kinds=sorted({int(k) for k in cpu["material_id"].tolist()}),
          same_material_id=same_id, same_flags=float(flags.float().mean()),
          largest_difference=diff)
    if same_id < 1.0 or float(flags.float().mean()) < 0.99:
        raise AssertionError(f"bsdf_zoo_vs_cpu: ids {same_id}, flags "
                             f"{float(flags.float().mean())}")
    bad = {k: v for k, v in diff.items() if not v["rel_to_max"] <= 1e-3}
    if bad:
        raise AssertionError(f"bsdf_zoo_vs_cpu: {bad}")


# ---------------------------------------------------------------------------
# the lights, textures, cameras and the particle tracer
# ---------------------------------------------------------------------------

def _light_cases():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_bsdf_cases as zc
    import torch_light_cases as lc

    return lc, zc.port_modules()


def lights_phases(device, tmp):
    """The lights file of tests/torch_light_cases.py (point, spot,
    directional, sphere and envmap lights on the two Cornell blocks, a
    bitmap floor) through the CLI at CLI_W x CLI_H x CLI_SPP, depth 5
    (cli_phase: #1 5 a render), its golden (golden_lights), and the same
    file with its orthographic camera at ORTHO_SPP spp. Returns the
    phases' launch counts."""
    from mitsuba_tpu_torch.integrators.path import PathConfig
    from mitsuba_tpu_torch.io.xml import load_scene

    lc, _ = _light_cases()
    t0 = time.perf_counter()
    path = lc.write_lights_scene(tmp, LIGHTS_TEX, LIGHTS_ENV)
    ortho = lc.write_lights_scene(tmp, LIGHTS_TEX, LIGHTS_ENV,
                                  camera="orthographic")
    phase("lights_files", seconds=time.perf_counter() - t0,
          files=sorted(os.listdir(tmp)), floor_texels=LIGHTS_TEX ** 2,
          sky_texels=2 * LIGHTS_ENV ** 2)
    out = {"lights_xml": cli_phase("lights_xml", device, tmp, "lights",
                                   xml=path)}
    g = np.load(os.path.join(ROOT, STATS_GOLDENS["golden_lights"]))
    res = g["mean"].shape[0]
    scene, _ = load_scene(path, params=dict(
        depth=int(g["depth"]), spp=GOLD_SPP, width=res, height=res),
        device=device)
    golden_stats("golden_lights", scene, int(g["depth"]))
    t0 = time.perf_counter()
    scene, cfg = load_scene(ortho, params=dict(
        depth=CLI_DEPTH, spp=ORTHO_SPP, width=CLI_W, height=CLI_H),
        device=device)
    phase("lights_ortho_load", seconds=time.perf_counter() - t0,
          camera_kind=scene.camera.kind,
          emitter_kinds=list(scene.emitters.kinds_present))
    out["lights_ortho"] = render_phase(
        "lights_ortho", scene, PathConfig(max_depth=cfg["maxDepth"],
                                          spp=cfg["sampleCount"]),
        ["shaded_any"], forbid=["shaded", "any"])
    return out


def textured_phases(device):
    """The receding checker floor (tests/test_mipmap.py:154, brute) at
    MIP_RES^2 x MIP_SPP, depth 5: render phases with no filter, with
    mip_filter and with aniso_filter, then one seed-0 render of each
    gated by that test's three checks (each filter's energy within
    MIP_ENERGY of the unfiltered, the far rows' std under mip_filter
    below MIP_FAR_STD of the unfiltered, EWA's contrast over
    MIP_CONTRAST times the isotropic filter's); its golden with
    aniso_filter (golden_textured); config 3's scene on bvh with a bitmap
    floor and mips under mip_filter (#11 5 + 5 a render)."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, render

    lc, mods = _light_cases()
    t0 = time.perf_counter()
    floor = lc.mip_floor(mods, MIP_RES, MIP_RES, device=device)
    phase("textured_mip_build", seconds=time.perf_counter() - t0,
          levels=floor.textures.mips[0].n_levels)
    out = {}
    filters = (("textured_mip", {}),
               ("textured_mip_mip", dict(mip_filter=True)),
               ("textured_mip_aniso", dict(aniso_filter=True)))
    for tag, kw in filters:
        out[tag] = render_phase(tag, floor, PathConfig(
            max_depth=5, spp=MIP_SPP, **kw), ["shaded_any"],
            forbid=["shaded", "any"])
    imgs = [render(floor, PathConfig(max_depth=5, spp=MIP_SPP, **kw),
                   seed=0)[0].cpu().numpy() for _, kw in filters]
    n, m, a = imgs
    far = slice(MIP_RES * 18 // 32, MIP_RES * 30 // 32)

    def contrast(img):
        return float(np.std(img[far, :, 0], axis=1).mean())

    res = dict(energy_mip=float(abs(m.mean() - n.mean()) / n.mean()),
               energy_aniso=float(abs(a.mean() - n.mean()) / n.mean()),
               far_std_ratio=float(m[far].std() / n[far].std()),
               contrast_ratio=contrast(a) / contrast(m),
               means=[float(x.mean()) for x in imgs])
    phase("textured_mip_gates", width=MIP_RES, height=MIP_RES, spp=MIP_SPP,
          limits=dict(energy=MIP_ENERGY, far_std=MIP_FAR_STD,
                      contrast=MIP_CONTRAST), **res)
    if not (res["energy_mip"] < MIP_ENERGY
            and res["energy_aniso"] < MIP_ENERGY
            and res["far_std_ratio"] < MIP_FAR_STD
            and res["contrast_ratio"] > MIP_CONTRAST
            and all(np.isfinite(x).all() for x in imgs)):
        raise AssertionError(f"textured_mip: {res}")
    del floor, imgs, n, m, a
    g = np.load(os.path.join(ROOT, STATS_GOLDENS["golden_textured"]))
    r = g["mean"].shape[0]
    golden_stats("golden_textured", lc.mip_floor(mods, r, r, device=device),
                 int(g["depth"]), aniso_filter=True)
    t0 = time.perf_counter()
    scene = lc.textured_bvh_scene(mods, W3, H3, device=device)
    phase("textured_bvh_build", seconds=time.perf_counter() - t0,
          triangles=scene.geom.n_tris, backend=scene.geom.backend,
          levels=scene.textures.mips[0].n_levels)
    out["textured_bvh"] = render_phase(
        "textured_bvh", scene, PathConfig(max_depth=DEPTH3, spp=SPP3,
                                          mip_filter=True),
        ["bvh_closest", "bvh_any"])
    per = {k: out["textured_bvh"][k] // TIMED["textured_bvh"]
           for k in ("bvh_closest", "bvh_any")}
    if per != {"bvh_closest": DEPTH3, "bvh_any": DEPTH3}:
        raise AssertionError(f"textured_bvh: #11 launched {per} a render")
    return out


def ptracer_phase(device):
    """The particle tracer on config 1's box at PT_RES^2, depth 5,
    PT_PARTICLES particles (render_phase: #2 once a bounce, #3 once a
    bounce and once for the origins); two seed-0 runs equal bit for bit;
    tests/test_ptracer.py's rule against config 1's path render at the
    same size (16 spp): the mean within PT_MEAN_REL, the correlation of
    the pixels over PT_CORR."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.integrators.ptracer import ptracer_render
    from mitsuba_tpu_torch.render.scene import cornell_box

    scene = cornell_box(PT_RES, PT_RES, device=device)
    cfg = PathConfig(max_depth=5)

    def trace(sc, c, seed=0):
        return ptracer_render(sc, c, PT_PARTICLES, seed=seed)

    launches = render_phase("ptracer", scene, cfg, ["shaded", "any"],
                            render_fn=trace, forbid=["shaded_any"])
    a = trace(scene, cfg)[0]
    b = trace(scene, cfg)[0]
    same = bool(torch.equal(a, b))
    path = render(scene, PathConfig(max_depth=5, spp=16), seed=0)[0]
    p, lt = path.cpu().numpy(), a.cpu().numpy()
    rel = float(abs(p.mean() - lt.mean()) / p.mean())
    corr = float(np.corrcoef(p.mean(-1).ravel(), lt.mean(-1).ravel())[0, 1])
    phase("ptracer_gates", particles=PT_PARTICLES, width=PT_RES,
          height=PT_RES, runs_equal=same, mean=float(lt.mean()),
          path_mean=float(p.mean()), mean_rel=rel, corr=corr,
          limits=dict(mean_rel=PT_MEAN_REL, corr=PT_CORR),
          finite=bool(np.isfinite(lt).all()))
    if not same:
        raise AssertionError("ptracer: two runs differ")
    if not (rel < PT_MEAN_REL and corr > PT_CORR
            and np.isfinite(lt).all()):
        raise AssertionError(f"ptracer: mean {rel}, corr {corr}")
    return launches


def texture_grad(device, res=TEX_GRAD_RES):
    """The texel gradient (tests/test_grad.py:100's scene at res x res, 4
    spp, depth 2, seed 5) on the card: against central differences on
    three texels (eps 1e-2, within TEX_GRAD_REL) and against the CPU's
    gradient (the plain versions; within 1e-3 of the largest entry)."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, render

    lc, mods = _light_cases()
    scene = lc.grad_quad(mods, res, res, device=device)
    cfg = PathConfig(max_depth=2, spp=4, remat=True)

    def loss(sc, img):
        t = sc.textures
        sc = dataclasses.replace(sc, textures=dataclasses.replace(
            t, images=(img,) + t.images[1:]))
        return render(sc, cfg, seed=5)[0].mean()

    def grad(sc):
        img = sc.textures.images[0].clone().requires_grad_(True)
        loss(sc, img).backward()
        return img.grad

    g = grad(scene)
    img0 = scene.textures.images[0]
    eps = 1e-2
    fd = []
    with torch.no_grad():
        for idx in ((1, 1, 0), (2, 3, 1), (0, 0, 2)):
            e = torch.zeros_like(img0)
            e[idx] = 1.0
            f = (float(loss(scene, img0 + eps * e))
                 - float(loss(scene, img0 - eps * e))) / (2 * eps)
            an = float(g[idx])
            fd.append(dict(entry=idx, fd=f, grad=an, rel=abs(f - an) / max(
                abs(f), abs(an), 1e-6)))
    g_cpu = grad(scene.to("cpu"))
    cpu = dict(max_abs=float((g.cpu() - g_cpu).abs().max()),
               rel_to_max=float((g.cpu() - g_cpu).abs().max()
                                / g_cpu.abs().max()))
    phase("texture_grad", width=res, height=res, spp=cfg.spp,
          depth=cfg.max_depth, fd=fd, cpu=cpu, limit=TEX_GRAD_REL,
          finite=bool(torch.isfinite(g).all()))
    bad = [r for r in fd if not r["rel"] < TEX_GRAD_REL]
    if bad or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"texture_grad: central differences {bad}")
    if not cpu["rel_to_max"] <= 1e-3:
        raise AssertionError(f"texture_grad: card vs CPU {cpu}")


def xml_config3_phase(device, tmp, ref3, l3, w=W3, h=H3):
    """tests/torch_xml_cases.py's XML twin of config 3, written as files
    (binary PLY) and loaded by io.xml.load_scene under backend 'auto'
    (the CLI's -d auto): the cluster backend, config 3's tables (`ref3`,
    textured_mesh_scene(backend="cluster")) with the material rows in the
    loader's order; gated at 64x64 as config 3 is; its 512x512x4 renders
    (render_phase) launching #9 and #10 as config 3's (`l3`) do; then the
    same files under backend 'bvh' (-d bvh), gated as the bvh phase is,
    and one 512x512x4 render through #11."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_xml_cases as xc

    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.io.xml import load_scene

    t0 = time.perf_counter()
    path = xc.write_config3_twin(tmp)
    write_s = time.perf_counter() - t0
    defs = dict(depth=DEPTH3, spp=SPP3, width=w, height=h)
    t0 = time.perf_counter()
    twin, _ = load_scene(path, params=defs, backend="auto", device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    raw = xc.table_diffs(twin, ref3)
    left = xc.table_diffs(twin, xc.with_material_order(ref3))
    phase("xml_config3_load", files=sorted(os.listdir(tmp)),
          write_seconds=write_s, load_seconds=load_s,
          backend=twin.geom.backend, triangles=twin.geom.n_tris,
          differs_from_config3=raw, material_order=xc.MATERIAL_ORDER,
          differs_after_reorder=left)
    if twin.geom.backend != "cluster" or left:
        raise AssertionError(f"xml_config3: backend {twin.geom.backend}, "
                             f"tables differ in {left}")
    golden_gate("golden_64_xml_config3",
                dataclasses.replace(twin, width=64, height=64),
                "tests/torch_goldens/bench_cfg3_sphere.npz",
                band=MEAN_BAND["config3"])
    cfg = PathConfig(max_depth=DEPTH3, spp=SPP3)
    lx = render_phase("xml_config3", twin, cfg,
                      ["refine", "child_refine", "l1_masked"],
                      forbid=["items", "l1_items"])
    for k in ("l1_masked", "stream", "refine", "child_refine"):
        if lx[k] != l3[k]:
            raise AssertionError(f"xml_config3: {k} launched {lx[k]}, "
                                 f"config 3 {l3[k]}")
    del twin
    t0 = time.perf_counter()
    twin_bvh, _ = load_scene(path, params=defs, backend="bvh", device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    golden_gate("golden_64_xml_config3_bvh",
                dataclasses.replace(twin_bvh, width=64, height=64),
                "tests/torch_goldens/bench_cfg3_sphere.npz",
                band=MEAN_BAND["config3"])
    reset_launch_counts()
    t0 = time.perf_counter()
    img, aux = render(twin_bvh, cfg, seed=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lb = launch_counts()
    mean = float(img.mean())
    band = MEAN_BAND["xml_config3_bvh"]
    phase("xml_config3_bvh", load_seconds=load_s,
          backend=twin_bvh.geom.backend, seconds=secs,
          rays_traced=int(aux["rays_traced"]),
          mrays_per_s=int(aux["rays_traced"]) / secs / 1e6,
          launches={k: v for k, v in lb.items() if v}, mean=mean, band=band)
    if lb["bvh_closest"] != DEPTH3 or lb["bvh_any"] != DEPTH3 \
            or not band[0] < mean < band[1]:
        raise AssertionError(f"xml_config3_bvh: #11 launched "
                             f"{lb['bvh_closest']} + {lb['bvh_any']}, "
                             f"mean {mean}")
    return dict(cluster=lx, bvh=lb)


# ---------------------------------------------------------------------------
# participating media: grid, Gaussian-flake and guided volpath, and
# shape-interior media (ROADMAP A.7, A.8)
# ---------------------------------------------------------------------------

def _media_cases():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_media_cases as mc

    return mc


def flake_medium(n=FLAKE_GRID):
    """An oriented Gaussian-flake medium over the Cornell box: n³ density
    and fiber fields (the reference's density + orientation pair)."""
    from mitsuba_tpu_torch.media import make_heterogeneous

    mc = _media_cases()
    grid = mc.noise_grid(n, 5)
    return make_heterogeneous(grid, mc.grid_to_box(grid.shape),
                              orientation=mc.fiber_field(n),
                              flake_stddev=FLAKE_STDDEV, **FLAKE_SIGMA)


def _medium_render(medium):
    def run(scene, cfg, seed=0):
        from mitsuba_tpu_torch.integrators.volpath import render_volpath

        return render_volpath(scene, medium, cfg, seed=seed)
    return run


def guided_render(scene, cfg, seed=0):
    from mitsuba_tpu_torch.integrators.volpath import render_volpath_guided
    from mitsuba_tpu_torch.media import make_homogeneous

    return render_volpath_guided(scene, make_homogeneous(**FOG), cfg,
                                 seed=seed)


def media_render(scene, cfg, seed=0):
    from mitsuba_tpu_torch.integrators.volpath import render_volpath_media

    return render_volpath_media(scene, cfg, seed=seed)


def golden_tank(device, res=TANK_GOLD_RES, spp=TANK_GOLD_SPP):
    """tests/test_goldens.py's gate on the volumetric tank (the port's
    SceneBuilder twin of tests/golden_scenes.py:118): per-pixel mean and
    variance of volpath_media_trace over spp samples (scanline lanes,
    seed 777) against the reference's 256-spp golden, a pixel failing at
    |t| > 3.9, the image at 1%."""
    from mitsuba_tpu_torch.integrators.path import (
        PathConfig, camera_wavefront,
    )
    from mitsuba_tpu_torch.integrators.volpath import volpath_media_trace

    mc = _media_cases()
    scene = mc.tank_scene(res, device=device)
    cfg = PathConfig(max_depth=TANK_DEPTH, spp=spp, remat=False)
    ray, sampler, _ = camera_wavefront(scene, cfg, TANK_GOLD_SEED,
                                       morton=False)
    L, _ = volpath_media_trace(scene, ray, sampler, cfg)
    Ls = L.reshape(res, res, spp, 3).double()
    mean = Ls.mean(dim=2).cpu().numpy()
    var = Ls.var(dim=2, unbiased=True).cpu().numpy()
    g = np.load(os.path.join(ROOT, "tests", "goldens",
                             "volumetric_tank.npz"))
    se = np.sqrt(var / spp + g["var"] / int(g["spp"]))
    t = (mean - g["mean"]) / np.maximum(se, 1e-6)
    frac = float((np.abs(t) > GOLD_CRIT).any(axis=-1).mean())
    phase("golden_tank", golden="tests/goldens/volumetric_tank.npz",
          width=res, height=res, spp=spp, depth=TANK_DEPTH,
          seed=TANK_GOLD_SEED, golden_spp=int(g["spp"]), fail_fraction=frac,
          limit=GOLD_FAIL_MAX, crit=GOLD_CRIT, mean=float(mean.mean()),
          golden_mean=float(g["mean"].mean()),
          finite=bool(np.isfinite(mean).all()))
    if not frac < GOLD_FAIL_MAX or not np.isfinite(mean).all():
        raise AssertionError(f"golden_tank: fail fraction {frac}")


def tank_grad(device, res=GRAD_RES):
    """The interior sigma's gradient (tests/test_grad.py:76-97) on the
    card: the image mean's central differences, seed by seed, against
    the reverse-mode gradient through stack_params' gather, averaged over
    seeds 20-31, within 8%; and the card's gradient against the CPU's at
    seed 20."""
    from mitsuba_tpu_torch.integrators.path import PathConfig
    from mitsuba_tpu_torch.integrators.volpath import render_volpath_media

    mc = _media_cases()
    cfg = PathConfig(max_depth=TANK_DEPTH, spp=GRAD_SPP, remat=False)
    out = {}
    for field, base in (("sigma_a", 0.5), ("sigma_s", 0.4)):
        def mean(scene, v, seed):
            media = dataclasses.replace(scene.media,
                                        **{field: v.expand(1, 3)})
            img, _ = render_volpath_media(
                dataclasses.replace(scene, media=media), cfg, seed=seed)
            return img.mean()

        def grad(scene, seed):
            v = torch.tensor(base, device=scene.device, requires_grad=True)
            mean(scene, v, seed).backward()
            return float(v.grad)

        scene = mc.fd_tank_scene(res, device=device)
        t0 = time.perf_counter()
        with torch.no_grad():
            fd = [(float(mean(scene, torch.tensor(base + GRAD_H,
                                                  device=device), s))
                   - float(mean(scene, torch.tensor(base - GRAD_H,
                                                    device=device), s)))
                  / (2 * GRAD_H) for s in GRAD_SEEDS]
        ad = [grad(scene, s) for s in GRAD_SEEDS]
        fd_m, ad_m = float(np.mean(fd)), float(np.mean(ad))
        cpu = grad(mc.fd_tank_scene(res, device="cpu"), GRAD_SEEDS[0])
        out[field] = dict(fd=fd_m, grad=ad_m,
                          rel=abs(ad_m - fd_m) / max(abs(fd_m), 1e-6),
                          grad_seed20=ad[0], grad_seed20_cpu=cpu,
                          cpu_rel=abs(ad[0] - cpu) / max(abs(cpu), 1e-12),
                          seconds=time.perf_counter() - t0)
    phase("tank_grad", width=res, height=res, spp=cfg.spp,
          depth=cfg.max_depth, h=GRAD_H, seeds=list(GRAD_SEEDS),
          limit=GRAD_REL, **out)
    for field, r in out.items():
        if not r["rel"] < GRAD_REL or not np.isfinite(r["grad"]):
            raise AssertionError(f"tank_grad {field}: {r}")
        if not r["cpu_rel"] <= 1e-3:
            raise AssertionError(f"tank_grad {field}: card vs CPU {r}")
    return out


def media_vs_cpu(tag, device, scene_fn, trace_fn, res=MEDIA_CPU_RES):
    """A media path's lanes at res x res x 4 on the card and on the CPU
    (the same lanes, the same draws): the mean's distance, the share of
    lanes that differ beyond rtol 1e-4 (a Woodcock decision within an ulp,
    or the libraries' exp, log and erfinv, may send a lane another way)."""
    from mitsuba_tpu_torch.integrators.path import (
        PathConfig, camera_wavefront,
    )

    cfg = PathConfig(max_depth=5, spp=4, remat=False)
    out = []
    for dev in (device, torch.device("cpu")):
        scene = scene_fn(res, dev)
        ray, sampler, _ = camera_wavefront(scene, cfg, 0, morton=False)
        out.append(trace_fn(scene, ray, sampler, cfg).cpu())
    card, cpu = out
    rel = abs(float(card.mean()) - float(cpu.mean())) / max(
        float(cpu.mean()), 1e-12)
    differ = float((~torch.isclose(card, cpu, rtol=1e-4, atol=1e-6)).any(
        dim=-1).float().mean())
    phase("media_vs_cpu", path=tag, width=res, height=res, spp=cfg.spp,
          depth=cfg.max_depth, mean=float(card.mean()),
          mean_cpu=float(cpu.mean()), mean_rel=rel, lanes_differ=differ,
          limit=MEDIA_CPU_REL, finite=bool(torch.isfinite(card).all()))
    if not rel <= MEDIA_CPU_REL or not bool(torch.isfinite(card).all()):
        raise AssertionError(f"media_vs_cpu {tag}: mean {rel}")


def media_phases(device, tmp):
    """The media paths: the gates at 64x64 (a constant-density grid
    against fog's golden, guided fog against it, the tank against its
    Welch golden), the interior sigma's gradient, the five render phases
    (launch counts set to 0 just before the timed renders and read just
    after), and the card against the CPU. Returns each render phase's
    launch counts."""
    from mitsuba_tpu_torch.integrators.path import PathConfig
    from mitsuba_tpu_torch.integrators.volpath import (
        volpath_media_trace, volpath_trace,
    )
    from mitsuba_tpu_torch.io.xml import load_scene
    from mitsuba_tpu_torch.media import make_heterogeneous
    from mitsuba_tpu_torch.render.scene import cornell_box

    mc = _media_cases()
    grid, w2g = mc.const_grid_transform()
    const = make_heterogeneous(grid, w2g, FOG["sigma_s"], FOG["sigma_a"],
                               g=FOG["g"])
    gold = PathConfig(max_depth=5, spp=FOG_GOLDEN_SPP)
    golden_gate("golden_64_hetero_const", cornell_box(64, 64, device=device),
                "tests/torch_goldens/volpath_fog.npz", cfg=gold,
                render_fn=_medium_render(const), band=MEAN_BAND["volpath"])
    golden_gate("golden_64_guided", cornell_box(64, 64, device=device),
                "tests/torch_goldens/volpath_fog.npz", cfg=gold,
                render_fn=guided_render, band=MEAN_BAND["volpath"])
    golden_tank(device)
    tank_grad(device)

    cfg = PathConfig(max_depth=DEPTH1, spp=SPP1)
    t0 = time.perf_counter()
    xml = mc.hetero_cornell_xml(tmp, n=HX_GRID, sigma_t=HX_SIGMA_T,
                                albedo=HX_ALBEDO, g=HX_G)
    write_s = time.perf_counter() - t0
    params = dict(depth=DEPTH1, spp=SPP1, width=W1, height=H1)
    t0 = time.perf_counter()
    scene, xcfg = load_scene(xml, params=params, device=device)
    load_s = time.perf_counter() - t0
    med = xcfg["medium"]
    phase("hetero_xml_load", grid=list(med.density.shape),
          vol_bytes=os.path.getsize(os.path.join(tmp, "density.vol")),
          write_seconds=write_s, load_seconds=load_s,
          integrator=xcfg["integrator"],
          max_density=float(med.max_density))
    out = {}
    out["hetero_xml"] = render_phase(
        "hetero_xml", scene, cfg, ["shaded", "any"],
        render_fn=_medium_render(med), forbid=["shaded_any"])
    out["flake"] = render_phase(
        "flake", cornell_box(W1, H1, device=device), cfg, ["shaded", "any"],
        render_fn=_medium_render(flake_medium()), forbid=["shaded_any"])
    out["guided"] = render_phase(
        "guided", cornell_box(W1, H1, device=device), cfg,
        ["shaded", "any"], render_fn=guided_render, forbid=["shaded_any"])
    tcfg = PathConfig(max_depth=TANK_DEPTH, spp=TANK_SPP)
    out["tank"] = render_phase(
        "tank", mc.tank_scene(TANK_RES, device=device), tcfg, ["shaded"],
        render_fn=media_render, forbid=["shaded_any", "any"])
    out["tank_het"] = render_phase(
        "tank_het", mc.tank_scene(TANK_RES, mc.noise_grid(TANK_GRID, 6),
                                  device=device), tcfg, ["shaded"],
        render_fn=media_render, forbid=["shaded_any", "any"])

    def hetero_scene(res, dev):
        sc, _ = load_scene(xml, params=dict(params, width=res, height=res),
                           device=dev)
        return sc

    media_vs_cpu("hetero_xml", device, hetero_scene,
                 lambda sc, ray, smp, c: volpath_trace(
                     sc, med, ray, smp, c)[0])
    flake = flake_medium()
    media_vs_cpu("flake", device,
                 lambda res, dev: cornell_box(res, res, device=dev),
                 lambda sc, ray, smp, c: volpath_trace(
                     sc, flake, ray, smp, c)[0])
    media_vs_cpu("tank_het", device, lambda res, dev: mc.tank_scene(
        res, mc.noise_grid(TANK_GRID, 6), device=dev),
        lambda sc, ray, smp, c: volpath_media_trace(sc, ray, smp, c)[0])
    return out


def _slice_cases():
    """tests/torch_sss_cases.py (numpy only) and the port's modules."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_sss_cases as sc

    return sc, sc.port_modules()


def _lanes(w, h, spp, device):
    """(pixel_id, sample_id) of scanline lanes, int32."""
    lane = torch.arange(w * h * spp, device=device)
    return (lane // spp).to(torch.int32), (lane % spp).to(torch.int32)


def _cli_run(tag, argv):
    """cli.main(argv), launch counts set to 0 just before and read just
    after: (seconds, launches)."""
    from mitsuba_tpu_torch.cli import main as cli_main

    reset_launch_counts()
    t0 = time.perf_counter()
    if cli_main(argv) != 0:
        raise AssertionError(f"{tag}: the CLI exited non-zero")
    torch.cuda.synchronize()
    return time.perf_counter() - t0, launch_counts()


def _defs(**kv):
    return [a for k, v in kv.items() for a in ("-D", f"{k}={v}")]


def sss_phase(tag, device, tmp, form):
    """The slab's scene file (tests/torch_sss_cases.py SLAB_SUBSURFACE
    [form]) through cli.main at SSS_W x SSS_H x SSS_SPP, depth SSS_DEPTH,
    irrSamples SSS_IRR (the irradiance cache: #3 once a direct sample, 8;
    its indirect pass #1 3 times for each of 4 samples; the render #1 once
    a bounce); then io.xml.load_scene and the cache alone
    (prepare_scene_irradiance, timed), renders on the filled cache (twice
    timed, peak memory) and one whole render (cache included) under the
    profiler; the EXR, read back, equals the seed-0 render bit for bit."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.io.bitmap import read_exr
    from mitsuba_tpu_torch.io.xml import load_scene
    from mitsuba_tpu_torch.subsurface.dipole import prepare_scene_irradiance

    sc, _ = _slice_cases()
    xml = sc.write_slab_xml(tmp, form)
    defs = dict(depth=SSS_DEPTH, spp=SSS_SPP, width=SSS_W, height=SSS_H,
                irr=SSS_IRR)
    out = os.path.join(tmp, f"{tag}.exr")
    cli_s, cli_l = _cli_run(tag, [xml, *_defs(**defs), "-o", out])
    t0 = time.perf_counter()
    scene, cfg = load_scene(xml, params=defs, device=device)
    load_s = time.perf_counter() - t0
    pc = PathConfig(max_depth=SSS_DEPTH, spp=SSS_SPP, remat=False)
    torch.cuda.reset_peak_memory_stats()
    cache_s, secs, launches, means = [], [], [], []
    for seed in (0, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        filled = dataclasses.replace(scene, subsurface=(
            prepare_scene_irradiance(scene, seed=seed)))
        torch.cuda.synchronize()
        cache_s.append(time.perf_counter() - t0)
        reset_launch_counts()
        t0 = time.perf_counter()
        img, aux = render(filled, pc, seed=seed)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append(launch_counts())
        means.append(float(img.mean()))
        if seed == 0:
            ref = img.cpu().numpy()
            same = bool(np.array_equal(read_exr(out), ref))
            finite = bool(np.isfinite(ref).all())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = device_profile(lambda: render(scene, pc, seed=0))
    PROFILES[tag] = prof
    ss = scene.subsurface
    band = MEAN_BAND[tag]
    want_cli = dict(shaded_any=4 * 3 + SSS_DEPTH, any=8)
    phase(tag, command=["python", "-m", "mitsuba_tpu_torch",
                        os.path.basename(xml)] + _defs(**defs)
          + ["-o", f"{tag}.exr"], form=form, width=SSS_W, height=SSS_H,
          spp=SSS_SPP, depth=SSS_DEPTH, lanes=SSS_W * SSS_H * SSS_SPP,
          entries=ss.n_entries, points=int(ss.points.shape[1]),
          poles=int(ss.zri.shape[1]), triangles=scene.geom.n_tris,
          cli_seconds=cli_s, load_seconds=load_s, cache_seconds=cache_s,
          seconds=secs, seconds_with_cache=[c + s for c, s in
                                            zip(cache_s, secs)],
          launches_cli={k: cli_l[k] for k in want_cli},
          launches_render=[{k: ln[k] for k in want_cli} for ln in launches],
          means=means, band=band, peak_mem_gib=peak, exr_equals_render=same,
          device_busy_ms=prof["device_busy_ms"],
          busy_share=prof["busy_share"], profile_wall_ms=prof["wall_ms"],
          kernels=prof["kernels"],
          own_ms=prof["own"].get("brute_kernel", {}).get("instances"),
          top=prof["top"])
    if not same or not finite:
        raise AssertionError(f"{tag}: the EXR differs from the render or "
                             "is not finite")
    if any(cli_l[k] != n for k, n in want_cli.items()) or any(
            ln["shaded_any"] != SSS_DEPTH or ln["any"] for ln in launches):
        raise AssertionError(f"{tag}: launches {cli_l}, {launches}")
    if not all(band[0] < m < band[1] for m in means):
        raise AssertionError(f"{tag}: means {means} outside {band}")
    return dict(shaded_any=cli_l["shaded_any"], any=cli_l["any"])


def _stats_gate(tag, L, spp, res, golden, **extra):
    """tests/test_goldens.py's rule on lanes L (res*res*spp, 3) in
    scanline order against `golden` (a path under the repo)."""
    Ls = L.reshape(res, res, spp, 3).double()
    mean = Ls.mean(dim=2).cpu().numpy()
    var = Ls.var(dim=2, unbiased=True).cpu().numpy()
    g = np.load(os.path.join(ROOT, golden))
    se = np.sqrt(var / spp + g["var"] / int(g["spp"]))
    t = (mean - g["mean"]) / np.maximum(se, 1e-6)
    frac = float((np.abs(t) > GOLD_CRIT).any(axis=-1).mean())
    phase(tag, golden=golden, width=res, height=res, spp=spp,
          golden_spp=int(g["spp"]), fail_fraction=frac, limit=GOLD_FAIL_MAX,
          crit=GOLD_CRIT, mean=float(mean.mean()),
          golden_mean=float(g["mean"].mean()),
          finite=bool(np.isfinite(mean).all()), **extra)
    if not frac < GOLD_FAIL_MAX or not np.isfinite(mean).all():
        raise AssertionError(f"{tag}: fail fraction {frac}")


def slice_goldens(device):
    """golden_sss_slab and golden_guided_cornell: the port's renders of
    tests/golden_scenes.py's sss_slab (the cache at seed 99) and
    guided_cornell (a res-12 guide learned on the same camera rays by a
    sampler at seed 777 + 5, then the guided estimator, alpha 0.5) at
    GOLD_RES, GOLD_SPP spp, depth 4, seed 777, against the JAX package's
    256-spp goldens by the |t| > 3.9 rule."""
    from mitsuba_tpu_torch.integrators.guiding import make_guide
    from mitsuba_tpu_torch.integrators.path import (
        PathConfig, camera_wavefront, path_trace,
    )
    from mitsuba_tpu_torch.render.sampler import Sampler
    from mitsuba_tpu_torch.render.scene import cornell_box
    from mitsuba_tpu_torch.subsurface.dipole import prepare_scene_irradiance

    sc, mods = _slice_cases()
    cfg = PathConfig(max_depth=sc.SLAB_DEPTH, spp=GOLD_SPP, remat=False)
    scene = sc.slab_scene(mods, GOLD_RES, device=device)
    scene = dataclasses.replace(scene, subsurface=prepare_scene_irradiance(
        scene, seed=SSS_CACHE_SEED))
    ray, sampler, _ = camera_wavefront(scene, cfg, GOLD_SEED, morton=False)
    L, _ = path_trace(scene, ray, sampler, cfg)
    _stats_gate("golden_sss_slab", L, GOLD_SPP, GOLD_RES,
                "tests/goldens/sss_slab.npz", depth=cfg.max_depth,
                seed=GOLD_SEED, cache_seed=SSS_CACHE_SEED)
    scene = cornell_box(GOLD_RES, GOLD_RES, device=device)
    v0 = scene.geom.v0.cpu().numpy()
    ext = v0.max(0) - v0.min(0)
    guide = make_guide(v0.min(0) - 0.01 * ext, v0.max(0) + 0.01 * ext,
                       res=GUIDE_GOLD_RES, device=device)
    ray, sampler, _ = camera_wavefront(scene, cfg, GOLD_SEED, morton=False)
    pid, sid = _lanes(GOLD_RES, GOLD_RES, GOLD_SPP, device)
    _, aux = path_trace(scene, ray, Sampler(GUIDE_LEARN_SEED, pid, sid),
                        cfg, guide=guide, learn_guide=True)
    L, _ = path_trace(scene, ray, sampler, cfg, guide=aux["guide"],
                      guide_alpha=0.5, guide_sampling=True)
    _stats_gate("golden_guided_cornell", L, GOLD_SPP, GOLD_RES,
                "tests/goldens/guided_cornell.npz", depth=cfg.max_depth,
                seed=GOLD_SEED, guide_res=GUIDE_GOLD_RES,
                learn_seed=GUIDE_LEARN_SEED,
                guide_mass=float(aux["guide"].mass.sum()))


def guided_cli_phase(device, tmp):
    """`python -m mitsuba_tpu_torch scenes/cornell.xml --guided` at SSS_W x
    SSS_H x SSS_SPP, depth CLI_DEPTH through cli.main (render_guided: a
    learning pass and a guided pass, #1 once a bounce each); then the file
    through load_scene and render_guided, twice timed (peak memory) and
    once profiled. The learning pass adds by index_add, in atomic order on
    the card, so the library's image is compared with the EXR's by its
    largest difference, not bit for bit."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, render_guided
    from mitsuba_tpu_torch.io.bitmap import read_exr
    from mitsuba_tpu_torch.io.xml import load_scene

    tag = "guided_cli"
    xml = os.path.join(ROOT, "scenes", "cornell.xml")
    defs = dict(depth=CLI_DEPTH, spp=SSS_SPP, width=SSS_W, height=SSS_H)
    out = os.path.join(tmp, "guided.exr")
    cli_s, cli_l = _cli_run(tag, [xml, *_defs(**defs), "-o", out,
                                  "--guided"])
    scene, _ = load_scene(xml, params=defs, device=device)
    pc = PathConfig(max_depth=CLI_DEPTH, spp=SSS_SPP, remat=False)
    torch.cuda.reset_peak_memory_stats()
    secs, launches, means, rays = [], [], [], []
    for seed in (0, 1):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, aux = render_guided(scene, pc, seed=seed)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append(launch_counts()["shaded_any"])
        means.append(float(img.mean()))
        rays.append(int(aux["rays_traced"]))
        if seed == 0:
            exr_diff = float(np.abs(read_exr(out) - img.cpu().numpy()).max())
            finite = bool(torch.isfinite(img).all())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = device_profile(lambda: render_guided(scene, pc, seed=0))
    PROFILES[tag] = prof
    band = MEAN_BAND[tag]
    phase(tag, command=["python", "-m", "mitsuba_tpu_torch",
                        "scenes/cornell.xml"] + _defs(**defs)
          + ["-o", "guided.exr", "--guided"], width=SSS_W, height=SSS_H,
          spp=SSS_SPP, depth=CLI_DEPTH, cli_seconds=cli_s, seconds=secs,
          rays_traced=rays, mrays_per_s=[r / t / 1e6 for r, t in
                                         zip(rays, secs)],
          launches_cli=cli_l["shaded_any"], launches_render=launches,
          means=means, band=band, exr_max_abs_diff=exr_diff,
          peak_mem_gib=peak, device_busy_ms=prof["device_busy_ms"],
          busy_share=prof["busy_share"], profile_wall_ms=prof["wall_ms"],
          kernels=prof["kernels"], top=prof["top"])
    if not finite or cli_l["shaded_any"] != 2 * CLI_DEPTH \
            or launches != [2 * CLI_DEPTH] * 2:
        raise AssertionError(f"{tag}: finite {finite}, launches {cli_l}, "
                             f"{launches}")
    if not all(band[0] < m < band[1] for m in means):
        raise AssertionError(f"{tag}: means {means} outside {band}")
    return cli_l["shaded_any"]


def motion_phase(device, tmp):
    """tests/test_motion.py:25's moving box as a scene file (an
    animatedinstance whose track the port's save_animated_transform
    writes, shutterClose 1) through cli.main at SSS_W x SSS_H x SSS_SPP,
    depth CLI_DEPTH: render_motion over MOTION_BINS scenes baked at
    stratified shutter times (#1 once a bounce each); the bins' builds
    timed apart (load_scene); render_motion twice timed and once
    profiled; the EXR equal to the seed-0 render bit for bit; gated by
    tests/test_motion.py:80-110 against the builder's box baked at
    mid-shutter."""
    from mitsuba_tpu_torch.integrators.path import (
        PathConfig, render, render_motion,
    )
    from mitsuba_tpu_torch.io.bitmap import read_exr
    from mitsuba_tpu_torch.io.xml import load_scene

    tag = "motion_xml"
    sc, mods = _slice_cases()
    xml = sc.write_motion_xml(tmp, mods.track)
    defs = dict(depth=CLI_DEPTH, spp=SSS_SPP, width=SSS_W, height=SSS_H)
    out = os.path.join(tmp, "motion.exr")
    cli_s, cli_l = _cli_run(tag, [xml, *_defs(**defs), "-o", out])
    t0 = time.perf_counter()
    _, cfg = load_scene(xml, params=defs, device=device)
    load_s = time.perf_counter() - t0
    scenes = cfg["time_scenes"]
    pc = PathConfig(max_depth=CLI_DEPTH, spp=SSS_SPP, remat=False)
    torch.cuda.reset_peak_memory_stats()
    secs, launches = [], []
    for seed in (0, 1):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, aux = render_motion(scenes, pc, seed=seed)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append(launch_counts()["shaded_any"])
        if seed == 0:
            img_m = img.cpu().numpy()
            same = bool(np.array_equal(read_exr(out), img_m))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = device_profile(lambda: render_motion(scenes, pc, seed=0))
    PROFILES[tag] = prof
    b = sc.moving_box_builder(mods, SSS_W, 1.0)
    img_s = render(b.build(backend="brute", device=device, time=0.5), pc,
                   seed=0)[0].cpu().numpy()

    def x_extent(img):
        cols = np.where((img.mean(-1) > 0.35).any(0))[0]
        return int(cols.max() - cols.min()) if len(cols) else 0

    ext_m, ext_s = x_extent(img_m), x_extent(img_s)
    energy = float(abs(img_m.mean() - img_s.mean()) / img_s.mean())
    band = MEAN_BAND[tag]
    mean = float(img_m.mean())
    phase(tag, command=["python", "-m", "mitsuba_tpu_torch",
                        "motion.xml"] + _defs(**defs) + ["-o", "motion.exr"],
          width=SSS_W, height=SSS_H, spp=SSS_SPP, depth=CLI_DEPTH,
          time_bins=len(scenes), cli_seconds=cli_s, load_seconds=load_s,
          seconds=secs, launches_cli=cli_l["shaded_any"],
          launches_render=launches, mean=mean, band=band,
          exr_equals_render=same, x_extent=ext_m, x_extent_mid=ext_s,
          energy_rel=energy, limits=dict(smear=MOTION_SMEAR,
                                         energy=MOTION_ENERGY),
          peak_mem_gib=peak, device_busy_ms=prof["device_busy_ms"],
          busy_share=prof["busy_share"], profile_wall_ms=prof["wall_ms"],
          kernels=prof["kernels"], top=prof["top"])
    if not same or not np.isfinite(img_m).all():
        raise AssertionError(f"{tag}: the EXR differs from the render or "
                             "is not finite")
    want = MOTION_BINS * CLI_DEPTH
    if cli_l["shaded_any"] != want or launches != [want, want]:
        raise AssertionError(f"{tag}: launches {cli_l}, {launches}")
    if not (ext_m > ext_s + MOTION_SMEAR and energy < MOTION_ENERGY
            and band[0] < mean < band[1]):
        raise AssertionError(f"{tag}: extent {ext_m} vs {ext_s}, energy "
                             f"{energy}, mean {mean}")
    return cli_l["shaded_any"]


def config1_options(device):
    """Config 1 (cornell_box at W1 x H1 x SPP1, depth DEPTH1, seed 0) with
    hit_prediction: the image bit for bit config 1's (the bound is
    exact), pred_hit_frac reported; with strict_normals: finite and within
    config 1's band; each render's #1 launches and seconds."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.render.scene import cornell_box

    scene = cornell_box(W1, H1, device=device)
    base = PathConfig(max_depth=DEPTH1, spp=SPP1)
    res = {}
    imgs = {}
    for name, kw in (("plain", {}), ("hit_prediction", {
            "hit_prediction": True}), ("strict_normals", {
            "strict_normals": True})):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, aux = render(scene, dataclasses.replace(base, **kw), seed=0)
        torch.cuda.synchronize()
        imgs[name] = img
        res[name] = dict(seconds=time.perf_counter() - t0,
                         launches_shaded_any=launch_counts()["shaded_any"],
                         mean=float(img.mean()),
                         pred_hit_frac=float(aux["pred_hit_frac"]),
                         finite=bool(torch.isfinite(img).all()))
    same = bool(torch.equal(imgs["plain"], imgs["hit_prediction"]))
    band = MEAN_BAND["config1"]
    phase("config1_options", width=W1, height=H1, spp=SPP1, depth=DEPTH1,
          prediction_equals_plain=same, band=band, **res)
    if not same:
        raise AssertionError("config1_options: hit_prediction changed the "
                             "image")
    sn = res["strict_normals"]
    if not sn["finite"] or not band[0] < sn["mean"] < band[1]:
        raise AssertionError(f"config1_options: strict_normals {sn}")
    return {k: v["launches_shaded_any"] for k, v in res.items()}


def config3_options(scene3, cfg, l3):
    """Config 3 with sort_mode="octant" and with hit_prediction as render
    phases (#9 and #10 as config 3), each seed-0 image within 1e-6 of
    config 3's."""
    from mitsuba_tpu_torch.integrators.path import render

    ref = render(scene3, cfg, seed=0)[0]
    out = {}
    for tag, kw in (("config3_octant", dict(sort_mode="octant")),
                    ("config3_pred", dict(hit_prediction=True))):
        c = dataclasses.replace(cfg, **kw)
        out[tag] = render_phase(tag, scene3, c,
                                ["refine", "child_refine", "l1_masked"],
                                forbid=["items", "l1_items"])
        img, aux = render(scene3, c, seed=0)
        diff = float((img - ref).abs().max())
        phase(f"{tag}_vs_config3", max_abs_diff=diff, limit=1e-6,
              equal=bool(torch.equal(img, ref)),
              pred_hit_frac=float(aux["pred_hit_frac"]),
              launches=out[tag], config3_launches=l3)
        if not diff <= 1e-6:
            raise AssertionError(f"{tag}: {diff} from config 3's image")
    return out


# ---------------------------------------------------------------------------
# what scene files could not name before: analytic cylinders, the woven
# cloth, <blackbody>, JPEG, hspan and tessellated hair (ROADMAP A.15, A.11)
# ---------------------------------------------------------------------------

def _leftover_cases():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_leftover_cases as lc

    return lc


def _file_golden(tag, path, device):
    """golden_stats of the scene file `path` loaded at its golden's size
    and depth."""
    from mitsuba_tpu_torch.io.xml import load_scene

    g = np.load(os.path.join(ROOT, STATS_GOLDENS[tag]))
    res = g["mean"].shape[0]
    scene, cfg = load_scene(path, params=dict(
        depth=int(g["depth"]), spp=GOLD_SPP, width=res, height=res),
        device=device)
    golden_stats(tag, scene, int(g["depth"]), pattern=cfg["pattern"])


def _load_phase(tag, path, defs, device, **kw):
    """load_scene of `path`, its time and the scene's counts in a line."""
    from mitsuba_tpu_torch.io.xml import load_scene

    t0 = time.perf_counter()
    scene, cfg = load_scene(path, params=defs, device=device, **kw)
    torch.cuda.synchronize()
    g = scene.geom
    phase(tag, seconds=time.perf_counter() - t0, backend=g.backend,
          triangles=g.n_tris, spheres=g.n_spheres, cylinders=g.n_cylinders,
          hair_segments=g.n_hair,
          materials=scene.materials.kind.tolist(),
          media=0 if scene.media is None else int(scene.media.n_media),
          emitter_radiance=scene.emitters.radiance.tolist()[:4])
    return scene


def leftovers_phases(device, tmp):
    """The analytic cylinders, the cloth, <blackbody>, JPEG, hspan and
    tessellated hair: cylinders.xml and cloth.xml through the CLI
    (cli_phase, #1 5 a render) and their goldens; the cylinder's medium
    through render_volpath_media (#2); config 3's twin with eight
    cylinders on cluster (#5, #6, #9, #10) and bvh (#11); leftovers.xml
    through the CLI on cluster, written as EXR and JPEG, and its golden.
    Returns each phase's launch counts."""
    from mitsuba_tpu_torch.integrators.path import PathConfig

    lc = _leftover_cases()
    t0 = time.perf_counter()
    cyl = lc.write_cylinders_xml(tmp)
    med = lc.write_cylinders_xml(tmp, media=True)
    cloth = lc.write_cloth_xml(tmp)
    phase("leftover_files", seconds=time.perf_counter() - t0,
          files=sorted(os.listdir(tmp)))
    out = {"cylinders_xml": cli_phase("cylinders_xml", device, tmp,
                                      "cylinders", xml=cyl)}
    _file_golden("golden_cylinders", cyl, device)
    out["cloth_xml"] = cli_phase("cloth_xml", device, tmp, "cloth",
                                 xml=cloth, spp=LEFT_SPP)
    _file_golden("golden_cloth", cloth, device)
    scene = _load_phase("cylinder_media_load", med, dict(
        depth=TANK_DEPTH, spp=TANK_SPP, width=TANK_RES, height=TANK_RES),
        device)
    out["cylinder_media"] = render_phase(
        "cylinder_media", scene, PathConfig(max_depth=TANK_DEPTH,
                                            spp=TANK_SPP), ["shaded"],
        render_fn=media_render, forbid=["shaded_any", "any"])
    del scene
    d3 = os.path.join(tmp, "config3_cylinders")
    os.mkdir(d3)
    path = lc.write_config3_cylinders(d3)
    defs = dict(depth=DEPTH3, spp=SPP3, width=W3, height=H3)
    cfg = PathConfig(max_depth=DEPTH3, spp=SPP3)
    scene = _load_phase("cylinders_cluster_load", path, defs, device)
    out["cylinders_cluster"] = render_phase(
        "cylinders_cluster", scene, cfg,
        ["refine", "child_refine", "l1_masked"], forbid=["items",
                                                         "l1_items"])
    del scene
    scene = _load_phase("cylinders_bvh_load", path, defs, device,
                        backend="bvh")
    out["cylinders_bvh"] = render_phase("cylinders_bvh", scene, cfg,
                                        ["bvh_closest", "bvh_any"])
    del scene
    dl = os.path.join(tmp, "leftovers")
    os.mkdir(dl)
    t0 = time.perf_counter()
    left = lc.write_leftovers_xml(dl, LEFT_CELLS, LEFT_FIBERS, LEFT_TEX)
    phase("leftovers_files", seconds=time.perf_counter() - t0,
          cells=LEFT_CELLS, fibers=LEFT_FIBERS, texels=LEFT_TEX ** 2,
          bytes={f: os.path.getsize(os.path.join(dl, f))
                 for f in sorted(os.listdir(dl))})
    out["leftovers_xml"] = cli_phase(
        "leftovers_xml", device, dl, "leftovers", xml=left, spp=LEFT_SPP,
        need=("refine", "child_refine", "l1_masked"), jpeg=True)
    g = np.load(os.path.join(ROOT, STATS_GOLDENS["golden_leftovers"]))
    dg = os.path.join(tmp, "leftovers_golden")
    os.mkdir(dg)
    _file_golden("golden_leftovers", lc.write_leftovers_xml(
        dg, int(g["cells"]), int(g["fibers"]), int(g["tex"])), device)
    return out


# ---------------------------------------------------------------------------
# analytic hair and the integrators outside the CLI (ROADMAP A.12)
# ---------------------------------------------------------------------------

def hair_walk_phase(tag, scene, cfg):
    """One render at seed 0 with its hair walks recorded: the walk steps a
    render (closest and any), then the recorded walks replayed alone once
    under the profiler (their wall s, device ms, busy share and kernels a
    render). Returns them with the render's mean."""
    from mitsuba_tpu_torch.integrators.path import render
    from mitsuba_tpu_torch.render import intersect as ri

    for k in ri.HAIR_STEPS:
        ri.HAIR_STEPS[k] = 0
    (img, _), calls = record_calls(ri, ("_hair_walk",),
                                   lambda: render(scene, cfg, seed=0))
    steps = dict(ri.HAIR_STEPS)
    walks = calls["_hair_walk"]

    def replay():
        for geom, ray, any_hit in walks:
            ri._hair_walk(geom, ray, any_hit)

    prof = device_profile(replay)
    phase(tag, width=scene.width, height=scene.height, spp=cfg.spp,
          depth=cfg.max_depth, segments=scene.geom.n_hair,
          nodes=int(scene.geom.hair_nodes.shape[0]), walks=len(walks),
          lanes=[int(w[1].o.shape[0]) for w in walks], steps=steps,
          replay_seconds=prof["wall_ms"] / 1e3,
          device_busy_ms=prof["device_busy_ms"],
          busy_share=prof["busy_share"], kernels=prof["kernels"],
          top=prof["top"][:6])
    return dict(steps=steps, device_ms=prof["device_busy_ms"],
                launches=prof["kernels"], mean=float(img.mean()))


def hair_phases(device, tmp):
    """hair_xml through the CLI, its walk, its golden and the tessellated
    fibres' mean; hair_cluster (leftovers.xml with analytic fibres).
    Returns the phases' launch counts."""
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.io.xml import load_scene

    lc = _leftover_cases()
    dh = os.path.join(tmp, "hair")
    os.mkdir(dh)
    t0 = time.perf_counter()
    path = lc.write_hair_cornell_xml(dh, HAIR_FIBERS)
    tess = lc.write_hair_cornell_xml(dh, HAIR_FIBERS, tessellate=True)
    phase("hair_files", seconds=time.perf_counter() - t0,
          fibers=HAIR_FIBERS, bytes={f: os.path.getsize(os.path.join(dh, f))
                                     for f in sorted(os.listdir(dh))})
    out = {"hair_xml": cli_phase("hair_xml", device, dh, "hair_cornell",
                                 xml=path, spp=LEFT_SPP)}
    defs = dict(depth=DEPTH3, spp=SPP3, width=W3, height=H3)
    cfg = PathConfig(max_depth=DEPTH3, spp=SPP3)
    scene = _load_phase("hair_xml_load", path, defs, device)
    out["hair_walk"] = hair_walk_phase("hair_walk", scene, cfg)
    ma = out["hair_walk"]["mean"]
    del scene
    scene = _load_phase("hair_tess_load", tess, defs, device)
    mt = float(render(scene, cfg, seed=0)[0].mean())
    del scene
    rel = abs(ma - mt) / max(mt, 1e-6)
    phase("hair_tess", width=W3, height=H3, spp=SPP3, depth=DEPTH3,
          analytic_mean=ma, tessellated_mean=mt, rel=rel,
          limit=HAIR_TESS_REL)
    if not rel < HAIR_TESS_REL:
        raise AssertionError(f"hair_tess: means {ma} and {mt}")
    g = np.load(os.path.join(ROOT, STATS_GOLDENS["golden_hair"]))
    dg = os.path.join(tmp, "hair_golden")
    os.mkdir(dg)
    _file_golden("golden_hair", lc.write_hair_cornell_xml(
        dg, int(g["fibers"])), device)
    dl = os.path.join(tmp, "hair_cluster")
    os.mkdir(dl)
    left = lc.write_leftovers_xml(dl, LEFT_CELLS, LEFT_FIBERS, LEFT_TEX,
                                  analytic=True)
    scene = _load_phase("hair_cluster_load", left, defs, device)
    out["hair_cluster"] = render_phase(
        "hair_cluster", scene, cfg, ["refine", "child_refine", "l1_masked"],
        forbid=["items", "l1_items"])
    del scene
    return out


def _integrators():
    """name -> (call (scene, cfg) -> (image, aux), kernels it launches
    on the brute box)."""
    from mitsuba_tpu_torch.integrators import (
        adaptive, bre, irrcache, photonmap, vpl,
    )
    from mitsuba_tpu_torch.media import make_homogeneous

    fog = make_homogeneous(**FOG)
    return {
        "photonmap": (photonmap.photonmap_render, ["shaded"]),
        "ppm": (photonmap.ppm_render, ["shaded"]),
        "photonmapper": (photonmap.photonmapper_render, ["shaded", "any"]),
        "sppm": (photonmap.sppm_render, ["shaded"]),
        "irrcache": (irrcache.irrcache_render, ["shaded_any", "shaded"]),
        "vpl": (vpl.render_vpl, ["shaded", "any"]),
        "adaptive": (adaptive.adaptive_render, ["shaded_any"]),
        "bre": (lambda scene, cfg: bre.bre_render(scene, fog, cfg),
                ["shaded"]),
    }


def _aux_numbers(aux):
    """The numbers of an integrator's aux dict (render_vpl returns its
    VPLs instead: their count)."""
    if not isinstance(aux, dict):
        return dict(vpls=int(aux.p.shape[0]), valid=int(aux.valid.sum()))
    return {k: v for k, v in aux.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def integrator_phase(tag, fn, scene, cfg, need, band):
    """fn(scene, cfg) once under the profiler, every launch count set to 0
    just before and read just after: its seconds (the profiled wall
    time; the trace records the device alone), launches, peak memory,
    device busy ms and share."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = {}
    prof = device_profile(lambda: res.update(out=fn(scene, cfg)))
    img, aux = res["out"]
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    PROFILES[tag] = prof
    mean = float(img.mean())
    extra = {}
    if isinstance(aux, dict) and "sample_count" in aux:
        extra = dict(passes=aux["passes"],
                     samples_mean=float(aux["sample_count"].float().mean()))
    phase(tag, width=scene.width, height=scene.height, spp=cfg.spp,
          depth=cfg.max_depth, backend=scene.geom.backend,
          seconds=prof["wall_ms"] / 1e3,
          launches={k: v for k, v in launches.items() if v},
          peak_mem_gib=peak, device_busy_ms=prof["device_busy_ms"],
          busy_share=prof["busy_share"], kernels=prof["kernels"],
          own=prof["own"], top=prof["top"][:6], mean=mean, band=band,
          aux=_aux_numbers(aux), **extra)
    if tuple(img.shape) != (scene.height, scene.width, 3) \
            or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{tag} image is not finite or misshapen")
    if not band[0] < mean < band[1]:
        raise AssertionError(f"{tag} mean {mean} outside {band}")
    for k in need:
        if launches[k] < 1:
            raise AssertionError(f"{tag}: kernel {k} was never launched")
    return launches


def integrators_phases(device, tmp):
    """Each integrator at full size on the box, sppm on the cluster
    backend, then the 48x48 gates. Config 3's scene is lit by its sky
    alone, and photons leave finite lights alone (ptracer.py
    `_sample_emission`, as the reference's): the reference's sppm_render
    raises there for want of a deposit. The cluster photon phase takes
    leftovers.xml (310,050 triangles, a blackbody area light) at W3 x
    H3. Returns each phase's launch counts."""
    from mitsuba_tpu_torch.integrators.path import PathConfig
    from mitsuba_tpu_torch.integrators.photonmap import sppm_render
    from mitsuba_tpu_torch.render.scene import cornell_box

    golden = np.load(os.path.join(ROOT, "tests/torch_goldens/"
                                  "integrators.npz"))
    cfg = PathConfig(max_depth=INTEG_DEPTH, spp=INTEG_SPP)
    box = cornell_box(INTEG_RES, INTEG_RES, device=device)
    out = {}
    for name, (fn, need) in _integrators().items():
        m = float(golden[name].mean())
        out[name] = integrator_phase(name, fn, box, cfg, need,
                                     (0.6 * m, 1.4 * m))
    del box
    dl = os.path.join(tmp, "photons_cluster")
    os.mkdir(dl)
    scene = _load_phase("photons_cluster_load", _leftover_cases()
                        .write_leftovers_xml(dl, LEFT_CELLS, LEFT_FIBERS,
                                             LEFT_TEX),
                        dict(depth=DEPTH3, spp=1, width=W3, height=H3),
                        device)
    out["photons_cluster"] = integrator_phase(
        "photons_cluster", sppm_render, scene,
        PathConfig(max_depth=DEPTH3, spp=1),
        ["refine", "child_refine", "l1_masked"],
        MEAN_BAND["photons_cluster"])
    del scene
    box = cornell_box(INTEG_GOLD_RES, INTEG_GOLD_RES, device=device)

    def blocks(a, b=8):
        h, w, c = a.shape
        return a.reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))

    rels = {}
    for name, (fn, _) in _integrators().items():
        img = fn(box, cfg)[0].cpu().numpy()
        rb, ib = blocks(golden[name]), blocks(img)
        rels[name] = float(np.sqrt(np.mean((ib - rb) ** 2))
                           / max(rb.mean(), 1e-9))
        if not np.isfinite(img).all():
            rels[name] = float("inf")
    phase("golden_integrators", golden="tests/torch_goldens/integrators.npz",
          width=INTEG_GOLD_RES, height=INTEG_GOLD_RES, spp=INTEG_SPP,
          depth=INTEG_DEPTH, block=8, rel_rmse=rels,
          limit=INTEG_REL_RMSE_MAX)
    bad = {k: v for k, v in rels.items() if not v <= INTEG_REL_RMSE_MAX}
    if bad:
        raise AssertionError(f"golden_integrators: {bad}")
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "one NVIDIA GPU.")
    ap.add_argument("--parent", metavar="FILE",
                    help="the output of another tree's run (e.g. the "
                    "parent commit's): its kernel_vs_plain times join "
                    "this run's lines as parent_ms")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.parent:
        read_parent(args.parent)
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from mitsuba_tpu_torch.integrators.path import PathConfig, render
    from mitsuba_tpu_torch.ops import build as nv
    from mitsuba_tpu_torch.ops import bvh as bp
    from mitsuba_tpu_torch.ops import cluster as cp
    from mitsuba_tpu_torch.ops import exact as ep
    from mitsuba_tpu_torch.ops import intersect as ip
    from mitsuba_tpu_torch.ops import probes as pr
    from mitsuba_tpu_torch.ops import stream as sp
    from mitsuba_tpu_torch.ops import worklist as wl
    from mitsuba_tpu_torch.probes import r3_kernel
    from mitsuba_tpu_torch.render import bvh as rb
    from mitsuba_tpu_torch.render.scene import (
        cornell_box, cornell_box_specular, instanced_scene,
        textured_mesh_scene,
    )

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    phase("device", name=name, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    mods = (ip, ep, sp, bp, wl, cp, rb, pr)
    logs = nv.build_all([mod.SOURCE for mod in mods])   # all at once
    for mod in mods:
        mod.build()                       # bind the built libraries
    phase("build", seconds=time.perf_counter() - t0,
          ptxas={os.path.basename(src): [
              ln.strip() for ln in log.splitlines()
              if "ptxas" in ln or "stack frame" in ln]
              for src, log in logs.items()})
    # the redesigned walks' resources: rows resident per SM, registers,
    # shared memory per row (config 3's list widths; K = 32)
    phase("walk_resources",
          l1_masked={f"E2 {e2} {'any' if a else 'closest'}":
                     ep.l1_masked_info(e2, ep.V6B_BLM, a)
                     for e2 in (32, 384, 768) for a in (False, True)},
          stream={"any" if a else "closest": sp.stream_info(32, a)
                  for a in (False, True)},
          worklist={f"{'any' if a else 'closest'} "
                    f"{'instanced' if i else 'flat'}": wl.wl_info(32, a, i)
                    for a in (False, True) for i in (False, True)},
          bvh={"any" if a else "closest": bp.bvh_info(a)
               for a in (False, True)},
          items={f"E3 {e3} {'any' if a else 'closest'}":
                 ep.items_info(e3, a)
                 for e3 in (96, 512, 1024) for a in (False, True)},
          l1_items={f"E2 {e2} {'any' if a else 'closest'}":
                    ep.l1_items_info(e2, a)
                    for e2 in (32, 384, 768) for a in (False, True)},
          refine={"refine": ep.refine_info(False),
                  "child_refine": ep.refine_info(True)},
          brute={k: ip.brute_info(k) for k in ip.BRUTE_KERNELS},
          cluster={"any" if a else "closest": cp.cluster_info(a)
                   for a in (False, True)},
          wl_probe=wl.wl_probe_info(32))

    t0 = time.perf_counter()
    scene3 = textured_mesh_scene(W3, H3, backend="cluster", device=device)
    scene3_v5, scene3_v6 = (dataclasses.replace(
        scene3, geom=dataclasses.replace(scene3.geom, ex_walk=w))
        for w in ("v5", "v6"))
    cl = cp.table_dict(cp.geometry_tables(scene3.geom), device)
    scene_bvh = textured_mesh_scene(W3, H3, device=device)
    scene_inst = instanced_scene(W3, H3, device=device)
    scene_flat = instanced_scene(W3, H3, flatten=True, device=device)
    phase("scenes", seconds=time.perf_counter() - t0,
          config3=dict(triangles=scene3.geom.n_tris,
                       k8_clusters=scene3.geom.ex_tri.shape[0],
                       caps=scene3.geom.ex_caps, v6b_blm=ep.V6B_BLM,
                       v1_superclusters=int(cl["G"].shape[0])),
          bvh=dict(backend=scene_bvh.geom.backend,
                   triangles=scene_bvh.geom.n_tris,
                   nodes=scene_bvh.geom.bvh_packed.shape[0]),
          instanced=dict(triangles=scene_inst.geom.n_tris,
                         group_triangles=[
                             g.n_tris for g in scene_inst.geom.inst_groups],
                         instances=len(scene_inst.geom.inst_gid),
                         clusters=scene_inst.geom.mt_block_id.shape[0],
                         blocks=scene_inst.geom.mt_tri.shape[0],
                         max_clusters=wl.MAX_CLUSTERS),
          flat=dict(triangles=scene_flat.geom.n_tris,
                    clusters=scene_flat.geom.mt_start.shape[0]))

    brute_check = compare_kernel(cornell_box(W1, H1, device=device))
    fog_cfg = PathConfig(max_depth=DEPTH1, spp=SPP1)
    split = compare_split_kernels(cornell_box(W1, H1, device=device),
                                  fog_cfg)
    compare_brute_cases(device)
    cluster = compare_cluster_kernels(scene3)
    compare_walk_cases(device)
    compare_refine_cases(device)
    compare_instanced_cases(device)
    compare_v1_cases(device)
    cam3, bounce3, shadow3 = wavefronts(scene3)
    v1 = compare_cluster_v1(cl, (("camera", cam3, False),
                                 ("bounce", bounce3, False),
                                 ("shadow", shadow3, True)))
    bvh = compare_bvh_kernels(scene_bvh)
    worklist = compare_worklist_kernels(scene_inst, scene_flat)
    del scene_flat
    inst_waves = wavefronts(scene_inst)
    compare_worklist_full_chunks(scene_inst, (
        ("camera", inst_waves[0], False), ("bounce", inst_waves[1], False),
        ("shadow", inst_waves[2], True)))
    del inst_waves
    golden_gate("golden_64", cornell_box(64, 64, device=device),
                "tests/goldens/bench_cfg1.npz")
    # tests/goldens/bench_cfg3.npz holds the bunny mesh, which is absent;
    # both packages render the sphere that replaces it, whose golden is
    # the JAX package's own CPU render (tests/torch_goldens). Config 3
    # renders with each item walk, each launching its own walk kernel.
    walk_launches = {}
    for tag, backend, walk in (("golden_64_cfg3", "cluster", None),
                               ("golden_64_cfg3_v5", "cluster", "v5"),
                               ("golden_64_cfg3_v6", "cluster", "v6"),
                               ("golden_64_bvh", "bvh", None)):
        scene = textured_mesh_scene(64, 64, backend=backend, device=device,
                                    ex_walk=walk)
        reset_launch_counts()
        golden_gate(tag, scene, "tests/torch_goldens/bench_cfg3_sphere.npz",
                    also="tests/goldens/bench_cfg3.npz",
                    band=MEAN_BAND["config3"])
        walk_launches[tag] = launch_counts()
    for tag, k in (("golden_64_cfg3", "l1_masked"),
                   ("golden_64_cfg3_v5", "items"),
                   ("golden_64_cfg3_v6", "l1_items")):
        ran = {w: walk_launches[tag][w]
               for w in ("items", "l1_items", "l1_masked")}
        phase(f"{tag}_walk", launches=ran)
        if ran[k] < 1 or sum(ran.values()) != ran[k]:
            raise AssertionError(f"{tag}: item walks launched {ran}")
    golden_gate("golden_64_instanced", instanced_scene(64, 64, device=device),
                "tests/torch_goldens/instanced.npz")
    golden_gate("golden_64_sorted_brute", cornell_box(64, 64, device=device),
                "tests/goldens/bench_cfg1.npz",
                cfg=PathConfig(max_depth=5, spp=16, sort_rays=True),
                band=MEAN_BAND["config1"])
    golden_gate("golden_64_cfg2",
                cornell_box_specular(64, 64, backend="auto", device=device),
                "tests/goldens/bench_cfg2.npz", band=MEAN_BAND["config2"],
                block=CFG2_BLOCK, limit=CFG2_REL_RMSE_MAX)
    golden_gate("golden_64_volpath", cornell_box(64, 64, device=device),
                "tests/torch_goldens/volpath_fog.npz",
                cfg=PathConfig(max_depth=5, spp=FOG_GOLDEN_SPP),
                render_fn=fog_render, band=MEAN_BAND["volpath"])
    golden_cornell_xml(device)
    cfg = PathConfig(max_depth=DEPTH3, spp=SPP3)
    cfg1 = PathConfig(max_depth=DEPTH1, spp=SPP1)
    l1 = render_phase("config1", cornell_box(W1, H1, device=device), cfg1,
                      ["shaded_any"])
    live1 = brute_liveness("config1", cornell_box(W1, H1, device=device),
                           cfg1, render, "shaded_any")
    # config 1 with hit_prediction (the same image) and strict_normals
    lopt1 = config1_options(device)
    # the README's command through the CLI, and the same scene file
    # through io.xml.load_scene + render
    tmp = tempfile.TemporaryDirectory()
    lcli = cli_phase("cli_cornell", device, tmp.name, "cornell")
    # the materials: snow.xml through the CLI, the goldens of snow, the
    # Ward spheres and the zoo, the zoo's render, its card against CPU
    lmat = materials_phases(device, tmp.name)
    # the lights, textures and cameras: the lights file through the CLI
    # and with its orthographic camera, their goldens; the mip floor's
    # three filters; config 3's bvh scene with a bitmap; the particle
    # tracer; the texel gradient
    llights = lights_phases(device, tmp.name)
    ltex = textured_phases(device)
    lpt = ptracer_phase(device)
    texture_grad(device)
    # subsurface scattering, surface guiding and motion blur through the
    # CLI, and the goldens of the slab and the guided Cornell box
    lsss = {tag: sss_phase(tag, device, tmp.name, form) for tag, form in (
        ("sss_xml", "dipole"), ("sss_multipole", "multipole"),
        ("sss_adipole", "adipole"))}
    slice_goldens(device)
    lguided = guided_cli_phase(device, tmp.name)
    lmotion = motion_phase(device, tmp.name)
    # analytic cylinders, the cloth, <blackbody>, JPEG, hspan and
    # tessellated hair through scene files, and their goldens
    lleft = leftovers_phases(device, tmp.name)
    # analytic hair through a scene file and on the cluster backend, the
    # photon map family, the irradiance cache, VPLs, adaptive sampling
    # and the beam estimate (ROADMAP A.12)
    lhair = hair_phases(device, tmp.name)
    linteg = integrators_phases(device, tmp.name)
    # config 2: the brute kernel (#1) with the glass sphere merged after
    # it, camera lanes in pixel-Morton order as bench.py runs it
    l2 = render_phase("config2", cornell_box_specular(
        W2, H2, backend="auto", device=device),
        PathConfig(max_depth=DEPTH2, spp=SPP2), ["shaded_any"],
        render_fn=morton_render, forbid=["shaded", "any"])
    # config 4: the gradient of config 1's loss with respect to the
    # reflectance, a checkpoint a bounce
    gc, _ = _grad_cases()
    l4 = grad_phase("config4", cornell_box(W4, H4, device=device),
                    PathConfig(max_depth=DEPTH4, spp=SPP4, remat=True),
                    gc.mean_l, (("materials", "reflectance"),),
                    ["shaded_any"], spp=SPP4)
    l4 = {p: l4["launches"][p].get("shaded_any", 0)
          for p in ("forward", "backward")}
    if l4["forward"] * TIMED["config1"] != l1["shaded_any"]:
        raise AssertionError("config4: the forward launched #1 "
                             f"{l4['forward']} times, a config-1 render "
                             f"{l1['shaded_any'] / TIMED['config1']}")
    config4_checks(device)
    # the gradients off brute: bvh, cluster, instanced, the subsurface
    # slab with its cache inside the step, the particle tracer
    lgrad = grad_phases(device, scene_bvh, scene3, scene_inst)
    l3 = render_phase("config3", scene3, cfg,
                      ["refine", "child_refine", "l1_masked"],
                      forbid=["items", "l1_items"])
    walk_liveness("config3", scene3, cfg)
    # config 3 under sort_mode="octant" and hit_prediction
    lopt3 = config3_options(scene3, cfg, l3)
    # config 3 as scene files: the cluster backend under auto, then bvh
    twin_dir = os.path.join(tmp.name, "config3")
    os.mkdir(twin_dir)
    lxml = xml_config3_phase(device, twin_dir, scene3, l3)
    tmp.cleanup()
    l3v5 = render_phase("config3_v5", scene3_v5, cfg,
                        ["refine", "child_refine", "items"],
                        forbid=["l1_masked", "l1_items"])
    live_v5 = walk_liveness("config3_v5", scene3_v5, cfg,
                            replay_refine=False)["items"]
    l3v6 = render_phase("config3_v6", scene3_v6, cfg,
                        ["refine", "child_refine", "l1_items"],
                        forbid=["items", "l1_masked"])
    live_v6 = walk_liveness("config3_v6", scene3_v6, cfg,
                            replay_refine=False)["l1_items"]
    lb = render_phase("bvh", scene_bvh, cfg, ["bvh_closest", "bvh_any"])
    replay_launches("bvh", scene_bvh, cfg)
    li = render_phase("instanced", scene_inst, cfg, ["wl_closest", "wl_any"])
    replay_launches("instanced", scene_inst, cfg)
    lv = render_phase("volpath", cornell_box(W1, H1, device=device), fog_cfg,
                      ["shaded", "any"], render_fn=fog_render,
                      forbid=["shaded_any"])
    live_fog = brute_liveness("volpath", cornell_box(W1, H1, device=device),
                              fog_cfg, fog_render, "shaded")
    live_fog_any = brute_liveness("volpath",
                                  cornell_box(W1, H1, device=device),
                                  fog_cfg, fog_render, "any")
    # participating media: grid, flake and guided volpath (#2 and #3),
    # shape-interior media (#2 alone)
    with tempfile.TemporaryDirectory() as media_tmp:
        lmed = media_phases(device, media_tmp)
    lc = cluster_v1_phase(scene3, cl, cam3, shadow3)
    t0 = time.perf_counter()
    case = r3_kernel.worklist_case(device, PROBE_SIDE, scene3)
    phase("probe_list", seconds=time.perf_counter() - t0,
          clusters=int(case[0]["tri"].shape[0]), lanes=int(case[1].shape[0]))
    pc = compare_probes(device, case)
    lp = probes_phase(device, case)
    lib = library_phase(device)

    def entry(kname, source, replaces, launches, r, library_ms=None,
              **extra):
        return {"name": kname, "route": "cuda",
                "source": f"mitsuba_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": library_ms,
                **extra}

    def probe(kname, replaces, key, source="probes.cu", library_ms=None):
        # a probe kernel's ms is its device time at the check's inputs,
        # the host's share left out; event_ms the CUDA events'
        r = pc[key]
        return entry(kname, source, replaces, lp[kname],
                     dict(r, ms=r["device_ms"]), library_ms, path="probes",
                     event_ms=r["ms"], check_phase=f"kernel_vs_plain "
                     f"{kname} ({r['stage']})")

    cost = "scripts/exp_kernel_cost.py"

    def brute(kname, replaces, launches, r, **extra):
        # a brute kernel's ms is its device time at the check's inputs,
        # the host's share left out (a call's host work outlasts the
        # kernel); event_ms the CUDA events' around each call
        return entry(kname, "intersect_brute.cu",
                     f"mitsuba_tpu/ops/intersect_pallas.py:{replaces}",
                     launches, dict(r, ms=r["device_ms"]), event_ms=r["ms"],
                     check_phase=f"kernel_vs_plain {kname} ({r['stage']})",
                     **extra)

    def own_ms(tag, kname):
        # device ms of one render of phase `tag` in kernel kname
        return PROFILES[tag]["own"].get(kname, {}).get("ms")

    def brute_ms(tag, kname):
        # ... in brute kernel kname, its instance of brute_kernel
        return PROFILES[tag]["own"].get("brute_kernel", {}).get(
            "instances", {}).get(BRUTE_INSTANCE[kname], {}).get("ms")

    def grad_launches(*tags, kname):
        # a kernel's launches in the gradient phases' counting steps,
        # the forward and the backward's recompute apart
        return {f"launches_{t}": {p: lgrad[t]["launches"][p].get(kname, 0)
                                  for p in ("forward", "backward")}
                for t in tags}

    def media_entry(lmed, kname):
        return {f"{w}_{tag}": v for tag, counts in lmed.items()
                for w, v in (("launches", counts[kname]),
                             ("device_ms_per_render",
                              brute_ms(tag, kname)))}

    def left_launches(kname, profiled=None):
        # a cluster kernel's launches in the cylinders' config-3 twin (a
        # render) and in leftovers.xml (the CLI's run and a render), and
        # their device ms a render
        out = {"launches_cylinders_cluster":
               lleft["cylinders_cluster"][kname],
               "launches_leftovers_xml": {
                   p: lleft["leftovers_xml"][p][kname]
                   for p in ("cli", "render")}}
        if profiled:
            out.update({f"device_ms_per_render_{t}": own_ms(t, profiled)
                        for t in ("cylinders_cluster", "leftovers_xml")})
        return out

    def integ(kname, *tags):
        # a brute kernel's launches in the integrator phases' counted run
        # (and its device ms in their profiled run)
        out = {}
        for t in tags:
            out[f"launches_{t}"] = linteg[t][kname]
            out[f"device_ms_per_run_{t}"] = brute_ms(t, kname)
        return out

    def hair_cluster(kname, profiled=None):
        # a cluster kernel's launches in hair_cluster (a render) and in
        # photons_cluster (the sppm run), and their device ms
        out = {"launches_hair_cluster": lhair["hair_cluster"][kname],
               "launches_photons_cluster": linteg["photons_cluster"][kname]}
        if profiled:
            out["device_ms_per_render_hair_cluster"] = own_ms(
                "hair_cluster", profiled)
            out["device_ms_per_run_photons_cluster"] = own_ms(
                "photons_cluster", profiled)
        return out

    # the stream fallback launches only where a lane overflows the XL caps
    stream_path = "config3" if l3["stream"] else "config3_v5"
    print(json.dumps({"kernels": [
        # #1 and #2 (brute_kernel's instances): device ms of a config-1
        # and of a fog render (the profile's), and of their launches
        # replayed alone (the device's time, and the calls' by CUDA
        # events); the same for #3 in fog
        brute("shaded_any", 337, l1["shaded_any"], brute_check,
              launches_config2=l2["shaded_any"],
              launches_cli_cornell=lcli,
              launches_snow_xml=lmat["snow_xml"],
              launches_bsdf_zoo=lmat["bsdf_zoo"]["shaded_any"],
              launches_lights_xml=llights["lights_xml"],
              launches_lights_ortho=llights["lights_ortho"]["shaded_any"],
              launches_textured_mip={t: ltex[t]["shaded_any"] for t in (
                  "textured_mip", "textured_mip_mip",
                  "textured_mip_aniso")},
              device_ms_per_render_lights_xml=PROFILES["lights_xml"][
                  "own"].get("brute_kernel", {}).get("ms"),
              device_ms_per_render_textured_mip={t: brute_ms(
                  t, "shaded_any") for t in (
                  "textured_mip", "textured_mip_mip",
                  "textured_mip_aniso")},
              device_ms_per_render_snow_xml=PROFILES["snow_xml"]["own"]
              .get("brute_kernel", {}).get("ms"),
              device_ms_per_render_bsdf_zoo=brute_ms("bsdf_zoo",
                                                     "shaded_any"),
              launches_config4=l4,
              **grad_launches("grad_sss", kname="shaded_any"),
              launches_config1_options=lopt1,
              launches_sss={t: v["shaded_any"] for t, v in lsss.items()},
              device_ms_per_render_sss={t: PROFILES[t]["own"].get(
                  "brute_kernel", {}).get("ms") for t in lsss},
              launches_guided_cli=lguided,
              device_ms_per_render_guided_cli=PROFILES["guided_cli"][
                  "own"].get("brute_kernel", {}).get("ms"),
              launches_motion_xml=lmotion,
              device_ms_per_render_motion_xml=PROFILES["motion_xml"][
                  "own"].get("brute_kernel", {}).get("ms"),
              **{f"launches_{t}": lleft[t] for t in ("cylinders_xml",
                                                     "cloth_xml")},
              **{f"device_ms_per_render_{t}": PROFILES[t]["own"].get(
                  "brute_kernel", {}).get("ms") for t in ("cylinders_xml",
                                                          "cloth_xml")},
              launches_hair_xml=lhair["hair_xml"],
              device_ms_per_render_hair_xml=PROFILES["hair_xml"]["own"]
              .get("brute_kernel", {}).get("ms"),
              **integ("shaded_any", "irrcache", "adaptive"),
              device_ms_per_render=brute_ms("config1", "shaded_any"),
              device_ms_per_render_config2=brute_ms("config2",
                                                    "shaded_any"),
              replayed_device_ms_per_render=live1["device_ms"],
              replayed_event_ms_per_render=live1["ms"]),
        # #5 and #6: the device ms of a config-3 render at the card's
        # default walk (v6b: S1 and S2) and under v5 (#6 also runs S3)
        entry("refine", "exact.cu", "mitsuba_tpu/ops/exact_pallas.py:114",
              l3["refine"], cluster[("refine", "bounce", "S1")],
              launches_xml_config3=lxml["cluster"]["refine"],
              **left_launches("refine"), **hair_cluster("refine"),
              **{f"launches_{t}": v["refine"] for t, v in lopt3.items()},
              device_ms_per_render=own_ms("config3", "refine_kernel"),
              device_ms_per_render_v5=own_ms("config3_v5", "refine_kernel"),
              **grad_launches("grad_cluster", kname="refine"),
              check_phase="kernel_vs_plain refine (bounce S1)"),
        entry("child_refine", "exact.cu",
              "mitsuba_tpu/ops/exact_pallas.py:209", l3["child_refine"],
              cluster[("child_refine", "bounce", "S2")],
              launches_xml_config3=lxml["cluster"]["child_refine"],
              **left_launches("child_refine"), **hair_cluster("child_refine"),
              **{f"launches_{t}": v["child_refine"]
                 for t, v in lopt3.items()},
              device_ms_per_render=own_ms("config3", "child_refine_kernel"),
              device_ms_per_render_v5=own_ms("config3_v5",
                                             "child_refine_kernel"),
              **grad_launches("grad_cluster", kname="child_refine"),
              check_phase="kernel_vs_plain child_refine (bounce S2)"),
        # no default render path launches #7 (v5) or #8 (v6): their
        # launches and device ms a render are the config-3 render's with
        # ex_walk="v5" or "v6", beside the ms of those launches replayed
        # alone (CUDA events)
        entry("items", "exact.cu", "mitsuba_tpu/ops/exact_pallas.py:531",
              l3v5["items"], cluster[("items", "bounce", "closest")],
              path="config3_v5",
              device_ms_per_render=own_ms("config3_v5", "items_kernel"),
              replayed_ms_per_render=live_v5["ms"],
              check_phase="kernel_vs_plain items (bounce closest)"),
        entry("l1_items", "exact.cu", "mitsuba_tpu/ops/exact_pallas.py:666",
              l3v6["l1_items"], cluster[("l1_items", "bounce", "closest")],
              path="config3_v6",
              device_ms_per_render=own_ms("config3_v6", "l1_items_kernel"),
              replayed_ms_per_render=live_v6["ms"],
              check_phase="kernel_vs_plain l1_items (bounce closest)"),
        entry("l1_masked", "exact.cu", "mitsuba_tpu/ops/exact_pallas.py:814",
              l3["l1_masked"], cluster[("l1_masked", "bounce", "closest")],
              device_ms_per_render=own_ms("config3", "l1_masked_kernel"),
              **{f"launches_{t}": v["l1_masked"] for t, v in lopt3.items()},
              **{f"device_ms_per_render_{t}": own_ms(t, "l1_masked_kernel")
                 for t in lopt3},
              launches_xml_config3=lxml["cluster"]["l1_masked"],
              **left_launches("l1_masked", "l1_masked_kernel"),
              **hair_cluster("l1_masked", "l1_masked_kernel"),
              **grad_launches("grad_cluster", kname="l1_masked"),
              device_ms_per_render_xml_config3=own_ms("xml_config3",
                                                      "l1_masked_kernel")),
        entry("stream", "stream.cu",
              "mitsuba_tpu/ops/stream_pallas.py:176",
              (l3 if stream_path == "config3" else l3v5)["stream"],
              cluster[("stream", "bounce", False)], path=stream_path,
              device_ms_per_render=own_ms(stream_path, "stream_kernel"),
              **{f"launches_{t}": v["stream"] for t, v in lopt3.items()},
              launches_xml_config3=lxml["cluster"]["stream"],
              **left_launches("stream", "stream_kernel"),
              **hair_cluster("stream", "stream_kernel"),
              **grad_launches("grad_cluster", kname="stream")),
        # #11's device ms a render (both bodies), in the bvh render and
        # in the instanced one (its overflow fallback and instance walks)
        entry("bvh_closest", "bvh.cu", "mitsuba_tpu/ops/bvh_pallas.py:169",
              lb["bvh_closest"], bvh[("bvh_closest", "bounce")],
              launches_xml_config3_bvh=lxml["bvh"]["bvh_closest"],
              launches_textured_bvh=ltex["textured_bvh"]["bvh_closest"],
              device_ms_per_render_textured_bvh=own_ms("textured_bvh",
                                                       "bvh_kernel"),
              launches_cylinders_bvh=lleft["cylinders_bvh"]["bvh_closest"],
              device_ms_per_render_cylinders_bvh=own_ms("cylinders_bvh",
                                                        "bvh_kernel"),
              device_ms_per_render=own_ms("bvh", "bvh_kernel"),
              device_ms_per_render_instanced=own_ms("instanced",
                                                    "bvh_kernel"),
              **grad_launches("grad_bvh", "grad_instanced",
                              kname="bvh_closest")),
        entry("bvh_any", "bvh.cu", "mitsuba_tpu/ops/bvh_pallas.py:196",
              lb["bvh_any"], bvh[("bvh_any", "shadow")],
              launches_xml_config3_bvh=lxml["bvh"]["bvh_any"],
              launches_textured_bvh=ltex["textured_bvh"]["bvh_any"],
              launches_cylinders_bvh=lleft["cylinders_bvh"]["bvh_any"],
              **grad_launches("grad_bvh", "grad_instanced", kname="bvh_any")),
        entry("wl_closest", "worklist.cu",
              "mitsuba_tpu/ops/worklist_pallas.py:364", li["wl_closest"],
              worklist[("wl_closest", "bounce", "instanced")],
              device_ms_per_render=own_ms("instanced", "worklist_kernel"),
              **grad_launches("grad_instanced", kname="wl_closest")),
        entry("wl_any", "worklist.cu",
              "mitsuba_tpu/ops/worklist_pallas.py:458", li["wl_any"],
              worklist[("wl_any", "shadow", "instanced")],
              **grad_launches("grad_instanced", kname="wl_any")),
        # #2 and #3 also on the media paths: launches (their timed
        # renders') and device ms of a render, by path
        brute("shaded", 202, lv["shaded"], split["shaded"], path="volpath",
              device_ms_per_render=brute_ms("volpath", "shaded"),
              replayed_device_ms_per_render=live_fog["device_ms"],
              replayed_event_ms_per_render=live_fog["ms"],
              launches_ptracer=lpt["shaded"],
              device_ms_per_render_ptracer=brute_ms("ptracer", "shaded"),
              launches_cylinder_media=lleft["cylinder_media"]["shaded"],
              device_ms_per_render_cylinder_media=brute_ms(
                  "cylinder_media", "shaded"),
              **integ("shaded", "photonmap", "ppm", "photonmapper", "sppm",
                      "irrcache", "vpl", "bre"),
              **grad_launches("grad_ptracer", kname="shaded"),
              **media_entry(lmed, "shaded")),
        brute("any", 97, lv["any"], split["any"], path="volpath",
              device_ms_per_render=brute_ms("volpath", "any"),
              replayed_device_ms_per_render=live_fog_any["device_ms"],
              replayed_event_ms_per_render=live_fog_any["ms"],
              launches_ptracer=lpt["any"],
              device_ms_per_render_ptracer=brute_ms("ptracer", "any"),
              **grad_launches("grad_ptracer", "grad_sss", kname="any"),
              launches_sss_cache={t: v["any"] for t, v in lsss.items()},
              **integ("any", "photonmapper", "vpl"),
              device_ms_per_render_sss={t: brute_ms(t, "any")
                                        for t in lsss},
              **media_entry(lmed, "any")),
        # no render path launches #4 (nor does the JAX package's): its
        # check phase holds it against its plain version
        brute("closest", 59, lv["closest"], split["closest"]),
        # #14 has its own entry points, off every render path: its
        # launches are the cluster_v1 phase's
        # beside the bound of the lanes' own-slab tests, that of the
        # row-wide tests the plain version's rule makes
        entry("cluster_closest", "cluster.cu",
              "mitsuba_tpu/ops/cluster_pallas.py:169",
              lc["cluster_closest"], v1[("cluster_closest", "bounce")],
              path="cluster_v1", bound_ms_row_tests=v1[(
                  "cluster_closest", "bounce")]["bound_ms_row_tests"],
              check_phase="kernel_vs_plain cluster_closest (bounce closest)"),
        entry("cluster_any", "cluster.cu",
              "mitsuba_tpu/ops/cluster_pallas.py:227", lc["cluster_any"],
              v1[("cluster_any", "shadow")], path="cluster_v1",
              bound_ms_row_tests=v1[("cluster_any", "shadow")][
                  "bound_ms_row_tests"],
              check_phase="kernel_vs_plain cluster_any (shadow any)"),
        # #13 and #15 run on no render path: their launches are the
        # probes phase's, through the probe drivers
        probe("wl_probe", "mitsuba_tpu/ops/worklist_pallas.py:424",
              "wl_probe", source="worklist.cu"),
        probe("count", f"{cost}:228", "count"),
        probe("gate", f"{cost}:228", "gate"),
        probe("rotate", f"{cost}:270", ("rotate", 32)),
        probe("grid", "scripts/exp_r3_kernel.py:70", ("grid", True)),
        probe("fma", f"{cost}:111", "fma"),
        probe("mt", f"{cost}:188", "mt"),
        probe("v0", "scripts/exp_r3_mt.py:63", "v0"),
        probe("v1", "scripts/exp_r3_mt.py:63", "v1"),
        probe("v2", "scripts/exp_r3_mt.py:63", "v2"),
        probe("v4", "scripts/exp_r3_mt.py:63", "v4"),
        probe("mm_cuda", f"{cost}:71", "mm_cuda",
              library_ms=lib["matmul_fp32_4096x10_device"]),
        probe("mm_tf32", f"{cost}:71", ("mm_tf32", 4096, 10),
              library_ms=lib["matmul_tf32_4096x10_device"]),
        probe("mm_bf16", f"{cost}:71", ("mm_bf16", 4096, 10),
              library_ms=lib["matmul_bf16_4096x10_device"]),
        probe("gather_smem", "scripts/exp_r5_megakernel.py:72",
              "gather_smem", library_ms=lib["gather_32768_device"]),
        probe("gather_global", "scripts/exp_r5_megakernel.py:72",
              "gather_global", library_ms=lib["gather_32768_device"]),
    ]}), flush=True)
    phase("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
