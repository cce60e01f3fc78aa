#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one card, nvcc and the checkout
    python3 chip_smoke.py --fmad-ab  # also compiles csrc/sweep.cu with
                                     # -fmad=false itself and runs the sweep
                                     # checks on that library as well
    python3 chip_smoke.py --profile  # also traces the main path, 2 samples of
                                     # the Cornell wavefront path, the nee
                                     # preset by its default route, 1
                                     # sample of its wavefront route, one
                                     # step of each surface gradient route
                                     # and one analytic volume gradient step
                                     # with torch.profiler (device time by
                                     # kernel)
    python3 chip_smoke.py --launch-bounds-ab  # also compiles
                                     # csrc/het_megakernel.cu under other
                                     # __launch_bounds__ caps and times them
    python3 chip_smoke.py --ab-csrc parent=DIR [--ab-only]
                                     # also builds sweep.cu, media.cu,
                                     # het_megakernel.cu, megakernel.cu and
                                     # vol_megakernel.cu from DIR (another
                                     # copy of csrc/, e.g. the parent
                                     # commit's; each only where its sources
                                     # differ from the package's) and holds
                                     # K1-K10 of that build against the
                                     # package's, bitwise, timing both in
                                     # turns; for the volume kernels also a
                                     # timeline build and the SASS count
    python3 chip_smoke.py --nccl     # on a box of two cards or more:
                                     # shard_path's split, one rank per
                                     # card under NCCL, against the single
                                     # render on cuda:0, and stops
    python3 chip_smoke.py --k1b-probe  # builds megakernel.cu with K1b
                                     # walking every shadow ray at once on
                                     # a staged table, with and without
                                     # -fmad=false, counts the pixels where
                                     # K1b parts from K1c, and stops
    python3 chip_smoke.py --frame    # frame_path alone, and stops

Builds the CUDA kernels of ``xraytracer_tpu_torch/csrc`` from source (five
libraries: the sweeps, the whole-path surface kernels with the
analytic-gradient kernel, the whole-path homogeneous volume kernels, the
heterogeneous tracking kernels, the whole-path heterogeneous volume
kernels with the analytic volume-gradient kernel), holds each of the
sixteen kernels (and two helpers: the chunk table the sweeps walk and the
corner table of the volume gradient's route) against its plain PyTorch
version on the card at the shapes its path gives it (the sweeps also on the
rays the delta-light paths give them: shadow rays toward a distant light, with
t_max = INF, and rays leaving mirror and glass spheres), reproduces the two CPU
golden images through the kernels, and then drives, through the port's public
entry points:

* ``main_path``: the ``cornellbox_gi`` preset (780x585, depth 3) by its
  default route, the whole-render kernel ``mega_spp_persistent`` (one launch
  per spp chunk);
* ``frame_path``: the renderer's assembly on the card (Cornell at spp 3 and
  512, raster and morton, the nee cloud at spp 3): each image bitwise the
  host assembly of the same sums (numpy scatter, then ``/ spp``), one
  frame-sized copy between host and card a render;
* ``fused_entry_points``: the same scene through ``mega_path`` (one launch
  per sample) and ``mega_spp`` (one launch per chunk);
* ``wavefront_path``: the same preset with ``fused="never"`` (record sweep +
  any-hit sweep per bounce), and ``tri_fn_path``: its ``tri_fn`` route, which
  sends both sweeps through ``sweep_nearest``;
* ``mesh_path``: the 13k-triangle mesh GI scene, which is over the
  whole-path kernels' row gate and so shows the routing to the wavefront
  route, whose bounce rays it sorts (``sort_rays="auto"``); the same render
  unsorted must give the same image bit for bit, and both are timed in
  turns;
* ``whitted_path``, ``example_path``, ``direct_path``, ``furnace_path``: the
  ``whitted`` preset (the example scene under the Whitted integrator, depth
  3), the ``example`` preset with the normal integrator, and ``cornellbox``
  with ``--integrator direct`` and ``furnace``, each at 780x585 and its
  preset's 16 spp through ``cli.build_scene`` / ``cli.make_integrator`` by
  the wavefront route (``sweep_nearest_rec`` per hit, ``occluded_anyhit`` per
  shadow ray: the delta lights' with t_max = INF toward the distant light);
* ``obj_path``: the Cornell box and the 13k mesh scene written as ``.obj`` +
  ``.mtl`` and loaded back through ``--obj`` (the native IO tier's parser),
  their triangle rows and the normal integrator's images bitwise those of
  the directly built scenes, and the image written as PNG and P6 PPM by
  the native writers and decoded back;
* ``vpt_path``: the ``vpt`` preset (512x512, depth 10, its own 1024 spp; one
  homogeneous box) by its default route, the whole-render volume kernel
  ``vol_spp_persistent``; ``vpt_nee_path``: the same with next-event
  estimation; ``vol_entry_points``: the same scene through ``vol_path`` and
  ``vol_spp``;
* ``nee_path``: the ``nee`` preset (780x585, depth 32, its own 1024 spp; a
  64^3 cloud under a sphere light) and ``volume_path``: the ``volume``
  preset (512x512, depth 100, its own 10240 spp), both by their default
  route, the whole-render heterogeneous kernel ``het_spp_persistent`` (one
  launch per spp chunk); ``het_entry_points``: the nee scene through
  ``het_path`` and ``het_spp``;
* ``nee_wavefront_path``: the nee preset by the wavefront volume route
  (``with_stats=True``, 1 sample, full depth), whose tracking loops are the
  kernels ``track_sample`` and ``track_transmittance``;
* ``grad_path_autograd`` and ``grad_path_analytic``: the gradient of the L2
  image loss w.r.t. albedo and emission on ``cornellbox_gi`` (780x585,
  depth 3, cosine sampling), by torch autograd through
  ``diff.make_loss_fn(diff.make_radiance_fn(...))`` (``sweep_nearest``
  through the zero-gradient ``SweepStopGrad``, ``occluded_anyhit`` for the
  shadow rays) and by ``diff.try_make_fast_value_and_grad`` (one
  ``mega_grad_path`` launch per step), which must agree;
* ``fit_path``: ``tools.fit_scene.fit`` at 780x585, depth 3, 20 steps of
  1 sample through ``mega_grad_path``, whose loss must fall;
* ``vol_grad_path_analytic`` and ``vol_grad_path_autograd``: the gradient
  of the L2 image loss w.r.t. the density grid and Le on the nee preset
  (depth 32), by ``diff.try_make_fast_value_and_grad`` at 780x585 (one
  ``pack_corners``, one ``het_path`` and one ``het_grad_path`` launch per
  step) and by torch
  autograd through ``diff.make_radiance_fn(..., score_terms=True,
  grad_sampling=True)`` on a 96x72 window of the frame (the whole frame's
  tape does not fit the card);
* ``fit_volume_path``: ``tools.fit_volume.fit`` at its published 96x72,
  depth 6, three views, two pairs, 600 steps through ``het_path`` and
  ``het_grad_path`` (per view and pair one launch of each pass over both
  streams; its 16^3 grid is read by corner loads, not packed), whose loss
  and density error must fall;
* ``shard_path``: ``parallel/`` over two gloo ranks, spawned processes both
  on cuda:0 (NCCL refuses two ranks on one device): each rank renders its
  contiguous half of the lanes of ``cornellbox_gi`` (512 spp, K1c), ``vpt``
  (64 spp, K6c) and ``nee`` (16 spp, K9c), each bitwise the single render;
  Cornell's spp axis (8 samples through ``mega_path``) within 1e-5 of
  single; one analytic gradient step (K5) against single at ``grad_path``'s
  gates; then ``--shard`` through the CLI in a world of one, bitwise
  ``main_path``'s image. A rank that fails or hangs fails the script;
* ``tools_path``: the 64^3 procedural cloud written as ``.vdb`` (zip) by
  ``tools.vdb.write_vdb``, converted by ``tools.grid_convert``, which must
  give the cloud's window of active voxels bit for bit, and rendered by the
  CLI as ``--preset nee --density-grid`` (780x585, 16 spp, K9c), bitwise
  the render fed the same window as an array.

The sweep checks also take the 13k mesh's rays of the sorted route (depth-1
bounce rays sorted, depth-0 shadow rays parked, depth-1 shadow rays sorted
and parked), and hold each kernel's outputs on them bitwise under a seeded
permutation of the lanes (a lane's result must not depend on its warp).

Every launch count is set to 0 just before each of these runs and read just
after it; the script checks that the run went through exactly the kernels
of its route and through no plain version. In the ``kernels`` line
``launches_by_path`` holds these readings, ``launches`` is their sum and
``runs_on`` names the path that must have launched the kernel.
There is no fallback: without a card, or when any phase fails, the script
exits non-zero and prints no result line.

Output: one JSON object per line (``device``, ``build``, ``kernel_checks``
once per family (sweeps, their chunk table, the sweeps on the delta-light
and mirror/glass rays, whole-path, volume whole-path, tracking,
heterogeneous whole-path, surface gradient, heterogeneous gradient, the
corner table), ``golden`` three times, then one line per driven path), then
``{"kernels": [...]}`` with one entry per kernel, the card's name and power
limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Bounds. ``bound_ms`` is the least time the card could take: the larger of
(bytes that must move: every input read once, every output written once) /
3.35 TB/s and (operations needed) / 67 TFLOP/s float32 outside the tensor
cores, the H100 SXM data-sheet peaks. Operations are counted from this
run's data:

* the sweeps walk a chunk table (csrc/sweep.cuh) and need, per ray in its
  own visit order, the slab test of every group's box and of the chunks of
  the groups it wants (15 flop each), and the pair tests of the valid rows
  of every chunk it wants itself (38 flop each; 39 for any-hit), where the
  nearest-hit ray prunes against its own running best and the any-hit ray
  against its t_max, up to and including its first blocking row
  (``culled_tests_needed``). The brute-force count (all N*T tests; for
  any-hit up to the first blocker in table order) is printed beside it as
  ``brute_bound_ms``. The chunk table (chunk_boxes) reads the table and
  mask once and writes its boxes and coefficient rows once;
* a whole-path surface kernel needs T pair tests for every camera, bounce
  and shadow ray of its paths, counted by the plain version's per-bounce
  counters on the same inputs. Where a kernel culls (K1a-c, K5, on a
  table they do not stage: ``FusedScene.culls``), it needs per ray the
  culled walk's pair and slab tests in the ray's own visit order
  (``mega_culled_bound``: ``culled_tests_needed`` on the rays the plain
  version traced); the brute-force count is printed beside it as
  ``brute_bound_ms``;
* a whole-path volume kernel needs, per iteration, for every lane that
  enters it (counter ``rays``) the classic triangle tests (45 flop each: two
  cross products, four dot products, a division, the compares) and the box
  slab (30), and the roulette (8); for every lane that samples the medium
  (``active_out``) the closed-form sample (110: channel pick 15, free flight
  and its two weights with six exponentials 45, the scattered direction
  50); with next-event estimation, for every lane that scatters
  (``scattered``) the light sample (40), a second nearest-hit test and the
  transmittance, phase value and sum (50). An exponential, logarithm, sine,
  cosine, square root or division counts as one operation, which makes the
  bound a low one. Bytes: what the launch reads per lane (K6a: the ray and
  its u32 key, 28 B, whatever width the port stores the key in) and writes
  per lane;
* a tracking kernel needs, per lane that tracks, the supergrid walk over
  its span (32 per segment the span crosses: three exit times, a minimum,
  a majorant and the running optical depth; counted from the plain
  version's segments, those that start before the span's end) and per
  collision candidate (the plain version's count of active lanes at every
  step of its loop) 150 flop for ``track_sample`` (three draws'
  conversions, logarithm, two exponentials, the candidate's segment by a
  forward cursor and the inversion to t 4, the trilinear value 45, channel
  pick 15, three channels of cross sections, probabilities and weights 60)
  resp. 70 for ``track_transmittance`` (draw, logarithm, segment, trilinear
  value, three ratios). Bytes: a lane that tracks reads its inputs, every lane reads
  its mask byte and writes its outputs; the 64^3 density grid (1 MB) counts
  once when any candidate was drawn, the supergrid once when any lane
  tracks. The 8 MB corner table the kernels read instead of the grid is the
  port's own copy and is not counted;
* a whole-path heterogeneous kernel needs, per iteration, for every lane
  that enters it (counter ``rays``) the sphere tests (30 flop each: the
  offset, two dot products, the discriminant, square root, two roots and
  compares), the box slab (30) and the roulette (8); for every lane that
  tracks, the tracking kernel's supergrid walk and per-candidate work as
  above (lanes and candidates counted by the plain version's own tracking
  loops on the same inputs); for every lane that scatters (``scattered``)
  the phase direction (45); with next-event estimation, for every lane that
  scatters the light pick and cone sample (75), a second nearest-hit test,
  the phase value and the sum (30), and for every shadow ray through the
  box the transmittance kernel's walk and per-candidate work. Bytes: what
  the launch reads per lane and writes per pixel, the density grid once and
  the supergrid once;
* the analytic-gradient kernel needs the whole-path surface kernel's pair
  tests (on a culled table, the culled walk's) and, for its M materials, the Jacobian updates of the events its
  paths take, counted by the plain version's per-bounce counters on the
  same inputs: per entry of the 9M albedo Jacobian 3 flop at every
  roulette a path survives (the sum over channels, the product with the
  boost's derivative, the product rule), 2 at every emitter hit that
  counts, 4 at every light sample (the product, the same-channel term, the
  multiply-add into the lane's sum) and 2 at every scattering; per light
  sample 6 and per emitter hit 3 more for the emission Jacobian. Bytes: 28
  per lane in (ray, key), 4 per lane and output plane out (3 + 9M + 3L
  planes), the table and the light rows once;
* the analytic volume-gradient kernel (pass B) needs a replay of the whole
  heterogeneous path on the same draws (as above, counted by the plain
  version's forward tallies under the grad-sampling estimator; each shadow
  ray's walk once, since a walk's events can be kept until its
  transmittance is known), and per collision candidate the gradient
  event: 80 flop for a
  tracking candidate (three channels of d p_s, the pdf's derivative, two
  score terms, the coefficient; eight corner weights and eight atomic adds)
  and 45 for a transmittance candidate (three ratios' derivatives, the
  corners). Bytes: 52 per lane in (ray, key, image, residual), 12 + 12L
  out (image, Le planes), the grid and the supergrid read once, the
  gradient grid written once;
* the corner table of a live grid (pack_corners, no TPU kernel: a helper
  of the analytic volume gradient's route) moves the grid in once and 8
  floats per cell out: 9 x cells x 4 bytes, no arithmetic.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

WIDTH, HEIGHT, DEPTH = 780, 585, 3
MAIN_SPP = 512         # cornellbox_gi's own spp, one chunk
WAVEFRONT_SPP = 8      # the wavefront route of the same preset, cut from 512
ENTRY_SPP = 4          # mega_path / mega_spp through their entry points
REF_SPP = 16           # reference-size renders beside the main path
STATS_SPP = 4
K1_SPP = 4             # whole-path kernel checks beside the main-path shape
K1_MESH_SIZE = (40, 38)  # 3,044 triangles in 3,072 rows = 24 tiles of 128
# a mesh of one chunk-table group, culled: 324 triangles in 384 rows
K1_MESH_ONE_GROUP = (16, 10)
# 124 triangles in 128 rows, the smallest table above one chunk (those
# come in steps of 128 rows), culled: one side of the staging line
# (csrc/megakernel.cu MEGA_STAGE_ROWS)
K1_MESH_SMALL = (10, 6)
MESH_SPP = 4
MESH_SIZE = (82, 80)   # the "13k" lat-long sphere mesh
SORT_ROWS = 4096       # make_path_integrator's sort_rays="auto": sorted past these real rows
MESH_SORT_TURNS = 2    # mesh_path: sorted / unsorted renders timed in turns
MESH51_SIZE = (161, 160)  # bench_mesh.py's "51k" mesh (--ab-csrc only)
MESH51_PLAIN_RAYS = 65536  # rays of the 51k case held against the plain version
REF_W, REF_H = 128, 96
VOL_CHECK_SPP = 4      # volume whole-path kernel checks at the vpt preset's size
# the case the kernels line reports is the main path's own launch (the
# preset's 1024 spp), whose plain version traces this many samples of every
# pixel as one wavefront (same arithmetic per lane, sums in sample order)
VOL_PLAIN_BATCH = 32
ODD_FRAME = (203, 151)  # the work order's check: a width that is not a multiple of 32
VPT_NEE_SPP = 64       # vpt with next-event estimation, cut from 1024
VOL_ENTRY_SPP = 4      # vol_path / vol_spp through their entry points
# the nee and volume presets run their own 1024 and 10240 spp (one chunk
# each) through the whole-render heterogeneous kernel
HET_CHECK_SPP = 2      # heterogeneous whole-path kernel checks at the presets' sizes
HET_LIGHTS_DEPTH = 8   # the 8-light cloud of those checks (nee size and camera)
HET_ENTRY_SPP = 2      # het_path / het_spp through their entry points
NEE_WAVEFRONT_SPP = 1  # the nee preset by the wavefront route, cut from 1024
AB_SPP = 16            # samples per launch of the --launch-bounds-ab timings
MEGA_AB_TURNS = 6      # --ab-csrc turns over the whole-path surface builds
# reference-size renders beside the volume paths: samples per pixel of the
# full-depth kernel render and of the kernels-vs-plain pair (same seeds, so
# that pair agrees pixel by pixel whatever the count)
VOL_REF_SPP = {"vpt_path": (16, 16), "vpt_nee_path": (16, 16),
               "nee_path": (8, 4), "volume_path": (4, 2)}
# the plain reference of a heterogeneous path runs its tracking loops on the
# host, one tensor operation at a time: it is rendered at this depth, beside
# a kernel render of the same depth; the full-size image is then held
# against a reference-size kernel render at the full depth
HET_REF_PLAIN_DEPTH = 4
CAPTURE_ITERATIONS = (0, 4)  # tracking calls of one nee sample kept for the checks
# ... and of one volume sample (no next-event estimation: track_sample only;
# sigma_t 1.0, so a step bound above 1000 and candidate chains a hundred
# long). Its paths end early: the roulette leaves about one lane in six per
# iteration, and past the twelfth none tracks, so the late call kept is the
# fourth
VOLUME_CAPTURE_ITERATIONS = (0, 3)
EXHAUST_MAX_STEPS = 8  # a step bound the volume lanes run into: weight 0
GRAD_SAMPLE = 1        # the sample whose camera rays the K5 checks take
GRAD_STEPS = 8         # timed steps of each gradient route (bench.py:109-117)
FIT_STEPS, FIT_SPP = 20, 1  # tools.fit_scene.fit on the card
# the nee pixels held against autograd (K10's plain version) and driven by
# the autograd route: the centred 96x72 of the 780x585 frame (fit_volume's
# own frame size). The tape of the whole frame would not fit the card: a
# step's plain version keeps ~60 lane-sized tensors per tracking step, and
# the frame's paths take thousands of steps
HET_GRAD_WINDOW = (96, 72)
VOL_GRAD_STEPS = 8            # timed analytic steps at the full frame
VOL_GRAD_AUTOGRAD_STEPS = 2   # timed autograd steps on the window
FIT_VOL_STEPS = 600           # tools.fit_volume.fit: its own 600 steps

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
FLOPS_PER_TEST = 38     # det 5, u 11, v 11, t 6, sign/compare arithmetic 5
FLOPS_PER_ANYHIT_TEST = 39
FLOPS_PER_SLAB = 15     # a chunk or group box: 6 differences, 6 products, the
                        # interval's min / max and the candidacy compares
# volume whole-path and tracking kernels; derived in the docstring above
FLOPS_VOL_TRI_TEST, FLOPS_VOL_BOX, FLOPS_VOL_RR = 45, 30, 8
FLOPS_VOL_MEDIUM, FLOPS_VOL_LIGHT, FLOPS_VOL_NEE_REST = 110, 40, 50
FLOPS_DDA_SEGMENT, FLOPS_TRACK_CANDIDATE, FLOPS_TRANSMITTANCE_CANDIDATE = 32, 150, 70
FLOPS_HET_SPHERE, FLOPS_HET_SCATTER, FLOPS_HET_CONE, FLOPS_HET_NEE_REST = 30, 45, 75, 30
# the analytic-gradient kernel's Jacobian updates, per entry of the 9M
# albedo entries and event (derived in the docstring above)
FLOPS_JAC_ROULETTE, FLOPS_JAC_EMIT, FLOPS_JAC_NEE, FLOPS_JAC_SCATTER = 3, 2, 4, 2
# the analytic volume gradient's events (derived in the docstring above)
FLOPS_SAMPLE_GRAD_EVENT, FLOPS_TR_GRAD_EVENT = 80, 45

# tolerances, kernel vs plain version on the same inputs
IDX_MISMATCH_SHARE = 1e-4   # idx mismatches outside the tie band / rays
TIE_BAND = 2.0 ** -15       # relative t gap inside which either winner is right
T_RTOL, T_ATOL = 1e-4, 1e-5  # winner t on lanes that agree on idx
# u, v lie in [0, 1] but are sums of products ~|o - v0| |e| / det that
# cancel: rounding differences (FMA contraction in the kernel) grow with the
# scene's coordinates (the Cornell box spans ~1300 units from the camera)
# and with 1/|cos| at grazing incidence
UV_RTOL, UV_ATOL = 2e-3, 1e-4
REC_ATOL = 1e-6
# shadow rays swept by sweep_nearest (the tri_fn route) start on a surface
# and may run almost inside a blocker's plane (a ceiling point looking at the
# ceiling light): t = (distance to the plane) / cos, both the small remainder
# of a cancellation, so the winner's t carries an error of a few float32 ulps
# of |o - v0| / |cos| whatever the order of operations. Those cases add this
# many ulps of that bound to the t limit (and / |e| to the u, v limits); the
# path itself consumes only t < t_max there, which is compared exactly.
GRAZING_ULPS = 4
BLOCKED_MISMATCH_SHARE = 1e-4
MEAN_BAND_KERNEL_VS_PLAIN = 1e-3  # same seeds, same size: only edge flips differ
# pixels of the reference-size render (kernels vs plain path, same seeds)
# beyond rtol 1e-4 / atol 1e-6: only a path whose edge-grazing hit flipped
# may differ, about one ray in 2e5 on the mesh
REF_PIXEL_DIFF_SHARE = 2e-4
MEAN_BAND_FULL_VS_REF = 0.05      # other resolution: Monte-Carlo noise
# whole-path kernels vs their plain versions, per pixel, on radiance sums of
# the same samples: both run the same float32 formulas on the same draws, so
# pixels agree to rounding (FMA contraction, CUDA sinf / cosf) unless a
# discrete decision flipped (an edge-grazing hit, a roulette kill within an
# ulp of its threshold); the share of such pixels is gated, and the mean
K1_RTOL, K1_ATOL = 1e-4, 1e-5
K1_PIXEL_DIFF_SHARE = 2e-4
K1_LOOSE_RTOL, K1_LOOSE_ATOL = 2e-3, 2e-3   # the JAX package's fused gate
# per-sample loop vs merged loop: same draws, same order of additions; only
# contraction in two separately compiled loops may differ (JAX A/B gate)
K1_AB_RTOL, K1_AB_ATOL = 1e-6, 1e-7
# tracking kernels vs their plain versions, per lane: the kernels follow the
# plain versions' arithmetic term by term on every value a decision hangs on
# (csrc/media.cuh), so ``scattered`` and ``scat_step`` are expected to agree
# on every lane; the gates of tests/test_het_kernel.py apply to lanes that
# agree (t in scene units of a 330-unit box, weights of order 1), and the
# share of lanes that disagree or miss those gates is bounded
TRACK_T_RTOL, TRACK_T_ATOL = 1e-5, 1e-4
TRACK_W_RTOL, TRACK_W_ATOL = 1e-4, 1e-6
TRACK_LANE_SHARE = 1e-4
# the cloud golden through the tracking kernels: start from ten times the
# golden's own gate; values outside its own gate are counted and printed.
# Through the whole-render heterogeneous kernel: its camera ray multiplies by
# a float32 1 / width where the wavefront route that made the golden divides
# (as for K1), so the kernels' pixel gate
CLOUD_GOLDEN_GATE = (1e-5, 1e-7)
CLOUD_GOLDEN_CARD_GATE = (1e-4, 1e-6)
CLOUD_GOLDEN_HET_GATE = (K1_RTOL, K1_ATOL)
# the analytic-gradient kernel vs its plain version, per lane, on radiance and
# Jacobians of the same draws: float32 rounding (FMA contraction, CUDA sinf /
# cosf, 1 / p against a division) unless a decision flipped, which moves a
# whole lane; values are compared against their array's largest, since a
# Jacobian entry is a sum of products that may cancel to near zero. The
# contracted gradients (and the analytic vs autograd routes) at the JAX
# package's own tolerances (tests/test_diff.py)
GRAD_LANE_RTOL, GRAD_LANE_ATOL_REL, GRAD_LANE_SHARE = 1e-4, 1e-5, 2e-4
GRAD_RTOL, GRAD_ATOL_REL, GRAD_LOSS_RTOL = 2e-3, 2e-4, 2e-4
# the analytic volume gradient (K10) vs its plain version: the JAX package's
# own gates (tests/test_het_grad_kernel.py:116): the loss at rtol 1e-4, the
# grid at rtol 5e-3 / atol 5e-4 x its largest entry (a cell sums thousands
# of events in another order, and the kernel's in an order the atomics
# choose, which changes from run to run), Le at rtol 5e-3 / atol 1e-8
HET_GRAD_LOSS_RTOL = 1e-4
HET_GRAD_RTOL, HET_GRAD_ATOL_REL = 5e-3, 5e-4
HET_GRAD_LE_RTOL, HET_GRAD_LE_ATOL = 5e-3, 1e-8
# pass B recomputes pass A's radiance by the same explicit rounding: lanes
# beyond this are lanes where a decision went the other way
HET_REPLAY_RTOL, HET_REPLAY_ATOL = 1e-5, 1e-7
# full-size mean vs reference-size mean of the volume paths: Monte-Carlo
# noise at a few samples per pixel; the volume preset has no next-event
# estimation, so a path finds the light only by chance
VOLUME_MEAN_BAND = {"vpt_path": 0.05, "vpt_nee_path": 0.05, "nee_path": 0.05,
                    "volume_path": 0.25, "nee_wavefront_path": 0.05}

_HERE = os.path.dirname(os.path.abspath(__file__))


def emit(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def median_ms(fn, reps, flush):
    """Median over ``reps`` single launches timed with CUDA events, after
    one warm-up; ``flush`` is rewritten before each so L2 starts cold."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def mesh_scene(device, size=MESH_SIZE, builder=None):
    """The mesh GI scene of bench_mesh.py: lat-long sphere mesh + floor +
    quad light, built with the port's SceneBuilder (or ``builder``)."""
    import numpy as np

    from xraytracer_tpu_torch.math import from_rows
    from xraytracer_tpu_torch.scene.builder import SceneBuilder

    b = builder or SceneBuilder()
    white = b.add_lambert((0.8, 0.8, 0.8))
    b.add_sphere_mesh((0.0, 0.0, 0.0), 1.0, *size, material=white)
    floor = np.asarray(
        [
            [[-4, -1, -4], [4, -1, -4], [4, -1, 4]],
            [[-4, -1, -4], [4, -1, 4], [-4, -1, 4]],
        ],
        np.float32,
    )
    b.add_mesh(floor, material=white)
    b.add_quad_light(
        (-1.0, 3.0, -1.0), (1.0, 3.0, -1.0), (-1.0, 3.0, 1.0),
        (10.0, 10.0, 10.0),
    )
    c2w = from_rows(
        1.0, 0, 0, 0,
        0, 1.0, 0, 0,
        0, 0, 1.0, 0,
        0, 0.6, 4.0, 1,
    )
    return b.build(device), dict(c2w=c2w, fov_deg=45.0)


def many_light_scene(device, n_side=8, face_in=False):
    """Cornell-like room (floor, back wall, ceiling slab) under an
    n_side x n_side grid of small ceiling quad lights of skewed powers: the
    many-light workload of tests/test_megakernel.py. As wound there, the
    floor and the back wall face out of the room, so next-event estimation
    adds nothing and only directly seen lights show; ``face_in`` winds both
    to face the lights, which puts every light pick and shadow test to
    work."""
    import numpy as np

    from xraytracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    white = b.add_lambert((0.7, 0.7, 0.7))
    quads = []
    for k, (v0, v1, v2, v3) in enumerate((
        ((0, 0, 0), (556, 0, 0), (556, 0, 559), (0, 0, 559)),
        ((0, 0, 559), (556, 0, 559), (556, 548, 559), (0, 548, 559)),
        ((0, 548, 0), (556, 548, 0), (556, 548, 559), (0, 548, 559)),
    )):
        if face_in and k < 2:
            v1, v3 = v3, v1
        quads.append(np.asarray([[v0, v1, v2], [v0, v2, v3]], np.float32))
    b.add_mesh(np.concatenate(quads, axis=0), material=white)
    rng = np.random.default_rng(11)
    for i in range(n_side):
        for j in range(n_side):
            x0 = 40.0 + i * 60.0
            z0 = 40.0 + j * 60.0
            power = float(rng.uniform(0.5, 40.0))
            b.add_quad_light(
                (x0, 547.0, z0), (x0 + 30.0, 547.0, z0),
                (x0, 547.0, z0 + 30.0), (power,) * 3,
            )
    return b.build(device)


def kernel_modules():
    """The five modules that hold kernels, each with its own counts."""
    from xraytracer_tpu_torch import media_kernels
    from xraytracer_tpu_torch.geometry import kernels
    from xraytracer_tpu_torch.integrators import (
        het_megakernel,
        megakernel,
        vol_megakernel,
    )

    return kernels, megakernel, vol_megakernel, media_kernels, het_megakernel


def all_counts():
    """Launch and plain-call counts of all eighteen kernels and helpers."""
    out = {}
    for mod in kernel_modules():
        out.update(mod.counts())
    return out


def reset_all_counts():
    """Every count to 0, and the sweeps' cached chunk tables dropped: a
    path counted from here builds the chunk table of each (table, mask) it
    sweeps once, as a render of a new table does."""
    from xraytracer_tpu_torch.geometry import kernels

    for mod in kernel_modules():
        mod.reset_counts()
    kernels._chunk_tables.clear()


def chunk_builds(tables, masks):
    """chunk_boxes launches of a counted run that sweeps ``tables`` under
    ``masks`` distinct masks (none for an empty table)."""
    return masks if tables.tri_v0.shape[0] > 0 else 0


def capture_sweep_inputs(renderer):
    """Render one sample and keep the rays each sweep was given: the
    nearest-hit rays and the shadow rays (with t_max) of every bounce."""
    from xraytracer_tpu_torch.geometry import kernels

    got = {"nearest": [], "shadow": []}
    orig_rec, orig_occ = kernels.sweep_nearest_rec, kernels.occluded_anyhit

    def rec(o, d, *rest):
        got["nearest"].append((o.clone(), d.clone()))
        return orig_rec(o, d, *rest)

    def occ(o, d, v0, e1, e2, blocks, t_max):
        got["shadow"].append((o.clone(), d.clone(), t_max.clone()))
        return orig_occ(o, d, v0, e1, e2, blocks, t_max)

    kernels.sweep_nearest_rec, kernels.occluded_anyhit = rec, occ
    try:
        renderer.render(1)
    finally:
        kernels.sweep_nearest_rec, kernels.occluded_anyhit = orig_rec, orig_occ
    return got


def anyhit_tests_needed(o, d, v0, e1, e2, blocks, t_max):
    """Pair tests an any-hit sweep needs for these rays: per ray with
    t_max > 0, up to and including its first blocking triangle in table
    order, all T when none blocks; 0 for parked rays (t_max <= 0)."""
    import torch

    from xraytracer_tpu_torch.geometry import intersect as ix

    t_total = v0.shape[0]
    center = torch.mean(v0, dim=0)
    g = ix._tri_features(v0 - center, e1, e2).T.reshape(t_total, 4, 10)
    f_all = ix._ray_features(o - center, d)
    vf = blocks.to(torch.float32)
    total = 0
    for r0 in range(0, o.shape[0], ix.RAY_BLOCK_MM):
        f = f_all[r0:r0 + ix.RAY_BLOCK_MM]
        tm = t_max[r0:r0 + ix.RAY_BLOCK_MM]
        first = torch.full((f.shape[0],), t_total, dtype=torch.int64,
                           device=o.device)
        for s in range(0, t_total, ix.TRI_CHUNK_MM):
            e = min(s + ix.TRI_CHUNK_MM, t_total)
            ok, _, _, t_s, absd = ix._mm_hit_test(f, g[s:e], vf[s:e])
            blk = ok & (t_s < tm[:, None] * absd)
            has = blk.any(dim=1)
            loc = torch.argmax(blk.to(torch.int8), dim=1) + s + 1
            first = torch.where(has & (first == t_total), loc, first)
        total += int(torch.where(tm > 0.0, first, torch.zeros_like(first)).sum())
    return total


def culled_tests_needed(o, d, v0, e1, e2, mask, t_max=None):
    """(pair tests, slab tests) that the culled walk of csrc/sweep.cuh needs
    for these rays, per ray in its own visit order: every group's box, the
    boxes of the chunks of the groups it wants, and the valid rows of each
    chunk it wants itself, where it wants a box it enters before its running
    best t (nearest hit), or before its t_max and up to and including its
    first blocking row (any-hit, ``t_max`` given; 0 for parked rays). What
    the warp's other lanes make it wait for is not counted."""
    import torch

    from xraytracer_tpu_torch.geometry import intersect as ix
    from xraytracer_tpu_torch.geometry import kernels

    chunk, group = kernels.SWEEP_CHUNK, kernels.SWEEP_GROUP
    t_total = v0.shape[0]
    if t_total == 0:
        return 0, 0
    center = torch.mean(v0, dim=0)
    boxes, _ = kernels.chunk_boxes_plain(v0, e1, e2, mask, center)
    n_chunks = -(-t_total // chunk)
    g = ix._tri_features(v0 - center, e1, e2).T.reshape(t_total, 4, 10)
    vf = mask.to(torch.float32)
    oc = o - center
    f = ix._ray_features(oc, d)
    tiny = torch.full_like(d, 1e-12)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, torch.copysign(tiny, d), d)
    anyhit = t_max is not None
    best = t_max.clone() if anyhit else torch.full_like(o[:, 0], 3.4e38)
    done = ~(t_max > 0.0) if anyhit else torch.zeros_like(best, dtype=torch.bool)

    def wants(b):
        ta = (b[0:3] - oc) * inv
        tb = (b[3:6] - oc) * inv
        tmin = torch.minimum(ta, tb).amax(dim=1)
        tmax = torch.maximum(ta, tb).amin(dim=1)
        return (~done & (b[6] > 0) & (tmax >= tmin) & (tmax > 0)
                & (torch.clamp(tmin, min=0.0) < best * (1.0 + 1e-5)))

    tests = torch.zeros_like(best, dtype=torch.int64)
    slabs = torch.zeros_like(tests)
    for gi in range(-(-n_chunks // group)):
        slabs += ~done
        want_g = wants(boxes[n_chunks + gi])
        for c in range(gi * group, min(n_chunks, (gi + 1) * group)):
            slabs += want_g
            want = want_g & wants(boxes[c])
            lanes = torch.nonzero(want)[:, 0]
            if lanes.numel() == 0:
                continue
            r0, r1 = c * chunk, min(t_total, (c + 1) * chunk)
            ok, det, t_num, t_s, absd = ix._mm_hit_test(f[lanes], g[r0:r1], vf[r0:r1])
            valid = vf[r0:r1] > 0
            if anyhit:
                blk = ok & (t_s < best[lanes, None] * absd)
                has = blk.any(dim=1)
                first = torch.argmax(blk.to(torch.int8), dim=1)
                upto = torch.cumsum(valid.to(torch.int64), 0)
                tests[lanes] += torch.where(has, upto[first], upto[-1])
                done[lanes[has]] = True
            else:
                tests[lanes] += int(valid.sum())
                t = torch.where(ok, t_num / det, torch.full_like(t_num, 3.4e38))
                best[lanes] = torch.minimum(best[lanes], t.amin(dim=1))
    return int(tests.sum()), int(slabs.sum())


def bound_ms(n_bytes, n_tests, flops_per_test):
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_tests * flops_per_test / PEAK_F32_FLOPS * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def grazing_slack(o, d, v0, e1, e2, idx):
    """Per-ray error bounds (for t, for u and v) of the winner epilogue from
    its conditioning alone: GRAZING_ULPS float32 ulps of |o - v0| / |cos|."""
    import torch

    ix = torch.clamp(idx, min=0).to(torch.int64)
    w_e1, w_e2 = e1[ix], e2[ix]
    ng = torch.linalg.cross(w_e1, w_e2)
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
    cos = torch.abs((d * ng).sum(-1)) / torch.clamp(norm(d) * norm(ng), min=1e-30)
    slack_t = GRAZING_ULPS * 2.0 ** -23 * norm(o - v0[ix]) / torch.clamp(cos, min=1e-12)
    edge = torch.clamp(torch.minimum(norm(w_e1), norm(w_e2)), min=1e-30)
    return slack_t, slack_t / edge


def compare_nearest(got, ref, with_rec, slack=None):
    """Kernel vs plain nearest-hit outputs -> dict of counts and max errors;
    fails on anything outside the stated tolerances. ``slack`` =
    ``grazing_slack(...)`` widens the t and u, v limits per ray."""
    import torch

    kt, ki, ku, kv = got[:4]
    pt, pi, pu, pv = ref[:4]
    n = kt.shape[0]
    mism = ki != pi
    flips = (ki >= 0) != (pi >= 0)
    both = (ki >= 0) & (pi >= 0)
    rel = torch.abs(kt - pt) / torch.clamp(torch.abs(pt), min=1e-9)
    in_band = mism & both & (rel < TIE_BAND)
    out_band = mism & ~in_band
    agree = both & ~mism

    def max_err(a, b, rtol, atol, what, extra=None):
        if not bool(agree.any()):
            return 0.0
        err = torch.abs(a - b)[agree]
        lim = atol + rtol * torch.abs(b)
        if extra is not None:
            lim = lim + extra
        lim = lim[agree]
        over = int((err > lim).sum())
        worst = int(torch.argmax(err - lim))
        check(over == 0,
              f"{what}: {over} lanes beyond rtol {rtol} atol {atol}; worst "
              f"kernel {float(a[agree][worst])} plain {float(b[agree][worst])}")
        return float(err.max())

    out = dict(
        n=n,
        hits=int((pi >= 0).sum()),
        idx_mismatch=int(mism.sum()),
        idx_mismatch_in_tie_band=int(in_band.sum()),
        idx_mismatch_outside=int(out_band.sum()),
        hit_miss_flips=int(flips.sum()),
        flip_share=float(flips.sum()) / max(n, 1),
        t_max_abs_err=max_err(kt, pt, T_RTOL, T_ATOL, "t",
                              None if slack is None else slack[0]),
        u_max_abs_err=max_err(ku, pu, UV_RTOL, UV_ATOL, "u",
                              None if slack is None else slack[1]),
        v_max_abs_err=max_err(kv, pv, UV_RTOL, UV_ATOL, "v",
                              None if slack is None else slack[1]),
    )
    if slack is not None:
        # how many lanes needed the widening at all
        plain_lim = T_ATOL + T_RTOL * torch.abs(pt)
        out["t_lanes_beyond_plain_limit"] = int(
            ((torch.abs(kt - pt) > plain_lim) & agree).sum())
    check(
        out["idx_mismatch_outside"] <= max(1, IDX_MISMATCH_SHARE * n),
        f"idx mismatches outside the tie band: {out['idx_mismatch_outside']} of {n}",
    )
    miss_k = ki < 0
    check(bool((kt[miss_k] > 3.0e38).all()) and bool((ku[miss_k] == 0).all())
          and bool((kv[miss_k] == 0).all()), "miss lanes must be (INF, -1, 0, 0)")
    if with_rec:
        krec, prec = got[4], ref[4]
        err = torch.abs(krec - prec)[agree | ((ki < 0) & (pi < 0))]
        out["rec_max_abs_err"] = float(err.max()) if err.numel() else 0.0
        check(out["rec_max_abs_err"] <= REC_ATOL,
              f"rec differs by {out['rec_max_abs_err']}")
        check(bool((krec[miss_k] == 0).all()), "rec must be zero on miss")
    return out


def kernel_cases(tables, rays_sets, flush, reps):
    """Run the three kernels and their plain versions on every ray set of
    one scene table. Returns {kernel: [case dict, ...]}."""
    import torch

    from xraytracer_tpu_torch.geometry import kernels

    v0, e1, e2 = tables.tri_v0, tables.tri_e1, tables.tri_e2
    valid = tables.tri_obj >= 0
    light = tables.obj_light[torch.clamp(tables.tri_obj, min=0).to(torch.int64)]
    blocks = valid & (light < 0)
    rec_tab = tables.tri_rec
    t_total = v0.shape[0]
    tri_bytes = t_total * (36 + 1) + 12
    out = {k: [] for k in kernels.SWEEPS}

    for label, (o, d) in rays_sets["nearest"].items():
        n = o.shape[0]
        tests, slabs = culled_tests_needed(o, d, v0, e1, e2, valid)
        for name, with_rec in (("sweep_nearest", False), ("sweep_nearest_rec", True)):
            if with_rec:
                run_k = lambda: kernels.sweep_nearest_rec(o, d, v0, e1, e2, valid, rec_tab)
                run_p = lambda: kernels.sweep_nearest_rec_plain(o, d, v0, e1, e2, valid, rec_tab)
                n_bytes = n * (24 + 16 + 128) + tri_bytes + t_total * 128
            else:
                run_k = lambda: kernels.sweep_nearest(o, d, v0, e1, e2, valid)
                run_p = lambda: kernels.sweep_nearest_plain(o, d, v0, e1, e2, valid)
                n_bytes = n * (24 + 16) + tri_bytes
            got, ref = run_k(), run_p()
            torch.cuda.synchronize()
            case = compare_nearest(got, ref, with_rec)
            case["bitwise_vs_plain_mismatch"] = int(
                ((got[0] != ref[0]) | (got[1] != ref[1])).sum())
            if "sorted" in label:
                case["shuffled_lanes_bitwise"] = lanes_independent(
                    lambda oo, dd: kernels.sweep_nearest_rec(oo, dd, v0, e1, e2, valid, rec_tab)
                    if with_rec else kernels.sweep_nearest(oo, dd, v0, e1, e2, valid),
                    got, o, d, f"{name} {label}")
            del got, ref
            b_ms, b_by = bound_ms(n_bytes, tests * FLOPS_PER_TEST + slabs * FLOPS_PER_SLAB, 1)
            case.update(
                case=label, t_total=t_total,
                ms=median_ms(run_k, reps, flush),
                plain_ms=median_ms(run_p, reps, flush),
                bound_ms=b_ms, bound_by=b_by, tests_needed=tests, slabs_needed=slabs,
                tests_brute=n * t_total,
                brute_bound_ms=bound_ms(n_bytes, n * t_total, FLOPS_PER_TEST)[0],
            )
            out[name].append(case)

    for label, (o, d, tm) in rays_sets["shadow"].items():
        n = o.shape[0]
        run_k = lambda: kernels.occluded_anyhit(o, d, v0, e1, e2, blocks, tm)
        run_p = lambda: kernels.occluded_anyhit_plain(o, d, v0, e1, e2, blocks, tm)
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        mism = int((got != ref).sum())
        check(mism <= max(1, BLOCKED_MISMATCH_SHARE * n),
              f"occluded_anyhit {label}: {mism} of {n} lanes disagree")
        check(not bool(got[tm <= 0].any()), "a lane with t_max <= 0 was blocked")
        shuffled = None
        if "sorted" in label or "parked" in label:
            shuffled = lanes_independent(
                lambda oo, dd, tt: (kernels.occluded_anyhit(oo, dd, v0, e1, e2, blocks, tt),),
                (got,), o, d, f"occluded_anyhit {label}", tm)
        # the tri_fn route sweeps the same rays with sweep_nearest over the
        # blocks mask and derives blocked = t < t_max
        run_k2 = lambda: kernels.sweep_nearest(o, d, v0, e1, e2, blocks)
        run_p2 = lambda: kernels.sweep_nearest_plain(o, d, v0, e1, e2, blocks)
        got2, ref2 = run_k2(), run_p2()
        torch.cuda.synchronize()
        case2 = compare_nearest(
            got2, ref2, False, grazing_slack(o, d, v0, e1, e2, ref2[1]))
        mism2 = int(((got2[0] < tm) != (ref2[0] < tm)).sum())
        check(mism2 <= max(1, BLOCKED_MISMATCH_SHARE * n),
              f"sweep_nearest {label}: {mism2} of {n} derived blocked flags disagree")
        mism24 = int(((got2[0] < tm) != got).sum())
        check(mism24 <= max(1, BLOCKED_MISMATCH_SHARE * n),
              f"sweep_nearest {label}: {mism24} of {n} derived blocked flags "
              f"differ from occluded_anyhit's")
        del got2, ref2
        n_bytes = n * (24 + 16) + tri_bytes
        tests, slabs = culled_tests_needed(o, d, v0, e1, e2, blocks)
        b_ms, b_by = bound_ms(n_bytes, tests * FLOPS_PER_TEST + slabs * FLOPS_PER_SLAB, 1)
        case2.update(
            case=f"{label}, blocks mask", t_total=t_total,
            derived_blocked_mismatch=mism2,
            derived_blocked_vs_anyhit_kernel=mism24,
            ms=median_ms(run_k2, reps, flush),
            plain_ms=median_ms(run_p2, reps, flush),
            bound_ms=b_ms, bound_by=b_by, tests_needed=tests, slabs_needed=slabs,
            tests_brute=n * t_total,
            brute_bound_ms=bound_ms(n_bytes, n * t_total, FLOPS_PER_TEST)[0],
        )
        out["sweep_nearest"].append(case2)
        # the brute-force walk's count (up to the first blocker in table
        # order) and the culled walk's
        brute = anyhit_tests_needed(o, d, v0, e1, e2, blocks, tm)
        tests, slabs = culled_tests_needed(o, d, v0, e1, e2, blocks, tm)
        n_bytes = n * (24 + 4 + 1) + tri_bytes
        b_ms, b_by = bound_ms(
            n_bytes, tests * FLOPS_PER_ANYHIT_TEST + slabs * FLOPS_PER_SLAB, 1)
        out["occluded_anyhit"].append(dict(
            case=label, n=n, t_total=t_total,
            blocked=int(ref.sum()), parked=int((tm <= 0).sum()),
            blocked_mismatch=mism, mismatch_share=mism / max(n, 1),
            shuffled_lanes_bitwise=shuffled,
            tests_needed=tests, slabs_needed=slabs, tests_brute_needed=brute,
            tests_brute=n * t_total,
            ms=median_ms(run_k, reps, flush),
            plain_ms=median_ms(run_p, reps, flush),
            bound_ms=b_ms, bound_by=b_by,
            brute_bound_ms=bound_ms(n_bytes, brute, FLOPS_PER_ANYHIT_TEST)[0],
        ))
    for cases in out.values():
        for c in cases:
            c["ms_over_bound"] = c["ms"] / c["bound_ms"]
    return out


def lanes_independent(run, got, o, d, what, t_max=None):
    """A sweep's result for a lane must not depend on which lanes share its
    warp (the sorted route's images are bitwise the unsorted route's only
    if so): run the kernel on a seeded permutation of the lanes and hold
    every output, put back in lane order, bitwise against ``got``."""
    import torch

    gen = torch.Generator(device=o.device).manual_seed(0)
    perm = torch.randperm(o.shape[0], device=o.device, generator=gen)
    args = (o[perm], d[perm]) + (() if t_max is None else (t_max[perm],))
    again = run(*args)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, again)):
        back = torch.empty_like(b)
        back[perm] = b
        n_diff = int((back != a).reshape(a.shape[0], -1).any(dim=1).sum())
        check(n_diff == 0, f"{what}: output {k} of {n_diff} lanes changed with "
                           f"the lanes' order")
    return True


def edge_cases(device):
    """Small and ragged shapes, masked tiles, parked lanes, parallel rays."""
    import numpy as np
    import torch

    from xraytracer_tpu_torch.geometry import kernels

    def tris(t_total, seed, scale=4.0):
        rng = np.random.default_rng(seed)
        mk = lambda a: torch.as_tensor(a.astype(np.float32)).to(device)
        return (mk(rng.uniform(-scale, scale, (t_total, 3))),
                mk(rng.uniform(-1.5, 1.5, (t_total, 3))),
                mk(rng.uniform(-1.5, 1.5, (t_total, 3))))

    def rays(n, seed, scale=6.0):
        rng = np.random.default_rng(seed)
        o = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return torch.as_tensor(o).to(device), torch.as_tensor(d).to(device)

    done = []
    for t_total, n, note in ((8, 1, "T=8 N=1"), (8, 4097, "T=8 N=4097"),
                             (300, 4097, "ragged T=300 N=4097")):
        v0, e1, e2 = tris(t_total, seed=t_total)
        o, d = rays(n, seed=n)
        valid = torch.ones((t_total,), dtype=torch.bool, device=device)
        rec_tab = torch.arange(t_total * 32, dtype=torch.float32,
                               device=device).reshape(t_total, 32)
        got = kernels.sweep_nearest_rec(o, d, v0, e1, e2, valid, rec_tab)
        ref = kernels.sweep_nearest_rec_plain(o, d, v0, e1, e2, valid, rec_tab)
        c = compare_nearest(got, ref, True)
        got2 = kernels.sweep_nearest(o, d, v0, e1, e2, valid)
        check(bool((got2[1] == got[1]).all()), f"{note}: K2 and K3 idx differ")
        tm = torch.full((n,), 5.0, device=device)
        tm[::2] = 0.0
        blk = kernels.occluded_anyhit(o, d, v0, e1, e2, valid, tm)
        ref_b = kernels.occluded_anyhit_plain(o, d, v0, e1, e2, valid, tm)
        check(not bool(blk[::2].any()), f"{note}: parked lane blocked")
        check(int((blk != ref_b).sum()) <= max(1, BLOCKED_MISMATCH_SHARE * n),
              f"{note}: blocked mismatch")
        done.append(dict(case=note, hits=c["hits"],
                         idx_mismatch=c["idx_mismatch"],
                         blocked=int(blk.sum())))

    # one tile fully masked out, then the whole table masked out
    v0, e1, e2 = tris(256, seed=5)
    o, d = rays(2000, seed=6)
    valid = torch.ones((256,), dtype=torch.bool, device=device)
    valid[128:] = False
    got = kernels.sweep_nearest(o, d, v0, e1, e2, valid)
    ref = kernels.sweep_nearest_plain(o, d, v0, e1, e2, valid)
    c = compare_nearest(got, ref, False)
    check(int(got[1].max()) < 128, "a masked-out triangle was hit")
    none = torch.zeros_like(valid)
    got = kernels.sweep_nearest(o, d, v0, e1, e2, none)
    check(bool((got[1] == -1).all()), "hit in an all-invalid table")
    tm = torch.full((2000,), 1e9, device=device)
    check(not bool(kernels.occluded_anyhit(o, d, v0, e1, e2, none, tm).any()),
          "blocked by an all-invalid table")
    done.append(dict(case="masked tile / all-invalid table", hits=c["hits"]))

    # an empty table: no chunk table to build, every lane misses
    empty = torch.zeros((0, 3), device=device)
    no_rows = torch.zeros((0,), dtype=torch.bool, device=device)
    got = kernels.sweep_nearest_rec(o, d, empty, empty, empty, no_rows,
                                    torch.zeros((0, 32), device=device))
    check(bool((got[1] == -1).all()) and not bool(got[4].any()), "hit in an empty table")
    check(not bool(kernels.occluded_anyhit(o, d, empty, empty, empty, no_rows, tm).any()),
          "blocked by an empty table")
    done.append(dict(case="empty table (T = 0)", hits=0))

    # rays parallel to (and in the plane of) a triangle never hit it
    v0 = torch.tensor([[0.0, 0.0, 0.0]] * 8, device=device)
    e1 = torch.tensor([[1.0, 0.0, 0.0]] * 8, device=device)
    e2 = torch.tensor([[0.0, 1.0, 0.0]] * 8, device=device)
    o = torch.tensor([[-1.0, 0.2, 0.0], [-1.0, 0.2, 0.5], [0.2, 0.2, 1.0]],
                     device=device)
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]],
                     device=device)
    valid = torch.ones((8,), dtype=torch.bool, device=device)
    t, idx, _, _ = kernels.sweep_nearest(o, d, v0, e1, e2, valid)
    check(idx.tolist() == [-1, -1, 0] and abs(float(t[2]) - 1.0) < 1e-6,
          f"parallel rays: idx {idx.tolist()} t {t.tolist()}")
    done.append(dict(case="rays parallel to a triangle", idx=idx.tolist()))
    torch.cuda.synchronize()
    return done


def summarize(cases_by_kernel, headline):
    """The contract's per-kernel entry from the headline case."""
    from xraytracer_tpu_torch.geometry import kernels

    meta = {
        "sweep_nearest": "xraytracer_tpu/geometry/pallas_kernels.py:51",
        "sweep_nearest_rec": "xraytracer_tpu/geometry/pallas_kernels.py:67",
        "occluded_anyhit": "xraytracer_tpu/geometry/pallas_kernels.py:420",
    }
    entries = []
    for name in kernels.SWEEPS:
        cases = cases_by_kernel[name]
        head = next(c for c in cases if c["case"] == headline[name])
        if name == "occluded_anyhit":
            err = max(c["mismatch_share"] for c in cases)
        else:
            err = max(c["t_max_abs_err"] for c in cases)
        entries.append(dict(
            name=name, route="cuda",
            source="xraytracer_tpu_torch/csrc/sweep.cu",
            replaces=meta[name],
            launches=None,  # filled from the driven paths' own counts
            launches_by_path=None,
            max_abs_err=err,
            err_of=("share of lanes whose blocked flag differs, worst case"
                    if name == "occluded_anyhit"
                    else "winner t on lanes that agree on idx, worst case"),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None,
            shape=f"{head['case']}: N={head['n']} T={head['t_total']}",
            cases=[{k: c[k] for k in ("case", "n", "t_total", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "brute_bound_ms")}
                   for c in cases],
        ))
    return entries


CHUNK_REPLACES = "xraytracer_tpu/geometry/pallas_kernels.py:794"


def check_chunk_boxes(tables_by_label, reps, flush):
    """chunk_boxes (the chunk table the sweeps walk) against its plain
    version on each scene's table under both masks: the boxes bitwise, the
    coefficient rows to float rounding (nvcc contracts their products);
    timed beside its bytes bound (the table and mask read once, the boxes
    and the coefficient rows written once). Returns the ``kernels`` entry."""
    import torch

    from xraytracer_tpu_torch.geometry import kernels

    cases = []
    for label, tables in tables_by_label.items():
        v0, e1, e2 = tables.tri_v0, tables.tri_e1, tables.tri_e2
        valid = tables.tri_obj >= 0
        light = tables.obj_light[torch.clamp(tables.tri_obj, min=0).to(torch.int64)]
        for mname, mask in (("valid", valid), ("blocks", valid & (light < 0))):
            center = kernels._center(v0)
            boxes, coef = kernels.chunk_boxes(v0, e1, e2, mask, center)
            pboxes, pcoef = kernels.chunk_boxes_plain(v0, e1, e2, mask, center)
            torch.cuda.synchronize()
            bad = int((boxes != pboxes).any(dim=1).sum())
            check(bad == 0, f"chunk_boxes, {label} {mname}: {bad} box rows differ "
                            f"from the plain version")
            err = float(torch.abs(coef - pcoef).max())
            scale = float(torch.abs(pcoef).max())
            check(err <= 1e-5 * scale, f"chunk_boxes, {label} {mname}: coefficients "
                                       f"differ by {err} (largest {scale})")
            t_total = v0.shape[0]
            n_bytes = t_total * (36 + 1) + 12 + boxes.numel() * 4 + coef.numel() * 4
            cases.append(dict(
                case=f"{label}, {mname} mask", t_total=t_total, box_rows=boxes.shape[0],
                box_rows_differ=bad, coef_max_abs_err=err, coef_largest=scale,
                ms=median_ms(lambda: kernels.chunk_boxes(v0, e1, e2, mask, center),
                             reps, flush),
                plain_ms=median_ms(lambda: kernels.chunk_boxes_plain(
                    v0, e1, e2, mask, center), reps, flush),
                bound_ms=n_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes"))
    emit("kernel_checks", kernels="chunk table of the sweeps", cases=cases, reps=reps)
    head = cases[-1]
    return dict(
        name="chunk_boxes", route="cuda", source="xraytracer_tpu_torch/csrc/sweep.cu",
        replaces=CHUNK_REPLACES, launches=None, launches_by_path=None,
        replaces_note="no TPU kernel: the XLA pre-pass of every Pallas sweep "
                      "(_build_chunk_aabbs, _build_g_chunks), built here once per "
                      "table and mask",
        max_abs_err=max(c["coef_max_abs_err"] for c in cases),
        err_of="coefficient rows against the plain version (boxes bitwise: 0 rows differ)",
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=None,
        shape=f"{head['case']}: T={head['t_total']}",
        cases=[{k: c[k] for k in ("case", "t_total", "ms", "bound_ms", "plain_ms")}
               for c in cases])


def render_checks(label, result, spp, counts, expected, ref_kernel, ref_plain):
    """The checks every driven path must pass; returns the line's fields.
    ``expected`` maps the kernels of the path's route to their launch
    counts; every other kernel must show 0."""
    import numpy as np

    check(result.image.shape == (HEIGHT, WIDTH, 3), f"{label}: image shape")
    check(bool(np.isfinite(result.image).all()), f"{label}: non-finite pixels")
    check(result.n_rejected == 0, f"{label}: {result.n_rejected} rejected samples")
    for name, c in counts.items():
        want = expected.get(name, 0)
        check(c["launches"] == want,
              f"{label}: {name} launched {c['launches']}x, expected {want}")
    plain = sum(c["plain_calls"] for c in counts.values())
    check(plain == 0, f"{label}: {plain} plain-version calls on the card")
    m_full = float(result.image.mean())
    m_k = float(ref_kernel.image.mean())
    m_p = float(ref_plain.image.mean())
    check(abs(m_k - m_p) <= MEAN_BAND_KERNEL_VS_PLAIN * m_p,
          f"{label}: {REF_W}x{REF_H} mean {m_k} (kernels) vs {m_p} (plain)")
    check(abs(m_full - m_p) <= MEAN_BAND_FULL_VS_REF * m_p,
          f"{label}: full-size mean {m_full} vs plain reference {m_p}")
    diff = np.abs(ref_kernel.image - ref_plain.image)
    lim = 1e-6 + 1e-4 * np.abs(ref_plain.image)
    n_diff = int((diff > lim).any(axis=-1).sum())
    check(n_diff <= REF_PIXEL_DIFF_SHARE * REF_W * REF_H,
          f"{label}: {n_diff} of {REF_W * REF_H} reference pixels differ "
          f"between the kernels and the plain path")
    return dict(
        width=WIDTH, height=HEIGHT, depth=DEPTH, spp=spp,
        seconds=result.seconds,
        msamples_per_s=result.samples_per_sec / 1e6,
        n_rejected=result.n_rejected,
        mean_radiance=m_full,
        ref_mean_kernels=m_k, ref_mean_plain=m_p,
        ref_pixels_differing=n_diff,
        ref_pixels=REF_W * REF_H,
        ref_pixels_differing_limit=int(REF_PIXEL_DIFF_SHARE * REF_W * REF_H),
        launches={k: v["launches"] for k, v in counts.items()},
        plain_calls=plain,
    )


def reference_renders(tables, cam_kwargs, statics, spp, cosine, device,
                      fused="never"):
    """The same scene at the reference size, same seed and spp: once through
    the kernels (of the route ``fused`` selects), once through the plain
    path (``tri_fn`` = the plain matmul-form sweep, so no kernel runs)."""
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.geometry.intersect import intersect_triangles_mm
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.renderer import render

    cam = PinholeCamera.make(REF_W / REF_H, device=device, **cam_kwargs)
    if fused == "auto":
        # the whole-render kernel against its own plain version (which takes
        # the kernel's camera-ray formulas), assembled like the renderer does
        from types import SimpleNamespace

        from xraytracer_tpu_torch.integrators import megakernel as mk

        integ = make_path_integrator(tables, statics, DEPTH, nee=True,
                                     cosine_sampling=cosine)
        by_kernel = render(tables, cam, integ, REF_W, REF_H, spp, seed=0)
        fs = mk._bake(tables, statics, DEPTH, True, True, cosine)
        view = mk.try_make_fused_spp_render(
            tables, statics, cam, REF_W, REF_H, 0, DEPTH,
            cosine_sampling=cosine).view
        rad, _ = mk.mega_spp_persistent_plain(fs, view, 0, spp)
        by_plain = SimpleNamespace(
            image=rad.cpu().numpy().reshape(REF_H, REF_W, 3) / spp)
        return by_kernel, by_plain
    out = []
    for tri_fn in (None, intersect_triangles_mm):
        integ = make_path_integrator(tables, statics, DEPTH, nee=True,
                                     cosine_sampling=cosine, tri_fn=tri_fn,
                                     fused=fused)
        out.append(render(tables, cam, integ, REF_W, REF_H, spp, seed=0))
    return out


def load_sweep_without_fma():
    """Compile ``csrc/sweep.cu`` once more with ``-fmad=false`` (no
    contraction of multiply-adds) next to the package's own library and
    return (ctypes handle, build seconds). The package builds and loads only
    its one flag set; this second library exists for the A/B alone."""
    import ctypes

    from xraytracer_tpu_torch import _build
    from xraytracer_tpu_torch.geometry import kernels

    t0 = time.perf_counter()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, "libsweep_fmad_false.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-fmad=false", "-o", out,
           os.path.join(_build.CSRC_DIR, "sweep.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    check(proc.returncode == 0, f"-fmad=false build failed:\n{proc.stderr}")
    return kernels._bind(ctypes.CDLL(out)), time.perf_counter() - t0


def phase_kernels(device, scenes_in, reps, fmad_ab):
    """Capture the sweeps' real inputs, then hold every kernel against its
    plain version on them and on the edge cases."""
    import torch

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.geometry import kernels
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    scenes = {}
    for label, (tables, camk, cosine) in scenes_in.items():
        st = scene_statics(tables)
        cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **camk)

        def capture(sort):
            integ = make_path_integrator(tables, st, DEPTH, nee=True,
                                         cosine_sampling=cosine, fused="never",
                                         sort_rays=sort)
            r = WavefrontRenderer(tables, cam, integ, WIDTH, HEIGHT, seed=0)
            got = capture_sweep_inputs(r)
            check(len(got["nearest"]) == DEPTH and len(got["shadow"]) == DEPTH,
                  f"{label}: expected {DEPTH} sweeps of each kind in one sample")
            return got

        got = capture(False)
        sets = dict(
            nearest={f"{label} depth-0 camera rays": got["nearest"][0],
                     f"{label} depth-1 bounce rays": got["nearest"][1]},
            shadow={f"{label} depth-0 shadow rays": got["shadow"][0],
                    f"{label} depth-1 shadow rays": got["shadow"][1]},
        )
        if int((tables.tri_obj >= 0).sum()) > SORT_ROWS:
            # the rays of the sorted route (sort_rays="auto" on this table):
            # bounce rays sorted with the dead lanes parked, shadow rays
            # sorted with the dead ones parked at t_max = 0
            got = capture(True)
            sets["nearest"][f"{label} depth-1 bounce rays, sorted"] = got["nearest"][1]
            sets["shadow"][f"{label} depth-0 shadow rays, parked"] = got["shadow"][0]
            sets["shadow"][f"{label} depth-1 shadow rays, sorted and parked"] = (
                got["shadow"][1])
        scenes[label] = (tables, sets)

    def run_all_cases():
        merged = {k: [] for k in kernels.SWEEPS}
        for tables, sets in scenes.values():
            for k, v in kernel_cases(tables, sets, flush, reps).items():
                merged[k].extend(v)
        return merged

    cases = run_all_cases()
    chunk_entry = check_chunk_boxes(
        {label: tables for label, (tables, _) in scenes.items()}, reps, flush)
    edges = edge_cases(device)
    emit("kernel_checks", kernels="sweeps", flags=[], cases=cases,
         edge_cases=edges, reps=reps, tolerances=dict(
             idx_mismatch_share_outside_tie_band=IDX_MISMATCH_SHARE,
             tie_band_rel_t=TIE_BAND, t=[T_RTOL, T_ATOL],
             uv=[UV_RTOL, UV_ATOL], rec_atol=REC_ATOL,
             blocked_mismatch_share=BLOCKED_MISMATCH_SHARE))
    if fmad_ab:
        lib, ab_build_s = load_sweep_without_fma()
        package_lib = kernels._lib
        kernels._lib = lambda: lib
        try:
            emit("kernel_checks", kernels="sweeps", flags=["-fmad=false"],
                 build_seconds=ab_build_s, cases=run_all_cases(), reps=reps)
        finally:
            kernels._lib = package_lib
    return summarize(cases, {
        "sweep_nearest": "cornell depth-0 camera rays",
        "sweep_nearest_rec": "cornell depth-0 camera rays",
        "occluded_anyhit": "cornell depth-0 shadow rays",
    }) + [chunk_entry]


MEGA_REPLACES = {
    "mega_path": "xraytracer_tpu/integrators/megakernel.py:781",
    "mega_spp": "xraytracer_tpu/integrators/megakernel.py:1468",
    "mega_spp_persistent": "xraytracer_tpu/integrators/megakernel.py:1519",
}


def timed_once(fn):
    """(result, ms) of one call between two CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare_radiance(what, got, ref, rej_got=None, rej_ref=None):
    """Whole-path kernel vs plain version, per pixel -> dict of counts and
    errors; fails when the share of pixels beyond K1_RTOL / K1_ATOL, the
    mean or the reject counts are off."""
    import torch

    n = ref.shape[0]
    check(tuple(got.shape) == (n, 3) and bool(torch.isfinite(got).all()),
          f"{what}: shape or non-finite values")
    diff = torch.abs(got - ref)
    beyond = (diff > K1_ATOL + K1_RTOL * torch.abs(ref)).any(dim=-1)
    loose = (diff > K1_LOOSE_ATOL + K1_LOOSE_RTOL * torch.abs(ref)).any(dim=-1)
    out = dict(
        n=n, max_abs_err=float(diff.max()),
        pixels_differing_at_all=int((diff > 0).any(dim=-1).sum()),
        pixels_beyond_gate=int(beyond.sum()),
        pixels_beyond_loose_gate=int(loose.sum()),
        mean_kernel=float(got.mean()), mean_plain=float(ref.mean()),
    )
    check(out["pixels_beyond_gate"] <= max(1, K1_PIXEL_DIFF_SHARE * n),
          f"{what}: {out['pixels_beyond_gate']} of {n} pixels beyond rtol "
          f"{K1_RTOL} / atol {K1_ATOL}")
    check(abs(out["mean_kernel"] - out["mean_plain"])
          <= MEAN_BAND_KERNEL_VS_PLAIN * abs(out["mean_plain"]),
          f"{what}: mean {out['mean_kernel']} vs plain {out['mean_plain']}")
    if rej_ref is not None:
        out["rejected_kernel"] = int(rej_got.sum())
        out["rejected_plain"] = int(rej_ref.sum())
        check(out["rejected_kernel"] == out["rejected_plain"],
              f"{what}: reject counts {out['rejected_kernel']} vs "
              f"{out['rejected_plain']}")
    return out


def mega_bound(n, t_total, n_lights, stats, bytes_in, bytes_out):
    """bound_ms of a whole-path launch from the plain version's per-bounce
    counters on the same inputs."""
    rays = int(stats["rays"].sum())
    shadow = int(stats["shadow_rays"].sum())
    n_bytes = n * (bytes_in + bytes_out) + t_total * (36 + 2 + 128) + n_lights * 80
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = (rays * t_total * FLOPS_PER_TEST
              + shadow * t_total * FLOPS_PER_ANYHIT_TEST) / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                rays=rays, shadow_rays=shadow)


class MegaRayLog:
    """While open (and ``on``), records the rays the plain version of a whole
    path traces (``integrators.surface``'s ``intersect_scene`` and
    ``occluded``): per call of the integrator (``max_depth`` bounces, every
    lane of the wavefront at each) a list of (path o, d, [(shadow o, d,
    t_max, walked)]), where ``walked`` marks the light samples whose shadow
    ray the kernels walk (mega_path.cuh's ``light_sample``: ``test``): the
    lane reaches next-event estimation at that vertex (it hit a surface
    that is not an emitter and the roulette kept it), the sample's pdf and
    cosine are positive, the path's and the light's directions lie above
    the shading normal, the light faces the point and t_max > 0."""

    def __init__(self, max_depth, on=True):
        self.max_depth, self.on = max_depth, on
        self.paths = []

    def __enter__(self):
        from xraytracer_tpu_torch.integrators import surface

        names = ("intersect_scene", "occluded", "sample_area_light", "_nee_area_lights")
        self._orig = {k: getattr(surface, k) for k in names}
        if not self.on:
            return self
        orig = self._orig
        vertex = {}

        def intersect_scene(scene, rays, **kw):
            hit = orig["intersect_scene"](scene, rays, **kw)
            if not self.paths or len(self.paths[-1]) == self.max_depth:
                self.paths.append([])
            self.paths[-1].append((rays.o, rays.d, []))
            return hit

        def nee_area_lights(scene, statics, hit, d_in, throughput, keys, site0,
                            tri_fn, active, **kw):
            vertex.update(hit=hit, d_in=d_in, active=active)
            return orig["_nee_area_lights"](scene, statics, hit, d_in, throughput,
                                            keys, site0, tri_fn, active, **kw)

        def sample_area_light(scene, light_idx, position, u2, *a, **kw):
            ls = orig["sample_area_light"](scene, light_idx, position, u2, *a, **kw)
            vertex.update(scene=scene, light_idx=light_idx, ls=ls)
            return ls

        def occluded(scene, rays, t_max, **kw):
            import torch

            hit, ls = vertex["hit"], vertex["ls"]
            li = torch.clamp(vertex["light_idx"], min=0).to(torch.int64)
            tm = torch.as_tensor(t_max, dtype=torch.float32,
                                 device=rays.o.device).expand(rays.o.shape[0])
            walked = (vertex["active"] & (ls.pdf > 0.0)
                      & (torch.sum(hit.ng * ls.wi, dim=-1) > 0.0)
                      & (torch.sum(-vertex["d_in"] * hit.ns, dim=-1) > 0.0)
                      & (torch.sum(ls.wi * hit.ns, dim=-1) > 0.0)
                      & (torch.sum(ls.wi * vertex["scene"].al_ng[li], dim=-1) < 0.0)
                      & (tm > 0.0))
            self.paths[-1][-1][2].append((rays.o, rays.d, tm, walked))
            return orig["occluded"](scene, rays, t_max, **kw)

        surface.intersect_scene, surface.occluded = intersect_scene, occluded
        surface.sample_area_light = sample_area_light
        surface._nee_area_lights = nee_area_lights
        return self

    def __exit__(self, *exc):
        from xraytracer_tpu_torch.integrators import surface

        for k, fn in self._orig.items():
            setattr(surface, k, fn)
        return False


def mega_culled_bound(fs, paths, bytes_in, bytes_out, n):
    """bound_ms of a whole-path launch that walks its table over its chunk
    table (the merged loop on a table it does not stage): per path ray and
    per shadow ray the pair and slab tests of ``culled_tests_needed`` in its
    own visit order, from the rays the plain version traced for the same
    samples (``MegaRayLog``). A lane's path ray counts at a bounce it
    reaches (its ray changed since the bounce before; every lane at the
    first), a shadow ray where the kernel walks it (``MegaRayLog``'s
    ``walked``)."""
    import torch

    s = fs.scene
    v0, e1, e2 = s.tri_v0, s.tri_e1, s.tri_e2
    valid, blocks = fs.valid.bool(), fs.blocks.bool()
    tests = slabs = shadow_tests = shadow_slabs = n_path = n_shadow = 0
    for bounces in paths:
        prev = None
        for o, d, shadows in bounces:
            live = (torch.ones_like(o[:, 0], dtype=torch.bool) if prev is None else
                    ((o != prev[0]).any(dim=1) | (d != prev[1]).any(dim=1)))
            prev = (o, d)
            t, sl = culled_tests_needed(o[live], d[live], v0, e1, e2, valid)
            tests, slabs, n_path = tests + t, slabs + sl, n_path + int(live.sum())
            for so, sd, tm, w in shadows:
                t, sl = culled_tests_needed(so[w], sd[w], v0, e1, e2, blocks, tm[w])
                shadow_tests, shadow_slabs = shadow_tests + t, shadow_slabs + sl
                n_shadow += int(w.sum())
    t_total = v0.shape[0]
    n_bytes = n * (bytes_in + bytes_out) + t_total * (36 + 2 + 128) + fs.n_lights * 80
    b_ms, b_by = bound_ms(n_bytes, tests * FLOPS_PER_TEST + shadow_tests
                          * FLOPS_PER_ANYHIT_TEST + (slabs + shadow_slabs) * FLOPS_PER_SLAB, 1)
    return dict(bound_ms=b_ms, bound_by=b_by, culled=dict(
        path_rays=n_path, shadow_rays=n_shadow, pair_tests=tests,
        anyhit_tests=shadow_tests, slab_tests=slabs + shadow_slabs))


# --k1b-probe: megakernel.cu's K1b with every shadow ray walked at once on a
# staged table (K1a's split: "at_once"), and with the staged walk's shadow
# rays through L1 as well ("at_once_l1"); each an exact edit of the source
K1B_PROBE_EDITS = {
    "at_once": (("single_path<WALK, true>(S, center, p, ng, smem);",
                 "single_path<WALK, WALK == WALK_CULLED>(S, center, p, ng, smem);"),),
    "at_once_l1": (("single_path<WALK, true>(S, center, p, ng, smem);",
                    "single_path<WALK, WALK == WALK_CULLED>(S, center, p, ng, smem);"),
                   ("RowsShadow<PlainRows, WordBits>{PlainRows{smem},\n"
                    "                                                     WordBits{bits}, T}",
                    "GlobalShadow{S}")),
}
K1B_PROBE_SPP = (4, 64, MAIN_SPP)


def phase_k1b_probe(device, cornell, cornell_cam):
    """Whether nvcc's contraction is what parts K1b from K1c when K1b walks
    a vertex's last shadow ray at once on a staged table. megakernel.cu is
    built as the package holds it and with each of K1B_PROBE_EDITS, each
    with nvcc's default contraction and with -fmad=false; in every build
    K1b's sums and reject counts are held against the same build's K1c at
    K1B_PROBE_SPP on Cornell (uniform and cosine, staged), and the pixels
    that differ at all are counted. If contraction alone parts them, the
    edited builds differ under the default and match under -fmad=false."""
    import shutil

    import torch

    from xraytracer_tpu_torch import _build
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.integrators import megakernel as mk
    from xraytracer_tpu_torch.scene.builder import scene_statics

    jobs = []
    for variant, edits in {"package": (), **K1B_PROBE_EDITS}.items():
        src_dir = _build.CSRC_DIR
        if edits:
            src_dir = os.path.join(_build.BUILD_DIR, f"k1b_probe_{variant}")
            shutil.rmtree(src_dir, ignore_errors=True)
            shutil.copytree(_build.CSRC_DIR, src_dir)
            path = os.path.join(src_dir, "megakernel.cu")
            with open(path) as f:
                text = f.read()
            for old, new in edits:
                check(text.count(old) == 1, f"k1b probe: {variant}: no single {old!r}")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
        src = os.path.join(src_dir, "megakernel.cu")
        jobs += [(f"k1b_probe_{variant}", src, []),
                 (f"k1b_probe_{variant}_nofma", src, ["-fmad=false"])]
    built = build_sources(jobs)
    st = scene_statics(cornell)
    cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **cornell_cam)
    package_lib = mk._lib
    try:
        for cosine in (False, True):
            fs = mk._bake(cornell, st, DEPTH, True, True, cosine, nee_mode="all")
            check(fs is not None and not fs.culls, "k1b probe: Cornell must stage")
            view = mk.try_make_fused_spp_render(
                cornell, st, cam, WIDTH, HEIGHT, 0, DEPTH, nee=True,
                cosine_sampling=cosine).view
            for tag, (path, table) in built.items():
                lib = mk._bind(ctypes.CDLL(path))
                mk._lib = lambda lib=lib: lib
                for n_spp in K1B_PROBE_SPP:
                    got_c, rej_c = mk.mega_spp_persistent(fs, view, 0, n_spp)
                    got_b, rej_b = mk.mega_spp(fs, view, 0, n_spp)
                    differ = (got_b != got_c).any(dim=-1) | (rej_b != rej_c)
                    emit("k1b_probe", build=tag[len("k1b_probe_"):],
                         case="cornell cosine" if cosine else "cornell uniform",
                         n_spp=n_spp, pixels_differing=int(differ.sum()),
                         max_abs_diff=float(torch.abs(got_b - got_c).max()),
                         first=[int(i) for i in differ.nonzero()[:4, 0]],
                         ptxas=table.get("mega_spp<staged>"))
                    del got_c, got_b
    finally:
        mk._lib = package_lib


def phase_mega_kernels(device, cornell, cornell_cam, reps):
    """Hold the three whole-path kernels against their plain versions on the
    card: Cornell at the main path's shape and at a few samples (uniform and
    cosine), a multi-tile mesh table, and the 64-light room with ``one`` and
    ``power``; the per-sample loop against the merged loop, and raster
    against morton lane order. Returns the ``kernels`` entries."""
    import numpy as np
    import torch

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.integrators import megakernel as mk
    from xraytracer_tpu_torch.scene.builder import scene_statics
    from xraytracer_tpu_torch.scene.presets import cornell_camera

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    mesh_small, mesh_cam = mesh_scene(device, K1_MESH_SIZE)
    mesh_one, _ = mesh_scene(device, K1_MESH_ONE_GROUP)
    mesh_128, _ = mesh_scene(device, K1_MESH_SMALL)
    room = many_light_scene(device)
    room_in = many_light_scene(device, face_in=True)
    scenes = [
        # label, tables, camera, options, sample counts of the spp kernels
        ("cornell uniform", cornell, cornell_cam,
         dict(max_depth=DEPTH, cosine_sampling=False), (MAIN_SPP, K1_SPP)),
        ("cornell cosine", cornell, cornell_cam,
         dict(max_depth=DEPTH, cosine_sampling=True), (K1_SPP,)),
        ("mesh %dx%d, multi-tile table" % K1_MESH_SIZE, mesh_small, mesh_cam,
         dict(max_depth=DEPTH, cosine_sampling=True), (K1_SPP,)),
        ("mesh %dx%d, one group, culled" % K1_MESH_ONE_GROUP, mesh_one, mesh_cam,
         dict(max_depth=DEPTH, cosine_sampling=True), (K1_SPP,)),
        ("mesh %dx%d, culled" % K1_MESH_SMALL, mesh_128, mesh_cam,
         dict(max_depth=DEPTH, cosine_sampling=True), (K1_SPP,)),
        ("64 lights, one", room, cornell_camera(),
         dict(max_depth=2, cosine_sampling=True, nee_mode="one"), (K1_SPP,)),
        ("64 lights, power", room, cornell_camera(),
         dict(max_depth=2, cosine_sampling=True, nee_mode="power"), (K1_SPP,)),
        ("64 lights facing in, one", room_in, cornell_camera(),
         dict(max_depth=3, cosine_sampling=True, nee_mode="one"), (K1_SPP,)),
        ("64 lights facing in, power", room_in, cornell_camera(),
         dict(max_depth=3, cosine_sampling=False, nee_mode="power"), (K1_SPP,)),
    ]
    cases = {k: [] for k in mk.KERNEL_NAMES}
    for label, tables, camk, opts, spp_list in scenes:
        st = scene_statics(tables)
        cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **camk)
        t_total = int(tables.tri_v0.shape[0])
        n_lights = st["n_area_lights"]
        fs = mk._bake(tables, st, opts["max_depth"], True, True,
                      opts["cosine_sampling"],
                      nee_mode=opts.get("nee_mode", "all"))
        check(fs is not None, f"{label}: scene not eligible for the fused route")
        render = {order: mk.try_make_fused_spp_render(
            tables, st, cam, WIDTH, HEIGHT, 0, nee=True, pixel_order=order, **opts)
            for order in ("raster", "morton")}
        view = render["raster"].view
        n = view.n
        common = dict(t_total=t_total, n_lights=n_lights, **{
            k: v for k, v in opts.items()})

        # K1a on the camera rays of sample 0; it culls a table it does not
        # stage, as the merged loop does
        culled = fs.culls
        keys, o, d = mk._camera_rays_plain(view, 0)
        stats = {}
        with MegaRayLog(opts["max_depth"], on=culled) as log:
            ref, plain_ms = timed_once(
                lambda: mk.mega_path_plain(fs, o, d, keys, stats))
        got = mk.mega_path(fs, o, d, keys)
        torch.cuda.synchronize()
        bound = mega_bound(n, t_total, n_lights, stats, 28, 12)
        if culled:
            bound = dict(bound, **mega_culled_bound(fs, log.paths, 28, 12, n),
                         brute_bound_ms=bound["bound_ms"])
        del log
        case = compare_radiance(f"mega_path, {label}", got, ref)
        case.update(case=label, n_spp=1, plain_ms=plain_ms,
                    ms=median_ms(lambda: mk.mega_path(fs, o, d, keys), reps, flush),
                    **bound, **common)
        cases["mega_path"].append(case)
        del got, ref

        for n_spp in spp_list:
            tag = f"{label}, {n_spp} spp"
            stats = {}
            with MegaRayLog(opts["max_depth"], on=culled) as log:
                (ref, ref_rej), plain_ms = timed_once(
                    lambda: mk.mega_spp_persistent_plain(fs, view, 0, n_spp, stats))
            got_c, rej_c = mk.mega_spp_persistent(fs, view, 0, n_spp)
            got_b, rej_b = mk.mega_spp(fs, view, 0, n_spp)
            torch.cuda.synchronize()
            bound = mega_bound(n, t_total, n_lights, stats, 12, 16)
            # both loops cull a table they do not stage, and walk the rays
            # the plain version traced
            if culled:
                bound = dict(bound, **mega_culled_bound(fs, log.paths, 12, 16, n),
                             brute_bound_ms=bound["bound_ms"])
            del log
            for name, got, rej in (("mega_spp_persistent", got_c, rej_c),
                                   ("mega_spp", got_b, rej_b)):
                if name == "mega_spp" and n_spp == MAIN_SPP:
                    continue  # the main path gives this shape to the merged loop only
                if name == "mega_spp":
                    (ref_b, ref_rej_b), plain_b = timed_once(
                        lambda: mk.mega_spp_plain(fs, view, 0, n_spp))
                else:
                    ref_b, ref_rej_b, plain_b = ref, ref_rej, plain_ms
                case = compare_radiance(f"{name}, {tag}", got, ref_b, rej, ref_rej_b)
                fn = getattr(mk, name)
                case.update(case=tag, n_spp=n_spp, plain_ms=plain_b,
                            ms=median_ms(lambda: fn(fs, view, 0, n_spp), reps, flush),
                            **bound, **common)
                cases[name].append(case)
            # per-sample loop vs merged loop (A/B), raster vs morton (bitwise)
            ab = torch.abs(got_b - got_c)
            check(bool((ab <= K1_AB_ATOL + K1_AB_RTOL * torch.abs(got_c)).all())
                  and bool((rej_b == rej_c).all()),
                  f"{tag}: mega_spp vs mega_spp_persistent differ by {float(ab.max())}")
            cases["mega_spp_persistent"][-1].update(
                vs_mega_spp_max_abs_diff=float(ab.max()),
                vs_mega_spp_pixels_differing=int((ab > 0).any(dim=-1).sum()))
            if n_spp == K1_SPP:
                rad_m, rej_m = render["morton"](0, n_spp)
                rad_r, rej_r = render["raster"](0, n_spp)
                back = torch.empty_like(rad_m)
                back[torch.as_tensor(render["morton"].pixel_ids.astype(np.int64),
                                     device=device)] = rad_m
                check(bool(torch.equal(back, rad_r)) and int(rej_m) == int(rej_r),
                      f"{tag}: morton lane order is not bitwise raster's image")
                cases["mega_spp_persistent"][-1].update(morton_bitwise_equal=True)
            del got_c, got_b, ref, ab

    # a resumed chunk continues the stream: (0, 3) + (3, 1) == (0, 4)
    st = scene_statics(cornell)
    cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **cornell_cam)
    rc = mk.try_make_fused_spp_render(cornell, st, cam, WIDTH, HEIGHT, 0, DEPTH)
    whole, _ = rc(0, 4)
    first, _ = rc(0, 3)
    last, _ = rc(3, 1)
    resumed_diff = float(torch.abs(first + last - whole).max())
    check(resumed_diff <= 1e-4, f"resumed chunk differs by {resumed_diff}")
    # eligibility routing on the card
    routed_none = mk.try_make_fused_spp_render(
        cornell, st, cam, WIDTH, HEIGHT, 0, 9) is None
    check(routed_none, "depth 9 must route to the wavefront integrator")

    emit("kernel_checks", kernels="whole-path", cases=cases, reps=reps,
         resumed_chunk_max_abs_diff=resumed_diff,
         tolerances=dict(pixel=[K1_RTOL, K1_ATOL],
                         pixel_share=K1_PIXEL_DIFF_SHARE,
                         loose=[K1_LOOSE_RTOL, K1_LOOSE_ATOL],
                         mean=MEAN_BAND_KERNEL_VS_PLAIN,
                         loop_ab=[K1_AB_RTOL, K1_AB_ATOL]))
    headline = {"mega_path": "cornell uniform",
                "mega_spp": f"cornell uniform, {K1_SPP} spp",
                "mega_spp_persistent": f"cornell uniform, {MAIN_SPP} spp"}
    entries = []
    for name in headline:
        head = next(c for c in cases[name] if c["case"] == headline[name])
        entries.append(dict(
            name=name, route="cuda",
            source="xraytracer_tpu_torch/csrc/megakernel.cu",
            replaces=MEGA_REPLACES[name],
            launches=None, launches_by_path=None,
            max_abs_err=max(c["max_abs_err"] for c in cases[name]),
            err_of="radiance (sum over the launch's samples) per pixel and "
                   "channel against the plain version, worst case",
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None,
            shape=f"{head['case']}: N={head['n']} T={head['t_total']} "
                  f"n_spp={head['n_spp']}",
            cases=[{k: c[k] for k in ("case", "n", "t_total", "n_spp", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "brute_bound_ms", "pixels_beyond_gate")
                    if k in c} for c in cases[name]],
        ))
    return entries


# the golden image through the whole-path kernel: its camera ray multiplies
# by a float32 1 / width where the wavefront route divides by the width, so
# a sample's ray may differ in the last bit and a pixel by a few ulps of its
# radiance (the JAX package allows its fused route ~1e-4 against the
# wavefront one for the same reason). The gate is the kernels' own pixel
# gate; how many values miss the golden's own gate is printed
GOLDEN_GATE = (1e-5, 1e-6)
GOLDEN_FUSED_GATE = (K1_RTOL, K1_ATOL)


def phase_golden(device):
    """The CPU golden image, reproduced on the card by the wavefront route
    (record sweep + any-hit sweep) and by the whole-render kernel."""
    import numpy as np

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.renderer import render
    from xraytracer_tpu_torch.scene.builder import scene_statics
    from xraytracer_tpu_torch.scene.presets import build_cornell_box, cornell_camera

    golden = np.load(os.path.join(_HERE, "tests", "golden",
                                  "cornell_gi_32x24_8spp_seed0.npy"))
    gt = build_cornell_box().build(device)
    gcam = PinholeCamera.make(32 / 24, device=device, **cornell_camera())
    out = {}
    for route, fused, (rtol, atol) in (("wavefront", "never", GOLDEN_GATE),
                                       ("fused", "auto", GOLDEN_FUSED_GATE)):
        reset_all_counts()
        gr = render(gt, gcam,
                    make_path_integrator(gt, scene_statics(gt), 3, nee=True,
                                         fused=fused),
                    32, 24, 8, seed=0)
        counts = all_counts()
        gdiff = np.abs(gr.image - golden)
        over_own = int((gdiff > GOLDEN_GATE[1] + GOLDEN_GATE[0] * np.abs(golden)).sum())
        over = int((gdiff > atol + rtol * np.abs(golden)).sum())
        out[route] = dict(
            max_abs_diff=float(gdiff.max()), values_over_gate=over,
            values_over_golden_own_gate=over_own,
            gate=f"rtol {rtol} atol {atol}", n_rejected=gr.n_rejected,
            launches={k: v["launches"] for k, v in counts.items()})
        check(over == 0 and gr.n_rejected == 0,
              f"golden, {route} route: {over} values beyond rtol {rtol} / atol {atol}")
        check(sum(v["plain_calls"] for v in counts.values()) == 0,
              f"golden, {route} route: plain-version calls on the card")
    check(out["fused"]["launches"]["mega_spp_persistent"] == 1,
          "golden: the fused route did not go through mega_spp_persistent")
    check(out["wavefront"]["launches"]["sweep_nearest_rec"] == 24,
          "golden: the wavefront route did not go through sweep_nearest_rec")
    emit("golden", values=int(golden.size),
         golden_own_gate=f"rtol {GOLDEN_GATE[0]} atol {GOLDEN_GATE[1]}", **out)


def phase_main(device, cfg, cornell, cornell_cam):
    """cornellbox_gi at full width through the entry points a user calls, by
    its default route: the whole-render kernel, one launch per spp chunk.
    Returns the run's launch counts, counted from 0 set just before the run
    and read just after it."""
    from xraytracer_tpu_torch import cli
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    statics = scene_statics(cornell)
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **cornell_cam)
    integ = cli.make_integrator(cfg, cornell, statics)
    check(getattr(integ, "fused_spec", None) is not None,
          "main_path: cornellbox_gi did not take the fused route")
    renderer = WavefrontRenderer(cornell, cam, integ, cfg.width, cfg.height,
                                 seed=cfg.seed)
    renderer.render(1)  # warm-up: the first launch loads the library
    ref_k, ref_p = reference_renders(cornell, cornell_cam, statics, REF_SPP,
                                     cfg.cosine_sampling, device, fused="auto")
    n_chunks = -(-cfg.spp // (cfg.spp_chunk or cfg.spp))
    reset_all_counts()
    result = renderer.render(cfg.spp, spp_chunk=cfg.spp_chunk or None)
    counts = all_counts()
    line = render_checks("main_path", result, cfg.spp, counts,
                         {"mega_spp_persistent": n_chunks}, ref_k, ref_p)
    line.update(preset="cornellbox_gi", route="fused (mega_spp_persistent)",
                spp_chunks=n_chunks, preset_spp=get_preset_spp(),
                spp_cut=None if cfg.spp == get_preset_spp() else
                f"cut from {get_preset_spp()} to {cfg.spp}", ref_spp=REF_SPP)
    emit("main_path", **line)
    return counts, result


def numpy_lanes(w, h, order):
    """The lane -> pixel-id map as numpy built it before the renderer made
    it on the card: row-major ids, or Z-order codes in uint32 and a stable
    argsort."""
    import numpy as np

    ids = np.arange(w * h, dtype=np.int32)
    if order == "morton":
        i = np.arange(w * h, dtype=np.int64)
        x, y = (i % w).astype(np.uint32), (i // w).astype(np.uint32)

        def spread(v):
            v = (v | (v << 8)) & np.uint32(0x00FF00FF)
            v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
            v = (v | (v << 2)) & np.uint32(0x33333333)
            v = (v | (v << 1)) & np.uint32(0x55555555)
            return v

        ids = ids[np.argsort((spread(x) << np.uint32(1)) | spread(y),
                             kind="stable").astype(np.int32)]
    return ids


FRAME_COPY_REPS = 30  # image copies timed per form


def phase_frame_path(device):
    """The renderer's assembly on the card: Cornell at 780x585 by its fused
    route at spp 3 and MAIN_SPP (raster, the preset's order) and at spp 3 in
    morton order, and the nee cloud at spp 3. Each image is bitwise the host
    assembly the renderer made before of the same sums (a numpy scatter by
    the numpy-built lane map, then ``/ spp``), the lane map on the card is
    the numpy-built one, and each render, through ``WavefrontRenderer`` and
    through the one-shot ``render``, copies one frame-sized array between
    host and card. Also counts the values where a division by a Python
    number (on the card PyTorch multiplies by its reciprocal) would part
    from numpy, and times the image's copy into a new pageable numpy array
    against one through a pinned buffer of PyTorch's caching host
    allocator."""
    import numpy as np
    import torch

    from xraytracer_tpu_torch import cli
    from xraytracer_tpu_torch import renderer as rmod
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.scene.builder import scene_statics

    cases = []
    scenes = {}
    for preset, spp, order in (("cornellbox_gi", 3, "auto"),
                               ("cornellbox_gi", MAIN_SPP, "auto"),
                               ("cornellbox_gi", 3, "morton"), ("nee", 3, "auto")):
        label = f"{preset} spp {spp} {order}"
        cfg = get_preset(preset, spp=spp)
        if preset not in scenes:
            tables, camk = cli.build_scene(cfg, device=device)
            statics = scene_statics(tables)
            cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **camk)
            scenes[preset] = (tables, cam, cli.make_integrator(cfg, tables, statics))
        tables, cam, integ = scenes[preset]
        check(getattr(integ, "fused_spec", None) is not None,
              f"frame_path: {label} did not take a fused route")
        w, h = cfg.width, cfg.height
        r = rmod.WavefrontRenderer(tables, cam, integ, w, h, seed=cfg.seed,
                                   pixel_order=order)
        check(r.run_chunk is not None and r.pixel_order in ("raster", "morton"),
              f"frame_path: {label}: no route")
        r.render(1)  # warm-up
        acc = rmod.Accumulator(w, h, device=device)
        rmod.reset_counts()
        res = r.render(spp, accumulator=acc)
        copies = rmod.counts()["frame_copies"]
        lanes = numpy_lanes(w, h, r.pixel_order)
        on_card = r.pixel_ids.cpu().numpy()
        check(np.array_equal(on_card, lanes),
              f"frame_path: {label}: the lane map on the card is not numpy's")
        check(np.array_equal(r.pixel_xy.cpu().numpy(), np.stack(
            [(lanes % w).astype(np.float32), (lanes // w).astype(np.float32)], -1)),
              f"frame_path: {label}: the pixel xy on the card are not numpy's")
        host = np.empty((w * h, 3), np.float32)
        host[lanes] = acc.acc.cpu().numpy()
        want = host.reshape(h, w, 3) / spp
        differ = int((res.image != want).sum())
        by_pixel = torch.from_numpy(host).to(device)
        recip = int(((by_pixel / float(spp)).cpu().numpy().reshape(h, w, 3) != want).sum())
        check(differ == 0, f"frame_path: {label}: {differ} values differ from "
              f"the host assembly")
        check(copies == 1, f"frame_path: {label}: {copies} frame copies")
        check(res.image.flags.owndata and res.n_rejected == 0,
              f"frame_path: {label}: image not its own or samples rejected")
        one_shot = None
        if order == "auto":
            rmod.reset_counts()
            one = rmod.render(tables, cam, integ, w, h, spp, seed=cfg.seed)
            one_shot = rmod.counts()["frame_copies"]
            check(one_shot == 1, f"frame_path: {label}: one-shot render made "
                  f"{one_shot} frame copies")
            check(np.array_equal(one.image, res.image),
                  f"frame_path: {label}: the one-shot render's image differs")
        cases.append(dict(case=label, order=r.pixel_order, width=w, height=h,
                          values_differing=differ, frame_copies=copies,
                          one_shot_frame_copies=one_shot,
                          reciprocal_divide_values_differing=recip,
                          mean_radiance=float(res.image.mean())))

    # the image's one copy, two forms, in turns, on the last 780x585 image
    img = torch.from_numpy(want).to(device)

    def pageable():
        out = np.empty(want.shape, np.float32)
        torch.from_numpy(out).copy_(img)
        return out

    def pinned():
        buf = torch.empty(want.shape, dtype=torch.float32, pin_memory=True)
        buf.copy_(img, non_blocking=True)
        torch.cuda.synchronize(device)
        return buf.numpy().copy()

    times = {"pageable": [], "pinned": []}
    for _ in range(FRAME_COPY_REPS):
        for name, fn in (("pageable", pageable), ("pinned", pinned)):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(out, want), f"frame_path: {name} copy differs")
    emit("frame_path", cases=cases, image_bytes=int(want.nbytes),
         copy_ms_median={k: float(np.median(v)) for k, v in times.items()},
         copy_ms_min={k: float(np.min(v)) for k, v in times.items()},
         copy_reps=FRAME_COPY_REPS)


def get_preset_spp():
    from xraytracer_tpu_torch.config import PRESETS

    return PRESETS["cornellbox_gi"].spp


def phase_fused_entry_points(device, cfg, cornell, cornell_cam, main_image_mean):
    """mega_path and mega_spp through their entry points at full width:
    ``try_make_fused_path_integrator`` under the per-sample renderer (one
    launch per sample), and ``try_make_fused_spp_render(persistent=False)``
    under the renderer's chunk runner (one launch per chunk). Returns the
    run's launch counts."""
    import numpy as np

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.integrators.megakernel import (
        try_make_fused_path_integrator,
    )
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    statics = scene_statics(cornell)
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **cornell_cam)
    kw = dict(nee=True, cosine_sampling=cfg.cosine_sampling, nee_mode=cfg.nee_mode)
    per_sample = try_make_fused_path_integrator(cornell, statics, cfg.max_depth, **kw)
    check(per_sample is not None, "fused_entry_points: scene not eligible")
    chunked = make_path_integrator(cornell, statics, cfg.max_depth, **kw)
    chunked.fused_spec = dict(chunked.fused_spec, persistent=False)
    merged = make_path_integrator(cornell, statics, cfg.max_depth, **kw)
    renderers = [WavefrontRenderer(cornell, cam, integ, cfg.width, cfg.height,
                                   seed=cfg.seed)
                 for integ in (per_sample, chunked, merged)]
    reset_all_counts()
    res_a = renderers[0].render(ENTRY_SPP)
    res_b = renderers[1].render(ENTRY_SPP)
    counts = all_counts()
    res_c = renderers[2].render(ENTRY_SPP)  # mega_spp_persistent, to compare
    for name, want in (("mega_path", ENTRY_SPP), ("mega_spp", 1)):
        check(counts[name]["launches"] == want,
              f"fused_entry_points: {name} launched {counts[name]['launches']}x, "
              f"expected {want}")
    check(sum(c["launches"] for c in counts.values()) == ENTRY_SPP + 1,
          "fused_entry_points: another kernel was launched")
    check(sum(c["plain_calls"] for c in counts.values()) == 0,
          "fused_entry_points: plain-version calls on the card")
    check(res_a.n_rejected == 0 and res_b.n_rejected == 0,
          "fused_entry_points: rejected samples")
    # per-sample loop and merged loop: the A/B gate; the per-sample route
    # takes the wavefront renderer's camera ray (division by the width)
    ab = np.abs(res_b.image - res_c.image)
    check(bool((ab <= K1_AB_ATOL + K1_AB_RTOL * np.abs(res_c.image)).all()),
          f"fused_entry_points: mega_spp vs mega_spp_persistent differ by {ab.max()}")
    diff = np.abs(res_a.image - res_c.image)
    n_diff = int((diff > K1_ATOL + K1_RTOL * np.abs(res_c.image)).any(axis=-1).sum())
    check(n_diff <= K1_PIXEL_DIFF_SHARE * WIDTH * HEIGHT,
          f"fused_entry_points: mega_path route differs from the whole-render "
          f"kernel on {n_diff} pixels")
    m = float(res_a.image.mean())
    check(abs(m - main_image_mean) <= MEAN_BAND_FULL_VS_REF * main_image_mean,
          f"fused_entry_points: mean {m} vs main path {main_image_mean}")
    emit("fused_entry_points", spp=ENTRY_SPP,
         mega_path=dict(seconds=res_a.seconds,
                        msamples_per_s=res_a.samples_per_sec / 1e6,
                        launches=counts["mega_path"]["launches"]),
         mega_spp=dict(seconds=res_b.seconds,
                       msamples_per_s=res_b.samples_per_sec / 1e6,
                       launches=counts["mega_spp"]["launches"]),
         mega_spp_vs_persistent_max_abs_diff=float(ab.max()),
         mega_spp_vs_persistent_pixels_differing=int((ab > 0).any(axis=-1).sum()),
         mega_path_vs_persistent_pixels_beyond_gate=n_diff,
         mega_path_vs_persistent_max_abs_diff=float(diff.max()),
         mean_radiance=m)
    return counts


def phase_wavefront(device, cfg, cornell, cornell_cam, main_image_mean):
    """cornellbox_gi by its wavefront route (``fused="never"``: record sweep
    + any-hit sweep per bounce), then by the ``tri_fn`` route of the same
    path. Returns the launch counts of each run, ``{"wavefront_path": ...,
    "tri_fn_path": ...}``."""
    import numpy as np

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.geometry import kernels
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    statics = scene_statics(cornell)
    n_lights = statics["n_area_lights"]
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **cornell_cam)
    integ = make_path_integrator(
        cornell, statics, cfg.max_depth, nee=True,
        cosine_sampling=cfg.cosine_sampling, nee_mode=cfg.nee_mode, fused="never")
    renderer = WavefrontRenderer(cornell, cam, integ, cfg.width, cfg.height,
                                 seed=cfg.seed)
    renderer.render(1)  # warm-up
    ref_k, ref_p = reference_renders(cornell, cornell_cam, statics, WAVEFRONT_SPP,
                                     cfg.cosine_sampling, device)
    reset_all_counts()
    result = renderer.render(WAVEFRONT_SPP)
    counts_wave = all_counts()
    line = render_checks(
        "wavefront_path", result, WAVEFRONT_SPP, counts_wave,
        {"sweep_nearest_rec": WAVEFRONT_SPP * DEPTH,
         "occluded_anyhit": WAVEFRONT_SPP * DEPTH * n_lights,
         "chunk_boxes": chunk_builds(cornell, 2)}, ref_k, ref_p)
    m_wave = float(result.image.mean())
    check(abs(m_wave - main_image_mean) <= MEAN_BAND_FULL_VS_REF * main_image_mean,
          f"wavefront_path: mean {m_wave} vs main path {main_image_mean}")
    # the tri_fn route of the same path, with per-bounce counters: both
    # sweeps go through sweep_nearest, none through the other two kernels
    integ_s = make_path_integrator(
        cornell, statics, cfg.max_depth, nee=True, with_stats=True,
        tri_fn=kernels.sweep_nearest_tri_fn,
    )
    renderer_s = WavefrontRenderer(cornell, cam, integ_s, cfg.width, cfg.height,
                                   seed=cfg.seed)
    reset_all_counts()
    res_s = renderer_s.render(STATS_SPP)
    counts_tri = all_counts()
    check(res_s.n_rejected == 0, "tri_fn_path: rejected samples")
    check(bool(np.isfinite(res_s.image).all()), "tri_fn_path: non-finite pixels")
    expected_tri = {"sweep_nearest": STATS_SPP * DEPTH * (1 + n_lights),
                    "chunk_boxes": chunk_builds(cornell, 2)}
    for name, c in counts_tri.items():
        want = expected_tri.get(name, 0)
        check(c["launches"] == want,
              f"tri_fn_path: {name} launched {c['launches']}x, expected {want}")
    check(sum(c["plain_calls"] for c in counts_tri.values()) == 0,
          "tri_fn_path: plain-version calls on the card")
    m_tri = float(res_s.image.mean())
    check(abs(m_tri - m_wave) <= MEAN_BAND_FULL_VS_REF * m_wave,
          f"tri_fn_path: mean {m_tri} vs wavefront path {m_wave}")
    line.update(
        preset="cornellbox_gi", route='wavefront (fused="never")',
        stats_run=dict(
            spp=STATS_SPP, tri_fn="sweep_nearest", seconds=res_s.seconds,
            total_rays=res_s.total_rays,
            mrays_per_s=res_s.total_rays / res_s.seconds / 1e6,
            rays=res_s.stats["rays"].tolist(),
            shadow_rays=res_s.stats["shadow_rays"].tolist(),
            mean_radiance=m_tri,
            launches={k: v["launches"] for k, v in counts_tri.items()},
        ),
    )
    emit("wavefront_path", **line)
    return {"wavefront_path": counts_wave, "tri_fn_path": counts_tri}


def emit_profile(prof, top, **fields):
    """One ``profile`` line from a finished ``torch.profiler`` trace: device
    kernels by self device time and the host operators by self CPU time."""
    rows, host = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us and getattr(e, "device_type", None) is not None and \
                "cuda" in str(e.device_type).lower():
            rows.append((e.key, float(dev_us), int(e.count)))
        elif e.self_cpu_time_total:
            host.append((e.key, float(e.self_cpu_time_total), int(e.count)))
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    emit("profile", **fields, device_kernels=sum(r[2] for r in rows),
         top=[dict(kernel=k[:90], ms=us / 1e3, launches=c) for k, us, c in rows[:top]],
         top_host=[dict(op=k[:90], ms=us / 1e3, calls=c) for k, us, c in host[:top]])


def phase_profile(device, cfg, cornell, cornell_cam, top=12):
    """Trace the main path (the whole preset, one launch per chunk) and 2
    samples of the wavefront route: the kernels that take most of the device
    time."""
    from torch.profiler import ProfilerActivity, profile

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    statics = scene_statics(cornell)
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **cornell_cam)
    for route, fused, n_spp in (("fused", "auto", cfg.spp), ("wavefront", "never", 2)):
        integ = make_path_integrator(
            cornell, statics, cfg.max_depth, nee=True,
            cosine_sampling=cfg.cosine_sampling, nee_mode=cfg.nee_mode, fused=fused)
        renderer = WavefrontRenderer(cornell, cam, integ, cfg.width, cfg.height,
                                     seed=cfg.seed)
        renderer.render(1)
        plain = renderer.render(n_spp).seconds
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = renderer.render(n_spp).seconds
        emit_profile(prof, top, route=route, spp=n_spp, seconds_untraced=plain,
                     seconds_traced=traced)


def phase_mesh(device, mesh, mesh_cam):
    """The 13k-triangle mesh GI scene at full width. Returns the run's
    launch counts."""
    import numpy as np

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    statics = scene_statics(mesh)
    cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **mesh_cam)
    # the default route: 13,184 rows are over the whole-path kernels' gate,
    # so the factory routes this scene to the wavefront integrator, which
    # sorts the bounce rays (sort_rays="auto": over 4096 real rows)
    integ = make_path_integrator(mesh, statics, DEPTH, nee=True,
                                 cosine_sampling=True)
    check(getattr(integ, "fused_spec", None) is None,
          "mesh_path: a table over the row gate took the fused route")
    check(integ.sort_rays, "mesh_path: the default route did not sort")
    renderer = WavefrontRenderer(mesh, cam, integ, WIDTH, HEIGHT, seed=0)
    renderer.render(1)  # warm-up
    unsorted = WavefrontRenderer(mesh, cam, make_path_integrator(
        mesh, statics, DEPTH, nee=True, cosine_sampling=True, sort_rays=False),
        WIDTH, HEIGHT, seed=0)
    unsorted.render(1)  # warm-up
    ref_k, ref_p = reference_renders(mesh, mesh_cam, statics, MESH_SPP, True,
                                     device)
    reset_all_counts()
    result = renderer.render(MESH_SPP)
    counts = all_counts()
    # the same render unsorted: bitwise the same image; both timed in turns
    # (sorted, unsorted, unsorted, sorted, ...) after the counted run
    ms_per_spp = {"sorted": [1e3 * result.seconds / MESH_SPP], "unsorted": []}
    for turn in range(MESH_SORT_TURNS):
        for which in (("unsorted", "sorted") if turn % 2 == 0 else
                      ("sorted", "unsorted")):
            r = (unsorted if which == "unsorted" else renderer).render(MESH_SPP)
            ms_per_spp[which].append(1e3 * r.seconds / MESH_SPP)
            check(np.array_equal(r.image, result.image),
                  f"mesh_path: the {which} image differs from the sorted one")
    line = render_checks(
        "mesh_path", result, MESH_SPP, counts,
        {"sweep_nearest_rec": MESH_SPP * DEPTH,
         "occluded_anyhit": MESH_SPP * DEPTH * statics["n_area_lights"],
         "chunk_boxes": chunk_builds(mesh, 2)},
        ref_k, ref_p)
    line.update(scene="lat-long sphere mesh %dx%d + floor + quad light" % MESH_SIZE,
                triangles=int((mesh.tri_obj >= 0).sum()),
                table_rows=int(mesh.tri_v0.shape[0]), cosine_sampling=True,
                pixel_order=renderer.pixel_order,
                route="wavefront (table over the fused route's row gate), "
                      "bounce rays sorted",
                sorted_vs_unsorted_bitwise=True, ms_per_spp=ms_per_spp)
    emit("mesh_path", **line)
    return counts


# --------------------------------------------------------------------------
# the delta-light slice: the furnace, direct and Whitted integrators, the
# example preset and the OBJ / native IO tier, on the sweep kernels
# --------------------------------------------------------------------------
SURFACE_SPP = 16        # the example / whitted / cornellbox presets' own spp
SURFACE_REF_SPP = 4     # their 128x96 renders, kernels against plain
MIRROR_GLASS_DEPTH = 4  # tests/test_integrators.py's Whitted depth there


def surface_integrator(name, tables, statics, depth, tri_fn=None):
    """The CLI's normal / furnace / direct / Whitted integrators with an
    explicit triangle sweep (``tri_fn`` = the plain matmul form: no kernel)."""
    from xraytracer_tpu_torch.integrators import (
        make_direct_integrator,
        make_furnace_integrator,
        make_normal_integrator,
        make_whitted_integrator,
    )

    if name == "normal":
        return make_normal_integrator(tables, tri_fn=tri_fn)
    if name == "furnace":
        return make_furnace_integrator(tables, tri_fn=tri_fn)
    if name == "direct":
        return make_direct_integrator(tables, statics, tri_fn=tri_fn)
    check(name == "whitted", f"no surface integrator {name!r}")
    return make_whitted_integrator(tables, statics, depth, tri_fn=tri_fn)


def surface_references(tables, camk, statics, name, depth, device):
    """The same scene at the reference size, 4 spp: through the kernels and
    through the plain path (the matmul-form sweep, which launches nothing)."""
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.geometry.intersect import intersect_triangles_mm
    from xraytracer_tpu_torch.renderer import render

    cam = PinholeCamera.make(REF_W / REF_H, device=device, **camk)
    return [render(tables, cam, surface_integrator(name, tables, statics, depth, tri_fn),
                   REF_W, REF_H, SURFACE_REF_SPP, seed=0)
            for tri_fn in (None, intersect_triangles_mm)]


def surface_expected(integrator, statics, spp, depth, tables_swept):
    """Launches of a counted wavefront render with one of those integrators:
    a record sweep per hit, an any-hit sweep per shadow ray, one chunk table
    per (table, mask) swept."""
    hits, shadows = 1, 0
    if integrator == "whitted":
        hits, shadows = depth + 1, (depth + 1) * statics["n_delta_lights"]
    elif integrator == "direct":
        shadows = statics["n_area_lights"]
    out = {"sweep_nearest_rec": spp * hits,
           "chunk_boxes": sum(chunk_builds(t, 2 if shadows else 1) for t in tables_swept)}
    if shadows:
        out["occluded_anyhit"] = spp * shadows
    return out


def phase_surface_path(label, device, cfg):
    """One preset and integrator at full width through the CLI's entry points
    (``cli.build_scene``, ``cli.make_integrator``) and the renderer, by the
    wavefront route. Returns the run's launch counts and its result."""
    from xraytracer_tpu_torch import cli
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    tables, camk = cli.build_scene(cfg, device=device)
    statics = scene_statics(tables)
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **camk)
    integ = cli.make_integrator(cfg, tables, statics)
    renderer = WavefrontRenderer(tables, cam, integ, cfg.width, cfg.height,
                                 seed=cfg.seed)
    renderer.render(1)  # warm-up
    ref_k, ref_p = surface_references(tables, camk, statics, cfg.integrator,
                                      cfg.max_depth, device)
    reset_all_counts()
    result = renderer.render(cfg.spp)
    counts = all_counts()
    line = render_checks(label, result, cfg.spp, counts, surface_expected(
        cfg.integrator, statics, cfg.spp, cfg.max_depth, [tables]), ref_k, ref_p)
    line.update(preset=cfg.preset, integrator=cfg.integrator, depth=cfg.max_depth,
                ref_spp=SURFACE_REF_SPP, n_delta_lights=statics["n_delta_lights"],
                n_area_lights=statics["n_area_lights"],
                route="wavefront (record sweep per hit, any-hit sweep per shadow ray)")
    emit(label, **line)
    return counts, result


def mirror_glass_scene(device):
    """Floor, mirror sphere and glass sphere under a point light: the Whitted
    scene of tests/test_integrators.py, whose bounce rays leave the spheres
    (origins 0.001 ng off the surface, on the far side after a refraction)."""
    import numpy as np

    from xraytracer_tpu_torch.math import from_rows
    from xraytracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    floor = np.asarray([[[-10, 0, -10], [10, 0, -10], [-10, 0, 10]],
                        [[10, 0, -10], [10, 0, 10], [-10, 0, 10]]], np.float32)
    b.add_mesh(floor, material=b.add_lambert((0.8, 0.2, 0.2)))
    b.add_sphere((-1.5, 1.0, 0.0), 1.0, material=b.add_mirror())
    b.add_sphere((1.5, 1.0, 0.0), 1.0, material=b.add_glass())
    b.add_point_light((0.0, 8.0, 4.0), (1, 1, 1), 200.0)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 1.5, 8.0, 1)
    return b.build(device), dict(c2w=c2w, fov_deg=45.0)


def pane_scene(device):
    """A Lambert floor, a mirror wall and a glass pane (six triangles) under a
    point and a distant light: the Whitted scene of tests/test_oracle.py, by
    the port's builder. Its distant light's shadow rays (t_max = INF) meet
    blockers, and its bounce rays leave mirror and glass triangles."""
    import numpy as np

    from xraytracer_tpu_torch.math import from_rows
    from xraytracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    lam = b.add_lambert((0.7, 0.6, 0.5))
    mir = b.add_mirror((0.8, 0.8, 0.8))
    gls = b.add_glass(1.3, (0.9, 0.9, 0.9))

    def quad(p00, p10, p01):
        p00, p10, p01 = map(np.asarray, (p00, p10, p01))
        p11 = p10 + (p01 - p00)
        return np.asarray([[p00, p10, p11], [p00, p11, p01]], np.float32)

    b.add_mesh(quad((-4, 0, 2), (4, 0, 2), (-4, 0, -6)), material=lam)
    b.add_mesh(quad((-3, 0, -4), (3, 0, -4), (-3, 4, -4)), material=mir)
    b.add_mesh(quad((-1.2, 0.2, -1), (1.2, 0.2, -1), (-1.2, 2.6, -1)), material=gls)
    b.add_point_light((0.0, 3.5, 1.0), color=(1.0, 0.9, 0.8), intensity=40.0)
    b.add_distant_light((0.2, -1.0, -0.4), color=(0.9, 1.0, 1.0), intensity=0.6)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 1.2, 3.0, 1)
    return b.build(device), dict(c2w=c2w, fov_deg=55.0)


def leaving_rays(nearest, depths, what):
    """The rays of the given bounces whose origin or direction changed since
    the bounce before: the lanes a mirror or glass surface sent on."""
    out = {}
    for k in depths:
        (o0, d0), (o1, d1) = nearest[k - 1], nearest[k]
        moved = (o1 != o0).any(dim=1) | (d1 != d0).any(dim=1)
        check(int(moved.sum()) > 0, f"{what}: no ray left a surface at depth {k}")
        out[f"{what} depth-{k} rays leaving mirror / glass"] = (
            o1[moved].contiguous(), d1[moved].contiguous())
    return out


def phase_delta_kernels(device, reps):
    """K4 and K3 on inputs no earlier path gives them, captured from one
    sample at full width under the Whitted integrator: shadow rays toward a
    distant light (t_max = INF, FLT_MAX) and toward a point light, from the
    whitted preset (whose one-chunk triangle table, the ground plane, blocks
    none of them) and from ``pane_scene`` (whose mirror wall and glass pane
    block many); and the rays that leave mirror and glass surfaces: the
    spheres of ``mirror_glass_scene`` (swept against its floor) and the
    panes of ``pane_scene`` (swept against the panes they leave). Returns
    {kernel: [cases]}."""
    import torch

    from xraytracer_tpu_torch import cli
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    inf = torch.finfo(torch.float32).max
    cfg = get_preset("whitted")
    whitted = cli.build_scene(cfg, device=device)
    cases = {}
    for label, (tables, camk), depth in (
            ("whitted", whitted, cfg.max_depth),
            ("mirror/glass", mirror_glass_scene(device), MIRROR_GLASS_DEPTH),
            ("pane", pane_scene(device), cfg.max_depth)):
        st = scene_statics(tables)
        cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **camk)
        got = capture_sweep_inputs(WavefrontRenderer(
            tables, cam, surface_integrator("whitted", tables, st, depth),
            WIDTH, HEIGHT, seed=0))
        n_dl = st["n_delta_lights"]
        check(len(got["nearest"]) == depth + 1 and
              len(got["shadow"]) == n_dl * (depth + 1), f"{label}: sweeps of one sample")
        sets = dict(nearest={}, shadow={})
        if label != "whitted":
            sets["nearest"] = leaving_rays(got["nearest"], (1, 2), label)
        if n_dl == 2:  # depth 0's two shadow sweeps, one per delta light
            kinds = {}
            for o, d, tm in got["shadow"][:2]:
                far = bool((tm == inf).all())
                check(far or bool((tm < inf).all()),
                      f"{label}: a shadow sweep mixes INF and finite t_max")
                kinds["distant-light shadow rays (t_max = INF)" if far
                      else "point-light shadow rays"] = (o, d, tm)
            check(len(kinds) == 2, f"{label}: one distant and one point light expected")
            sets["shadow"] = {f"{label} {k}": v for k, v in kinds.items()}
        for name, v in kernel_cases(tables, sets, flush, reps).items():
            cases.setdefault(name, []).extend(v)
    emit("kernel_checks", kernels="sweeps on the delta-light and mirror/glass rays",
         cases=cases, reps=reps)
    return cases


def merge_cases(entries, cases):
    """Add the cases of ``phase_delta_kernels`` to the sweeps' entries of the
    ``kernels`` line, their worst error into ``max_abs_err``."""
    for e in entries:
        new = cases.get(e["name"], [])
        if not new:
            continue
        if e["name"] == "occluded_anyhit":
            err = max(c["mismatch_share"] for c in new)
        else:
            err = max(c["t_max_abs_err"] for c in new)
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["cases"] += [{k: c[k] for k in ("case", "n", "t_total", "ms", "plain_ms",
                                           "bound_ms", "bound_by", "brute_bound_ms")}
                       for c in new]


def mesh_log():
    """A port SceneBuilder that also keeps every mesh it is given, in order,
    with its material's albedo (``.meshes``): what ``write_obj`` writes."""
    from xraytracer_tpu_torch.scene.builder import SceneBuilder

    class MeshLog(SceneBuilder):
        def __init__(self):
            super().__init__()
            self.meshes = []

        def add_mesh(self, vertices, normals=None, uvs=None, material=-1, light=-1):
            self.meshes.append(dict(
                name=f"mesh{len(self.meshes)}", vertices=vertices, normals=normals,
                kd=None if material < 0 else self._materials[material][1]))
            return super().add_mesh(vertices, normals, uvs, material, light)

    return MeshLog()


def write_obj(path, meshes):
    """Write triangle meshes as an OBJ file and an MTL library beside it,
    in the subset the port's ``objloader.parse_obj`` / ``load_obj_into``
    read back: one ``o``
    shape per mesh, in order, its corners unshared; per-corner normals when
    the mesh has them; one Lambert material per mesh that has a ``kd``.
    Every float is written as ``%.9g``, so float32 values read back exactly.

    ``meshes``: dicts with ``name``, ``vertices`` (T,3,3) and optional
    ``normals`` (T,3,3) and ``kd`` (3,)."""
    import numpy as np

    stem = os.path.splitext(os.path.basename(path))[0]
    mtl = stem + ".mtl"

    def row(tag, values):
        return tag + " " + " ".join("%.9g" % float(x) for x in values) + "\n"

    with open(os.path.join(os.path.dirname(path), mtl), "w") as f:
        for m in meshes:
            if m.get("kd") is not None:
                f.write(f"newmtl {m['name']}_mat\n" + row("Kd", m["kd"]))
    n_v = n_vn = 0
    with open(path, "w") as f:
        f.write(f"mtllib {mtl}\n")
        for m in meshes:
            verts = np.asarray(m["vertices"], np.float32).reshape(-1, 3)
            norms = m.get("normals")
            f.write(f"o {m['name']}\n")
            if m.get("kd") is not None:
                f.write(f"usemtl {m['name']}_mat\n")
            f.writelines(row("v", v) for v in verts)
            if norms is not None:
                norms = np.asarray(norms, np.float32).reshape(-1, 3)
                f.writelines(row("vn", n) for n in norms)
            for t in range(len(verts) // 3):
                ids = [3 * t + k + 1 for k in range(3)]
                if norms is not None:
                    f.write("f " + " ".join(
                        f"{n_v + i}//{n_vn + i}" for i in ids) + "\n")
                else:
                    f.write("f " + " ".join(str(n_v + i) for i in ids) + "\n")
            n_v += len(verts)
            n_vn += 0 if norms is None else len(norms)


def decode_png(data):
    """RGB8 PNG bytes (filter 0 rows, as both writers make them) -> (H, W, 3)."""
    import struct
    import zlib

    import numpy as np

    check(data[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    off, idat, shape = 8, b"", None
    while off < len(data):
        (ln,) = struct.unpack(">I", data[off:off + 4])
        tag = data[off + 4:off + 8]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", data[off + 8:off + 16])
            shape = (h, w)
        elif tag == b"IDAT":
            idat += data[off + 8:off + 8 + ln]
        off += 12 + ln
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(shape[0], -1)
    check(bool((rows[:, 0] == 0).all()), "PNG rows: filter 0 expected")
    return rows[:, 1:].reshape(shape[0], shape[1], 3)


def phase_obj_path(device):
    """The Cornell box and the 13k mesh scene written as .obj + .mtl, loaded
    back through ``--obj`` (``cli.build_scene``: the native IO tier's parser,
    the builder) and rendered with the normal integrator at full width: the
    triangle rows and normals bitwise the directly built tables', each image
    bitwise the directly built scene's image; then the Cornell image written
    as PNG and P6 PPM by ``film.write_image`` and decoded back. Returns the
    launch counts of the two OBJ renders."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from xraytracer_tpu_torch import cli, film, native
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics
    from xraytracer_tpu_torch.scene.presets import build_cornell_box, cornell_camera

    # the card's host builds native/xrt_native.cpp (g++ with zlib.h), so the
    # native tier is required: no fallback to the Python parser and writers
    t0 = time.perf_counter()
    check(native.get_lib() is not None,
          "obj_path: the native IO tier did not build (g++ with zlib.h)")
    build_s = time.perf_counter() - t0
    cornell_log = build_cornell_box(mesh_log())
    mesh_builder = mesh_log()
    scenes = {"cornell": (cornell_log, cornell_log.build(device), cornell_camera()),
              "mesh13k": (mesh_builder, *mesh_scene(device, builder=mesh_builder))}
    tmp = tempfile.mkdtemp(prefix="xrt_obj_")
    try:
        loaded, renderers, direct_images, parse_s = {}, {}, {}, {}
        for label, (log, direct, camk) in scenes.items():
            path = os.path.join(tmp, f"{label}.obj")
            write_obj(path, log.meshes)
            cfg = get_preset("cornellbox", integrator="normal", obj=path,
                             width=WIDTH, height=HEIGHT, spp=SURFACE_SPP)
            t1 = time.perf_counter()
            tables, obj_camk = cli.build_scene(cfg, device=device)
            parse_s[label] = time.perf_counter() - t1
            check(np.array_equal(obj_camk["c2w"], cornell_camera()["c2w"]),
                  "obj_path: --obj takes the Cornell camera")
            for k in ("tri_v0", "tri_e1", "tri_e2"):
                check(torch.equal(getattr(tables, k), getattr(direct, k)),
                      f"obj_path {label}: {k} differs from the directly built table")
            # the rows' shading normals (the first 9 record columns)
            check(torch.equal(tables.tri_rec[:, :9], direct.tri_rec[:, :9]),
                  f"obj_path {label}: normals differ from the directly built table")
            cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **camk)
            direct_r, obj_r = (
                WavefrontRenderer(t, cam, cli.make_integrator(cfg, t, scene_statics(t)),
                                  WIDTH, HEIGHT, seed=0) for t in (direct, tables))
            direct_images[label] = direct_r.render(SURFACE_SPP).image
            obj_r.render(1)  # warm-up
            renderers[label] = obj_r
            loaded[label] = (tables, camk, cfg)
        tables, camk, cfg = loaded["cornell"]
        ref_k, ref_p = surface_references(tables, camk, scene_statics(tables),
                                          "normal", cfg.max_depth, device)
        reset_all_counts()
        results = {label: r.render(SURFACE_SPP) for label, r in renderers.items()}
        counts = all_counts()
        for label, res in results.items():
            check(np.array_equal(res.image, direct_images[label]),
                  f"obj_path {label}: the image differs from the directly built scene's")
            check(bool(np.isfinite(res.image).all()) and res.n_rejected == 0,
                  f"obj_path {label}: non-finite pixels or rejected samples")
        line = render_checks("obj_path", results["cornell"], SURFACE_SPP, counts,
                             surface_expected("normal", None, len(results) * SURFACE_SPP, 0,
                                              [loaded[k][0] for k in loaded]),
                             ref_k, ref_p)
        # the image files, by the native writers, decoded back
        png, ppm = os.path.join(tmp, "cornell.png"), os.path.join(tmp, "cornell.ppm")
        u8 = film.write_image(png, results["cornell"].image, gamma=cfg.gamma)
        check(np.array_equal(decode_png(open(png, "rb").read()), u8),
              "obj_path: the PNG does not decode to the image's bytes")
        film.write_image(ppm, results["cornell"].image, gamma=cfg.gamma)
        data = open(ppm, "rb").read()
        head = f"P6\n{WIDTH} {HEIGHT}\n255\n".encode()
        check(data.startswith(head) and data[len(head):] == u8.tobytes(),
              "obj_path: the P6 PPM does not hold the image's bytes")
        line.update(
            io_tier="native", native_build_s=build_s, parse_s=parse_s,
            mesh13k_msamples_per_s=results["mesh13k"].samples_per_sec / 1e6,
            triangles={k: int((v[0].tri_obj >= 0).sum()) for k, v in loaded.items()},
            images_bitwise_direct=True, png_bytes=len(open(png, "rb").read()),
            ppm_bytes=len(data), integrator="normal", depth=cfg.max_depth,
            route="wavefront (record sweep per hit)")
        emit("obj_path", **line)
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# the volume slice: whole-path homogeneous kernels, tracking kernels, paths
# --------------------------------------------------------------------------
VOL_REPLACES = {
    "vol_path": "xraytracer_tpu/integrators/vol_megakernel.py:550",
    "vol_spp": "xraytracer_tpu/integrators/megakernel.py:1468",
    "vol_spp_persistent": "xraytracer_tpu/integrators/megakernel.py:1519",
}
TRACK_REPLACES = {
    "track_sample": "xraytracer_tpu/media_pallas.py:802",
    "track_transmittance": "xraytracer_tpu/media_pallas.py:1199",
}


def vol_bound(n, n_tris, nee, stats, bytes_in, bytes_out):
    """bound_ms of a whole-path volume launch from the plain version's
    per-iteration counters on the same inputs (see the docstring)."""
    rays = int(stats["rays"].sum())
    medium = int(stats["active_out"].sum())
    scattered = int(stats["scattered"].sum())
    hit_test = n_tris * FLOPS_VOL_TRI_TEST + FLOPS_VOL_BOX
    ops = rays * (hit_test + FLOPS_VOL_RR) + medium * FLOPS_VOL_MEDIUM
    if nee:
        ops += scattered * (FLOPS_VOL_LIGHT + hit_test + FLOPS_VOL_NEE_REST)
    by_bytes = n * (bytes_in + bytes_out) / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                rays=rays, medium_samples=medium, scattered=scattered)


def phase_vol_kernels(device, reps):
    """Hold the three whole-path volume kernels against their plain versions
    on the card: the vpt scene at the preset's 512x512 and depth 10, plain and
    with next-event estimation, all three medium variants; the per-sample
    loop against the merged loop, raster against morton lane order, and a
    resumed chunk. Returns the ``kernels`` entries."""
    import numpy as np
    import torch

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.integrators import megakernel as mk
    from xraytracer_tpu_torch.integrators import vol_megakernel as vm
    from xraytracer_tpu_torch.scene import presets
    from xraytracer_tpu_torch.scene.builder import scene_statics

    cfg = get_preset("vpt")
    w, h, depth = cfg.width, cfg.height, cfg.max_depth
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    camk = presets.preset_vpt(device=device)[1]
    cam = PinholeCamera.make(w / h, device=device, **camk)
    cases = {k: [] for k in vm.KERNEL_NAMES}
    scenes = [("mis", False, (cfg.spp, VOL_CHECK_SPP)), ("mis", True, (VOL_CHECK_SPP,)),
              ("achromatic", True, (VOL_CHECK_SPP,)), ("nomis", True, (VOL_CHECK_SPP,)),
              ("nomis", False, (VOL_CHECK_SPP,))]
    for variant, nee, spp_list in scenes:
        label = f"vpt {variant}" + (" nee" if nee else "")
        tables = presets.build_vpt_scene(variant).build(device)
        st = scene_statics(tables)
        vc = vm._vol_consts(tables, st, depth, nee, None, None)
        check(vc is not None, f"{label}: scene not eligible for the fused volume route")
        n_tris = int(vc.ic[0])
        render = {order: vm.try_make_fused_volume_spp_render(
            tables, st, cam, w, h, 0, depth, nee=nee, pixel_order=order)
            for order in ("raster", "morton")}
        view = render["raster"].view
        n = view.n
        # the work order, made once per view as the render makes it, and
        # its own time: what a render's first call pays on top of its launch
        order = vm.work_order(vc, view)
        order_ms = median_ms(lambda: vm.work_order(vc, view), reps, flush)
        common = dict(t_total=n_tris, n_lights=int(vc.ic[1]), variant=variant,
                      nee=nee, max_depth=depth, n_iterations=vc.n_iterations)

        keys, o, d = mk._camera_rays_plain(view, 0)
        stats = {}
        ref, plain_ms = timed_once(lambda: vm.vol_path_plain(vc, o, d, keys, stats))
        got = vm.vol_path(vc, o, d, keys)
        torch.cuda.synchronize()
        case = compare_radiance(f"vol_path, {label}", got, ref)
        case.update(case=label, n_spp=1, plain_ms=plain_ms,
                    ms=median_ms(lambda: vm.vol_path(vc, o, d, keys), reps, flush),
                    # in: the ray (24 B) and its u32 key (4 B); out: 12 B
                    **vol_bound(n, n_tris, nee, stats, 28, 12), **common)
        cases["vol_path"].append(case)
        del got, ref

        for n_spp in spp_list:
            tag = f"{label}, {n_spp} spp"
            stats = {}
            batch = min(n_spp, VOL_PLAIN_BATCH)
            (ref, ref_rej), plain_ms = timed_once(
                lambda: vm.vol_spp_persistent_plain(vc, view, 0, n_spp, stats, batch))
            got_c, rej_c = vm.vol_spp_persistent(vc, view, 0, n_spp, order)
            got_b, rej_b = vm.vol_spp(vc, view, 0, n_spp, order)
            torch.cuda.synchronize()
            bound = vol_bound(n, n_tris, nee, stats, 12, 16)
            for name, got, rej in (("vol_spp_persistent", got_c, rej_c),
                                   ("vol_spp", got_b, rej_b)):
                case = compare_radiance(f"{name}, {tag}", got, ref, rej, ref_rej)
                fn = getattr(vm, name)
                case.update(case=tag, n_spp=n_spp, plain_ms=plain_ms, plain_batch=batch,
                            ms=median_ms(lambda: fn(vc, view, 0, n_spp, order), reps, flush),
                            work_order_ms=order_ms, **bound, **common)
                cases[name].append(case)
            ab = torch.abs(got_b - got_c)
            check(bool((ab <= K1_AB_ATOL + K1_AB_RTOL * torch.abs(got_c)).all())
                  and bool((rej_b == rej_c).all()),
                  f"{tag}: vol_spp vs vol_spp_persistent differ by {float(ab.max())}")
            cases["vol_spp_persistent"][-1].update(
                vs_vol_spp_max_abs_diff=float(ab.max()),
                vs_vol_spp_pixels_differing=int((ab > 0).any(dim=-1).sum()))
            if n_spp == VOL_CHECK_SPP:
                rad_m, rej_m = render["morton"](0, n_spp)
                rad_r, rej_r = render["raster"](0, n_spp)
                back = torch.empty_like(rad_m)
                back[torch.as_tensor(render["morton"].pixel_ids.astype(np.int64),
                                     device=device)] = rad_m
                check(bool(torch.equal(back, rad_r)) and int(rej_m) == int(rej_r),
                      f"{tag}: morton lane order is not bitwise raster's image")
                cases["vol_spp_persistent"][-1].update(morton_bitwise_equal=True)
            del got_c, got_b, ref, ab

    # the work order on a frame whose width is not a multiple of 32: a
    # permutation of the lanes, longest chord first; both spp kernels
    # against the plain version there
    tables = presets.build_vpt_scene().build(device)
    st = scene_statics(tables)
    ow, oh = ODD_FRAME
    vc = vm._vol_consts(tables, st, depth, True, None, None)
    view = vm.try_make_fused_volume_spp_render(
        tables, st, PinholeCamera.make(ow / oh, device=device, **camk), ow, oh, 0, depth,
        nee=True).view
    order = vm.work_order(vc, view).to(torch.int64)
    cost = vm.reach_cost(vc, view)
    check(bool(torch.equal(torch.sort(order).values,
                           torch.arange(view.n, device=device)))
          and bool((cost[order[1:]] <= cost[order[:-1]]).all()),
          f"the work order of a {ow}x{oh} frame is not a permutation by cost")
    ref, ref_rej = vm.vol_spp_plain(vc, view, 0, VOL_CHECK_SPP)
    odd_frame = {}
    for name in ("vol_spp", "vol_spp_persistent"):
        got, rej = getattr(vm, name)(vc, view, 0, VOL_CHECK_SPP)
        torch.cuda.synchronize()
        odd_frame[name] = compare_radiance(
            f"{name}, vpt mis nee {ow}x{oh}, {VOL_CHECK_SPP} spp", got, ref, rej, ref_rej)
    rc = vm.try_make_fused_volume_spp_render(tables, st, cam, w, h, 0, depth)
    # a resumed chunk continues the stream: (0, 3) + (3, 1) == (0, 4)
    whole, _ = rc(0, 4)
    first, _ = rc(0, 3)
    last, _ = rc(3, 1)
    resumed_diff = float(torch.abs(first + last - whole).max())
    check(resumed_diff <= 1e-4, f"volume: resumed chunk differs by {resumed_diff}")
    check(vm.try_make_fused_volume_spp_render(tables, st, cam, w, h, 0, 65) is None,
          "depth 65 must route to the wavefront volume integrator")

    emit("kernel_checks", kernels="volume whole-path", cases=cases, reps=reps,
         resumed_chunk_max_abs_diff=resumed_diff, odd_frame=odd_frame,
         tolerances=dict(pixel=[K1_RTOL, K1_ATOL], pixel_share=K1_PIXEL_DIFF_SHARE,
                         loose=[K1_LOOSE_RTOL, K1_LOOSE_ATOL],
                         mean=MEAN_BAND_KERNEL_VS_PLAIN,
                         loop_ab=[K1_AB_RTOL, K1_AB_ATOL]))
    headline = {"vol_path": "vpt mis", "vol_spp": f"vpt mis, {cfg.spp} spp",
                "vol_spp_persistent": f"vpt mis, {cfg.spp} spp"}
    entries = []
    for name in vm.KERNEL_NAMES:
        head = next(c for c in cases[name] if c["case"] == headline[name])
        entries.append(dict(
            name=name, route="cuda",
            source="xraytracer_tpu_torch/csrc/vol_megakernel.cu",
            replaces=VOL_REPLACES[name],
            launches=None, launches_by_path=None,
            max_abs_err=max(c["max_abs_err"] for c in cases[name]),
            err_of="radiance (sum over the launch's samples) per pixel and "
                   "channel against the plain version, worst case",
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None,
            shape=f"{head['case']}: N={head['n']} triangles={head['t_total']} "
                  f"depth={depth} n_spp={head['n_spp']}",
            cases=[{k: c.get(k) for k in ("case", "n", "n_spp", "ms", "plain_ms",
                                          "plain_batch", "bound_ms", "bound_by",
                                          "pixels_beyond_gate")}
                   for c in cases[name]],
        ))
    return entries


def capture_tracking_inputs(renderer, which):
    """Render one sample and keep the arguments of the ``which``-th calls of
    both tracking kernels (clones), as the wavefront loop gave them; the
    renderer's integrator must take the wavefront route."""
    from xraytracer_tpu_torch import media_kernels as mkk

    got = {"track_sample": [], "track_transmittance": []}
    seen = {"track_sample": 0, "track_transmittance": 0}
    orig = {k: getattr(mkk, k) for k in got}

    def wrap(name):
        def fn(hm, *args):
            if seen[name] in which:
                got[name].append((hm,) + tuple(
                    a.clone() if hasattr(a, "clone") else a for a in args))
            seen[name] += 1
            return orig[name](hm, *args)
        return fn

    for k in got:
        setattr(mkk, k, wrap(k))
    try:
        renderer.render(1)
    finally:
        for k in got:
            setattr(mkk, k, orig[k])
    return got


def compare_track_sample(what, got, ref, mask):
    """track_sample vs its plain version, per lane -> dict of counts and
    errors; fails when the share of lanes that disagree on ``scattered`` /
    ``scat_step`` or miss the t / weight gates is beyond TRACK_LANE_SHARE."""
    import torch

    t, w, sc, st = got
    pt, pw, psc, pst = ref
    n = t.shape[0]
    check(bool(torch.isfinite(t).all()) and bool(torch.isfinite(w).all()),
          f"{what}: non-finite outputs")
    mism_sc = sc != psc
    mism_st = st != pst
    agree = ~(mism_sc | mism_st)
    t_over = (torch.abs(t - pt) > TRACK_T_ATOL + TRACK_T_RTOL * torch.abs(pt)) & agree
    w_over = (torch.abs(w - pw) > TRACK_W_ATOL + TRACK_W_RTOL * torch.abs(pw)
              ).any(dim=-1) & agree
    off = int((~agree | t_over | w_over).sum())
    out = dict(
        n=n, tracking_lanes=int(mask.sum()), scattered=int(psc.sum()),
        exhausted=int(((pw == 0).all(dim=-1) & mask).sum()),
        scattered_mismatch=int(mism_sc.sum()), scat_step_mismatch=int(mism_st.sum()),
        t_beyond_gate=int(t_over.sum()), w_beyond_gate=int(w_over.sum()),
        lanes_off=off, lanes_off_limit=max(1, int(TRACK_LANE_SHARE * n)),
        t_bitwise_equal_lanes=int((t == pt).sum()),
        w_bitwise_equal_lanes=int((w == pw).all(dim=-1).sum()),
        t_max_abs_err=float(torch.abs(t - pt)[agree].max()) if bool(agree.any()) else 0.0,
        max_abs_err=float(torch.abs(w - pw)[agree].max()) if bool(agree.any()) else 0.0,
    )
    check(off <= out["lanes_off_limit"],
          f"{what}: {off} of {n} lanes disagree or miss the gates "
          f"(scattered {out['scattered_mismatch']}, step {out['scat_step_mismatch']}, "
          f"t {out['t_beyond_gate']}, w {out['w_beyond_gate']})")
    off_lanes = ~mask
    check(bool((w[off_lanes] == 1).all()) and not bool(sc[off_lanes].any()),
          f"{what}: a masked lane did not pass through")
    return out


def track_bound(tables, n, in_bytes, out_bytes, lanes, segments, candidates,
                flops_per_candidate):
    """bound_ms of a tracking launch over ``n`` lanes of which ``lanes``
    track, their spans crossing ``segments`` supergrid segments and their
    loops drawing ``candidates`` collision candidates in all (see the
    docstring for what counts as bytes and operations)."""
    n_bytes = n * (1 + out_bytes) + lanes * (in_bytes - 1)
    if lanes:
        n_bytes += tables.grid_super.numel() * 4
    if candidates:
        n_bytes += tables.grid_density.numel() * 4
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = (segments * FLOPS_DDA_SEGMENT
              + candidates * flops_per_candidate) / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                segments=segments, candidates=candidates)


def phase_track_kernels(device, nee_scene, volume_scene, reps):
    """Hold the two tracking kernels against their plain versions on lanes
    captured from real renders: of the nee preset at 780x585 (the first
    iteration: camera rays entering the box; a later one: scattered rays
    inside it; the transmittance kernel on the NEE segments of the same
    iterations) and of the volume preset at 512x512 (sigma_t 1.0: long
    candidate chains; the first and a late iteration, and the same lanes
    under a step bound they exhaust), plus rays that miss the grid and an
    all-masked wavefront. Returns the ``kernels`` entries."""
    import ctypes
    import dataclasses

    import torch

    from xraytracer_tpu_torch import media_kernels as mkk
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.integrators import make_volume_integrator
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    cfg = get_preset("nee")
    tables, camk = nee_scene
    st = scene_statics(tables)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **camk)
    # the wavefront route (with_stats keeps it), whose tracking loops are the
    # two kernels; the default route of this scene is the whole-path kernel
    integ = make_volume_integrator(tables, st, cfg.max_depth, nee=True,
                                   with_stats=True)
    r = WavefrontRenderer(tables, cam, integ, cfg.width, cfg.height, seed=0)
    got = capture_tracking_inputs(r, CAPTURE_ITERATIONS)
    check(all(len(v) == len(CAPTURE_ITERATIONS) for v in got.values()),
          "nee: the wavefront loop did not call both tracking kernels")
    cases = {k: [] for k in mkk.KERNEL_NAMES}

    def sample_case(label, hm, o, d, t0, t1, tp, keys, site, mask):
        cand = []
        with TrackingTally() as tally:
            ref, plain_ms = timed_once(lambda: mkk.track_sample_plain(
                hm, o, d, t0, t1, tp, keys, site, mask, candidates=cand))
        run = lambda: mkk.track_sample(hm, o, d, t0, t1, tp, keys, site, mask)
        out = run()
        torch.cuda.synchronize()
        case = compare_track_sample(f"track_sample, {label}", out, ref, mask)
        n = o.shape[0]
        case.update(case=label, site=site, max_steps=hm.max_steps, plain_ms=plain_ms,
                    plain_loop_steps=len(cand), ms=median_ms(run, reps, flush),
                    **track_bound(hm.scene, n, 49, 21, int(mask.sum()),
                                  tally.sample_segments, sum(cand),
                                  FLOPS_TRACK_CANDIDATE))
        cases["track_sample"].append(case)

    def transmittance_case(label, hm, p1, p2, keys, site, mask):
        cand = []
        with TrackingTally() as tally:
            ref, plain_ms = timed_once(lambda: mkk.track_transmittance_plain(
                hm, p1, p2, keys, site, mask, candidates=cand))
        run = lambda: mkk.track_transmittance(hm, p1, p2, keys, site, mask)
        out = run()
        torch.cuda.synchronize()
        n = p1.shape[0]
        check(bool(torch.isfinite(out).all()), f"track_transmittance, {label}: non-finite")
        over = (torch.abs(out - ref) > TRACK_W_ATOL + TRACK_W_RTOL * torch.abs(ref)
                ).any(dim=-1)
        off = int(over.sum())
        check(off <= max(1, int(TRACK_LANE_SHARE * n)),
              f"track_transmittance, {label}: {off} of {n} lanes beyond rtol "
              f"{TRACK_W_RTOL} / atol {TRACK_W_ATOL}")
        check(bool((out[~mask] == 1).all()),
              f"track_transmittance, {label}: a masked lane is not 1")
        cases["track_transmittance"].append(dict(
            case=label, n=n, site=site, max_steps=hm.max_steps,
            tracking_lanes=int(mask.sum()),
            exhausted=int(((ref == 0).all(dim=-1) & mask).sum()),
            lanes_off=off, lanes_off_limit=max(1, int(TRACK_LANE_SHARE * n)),
            bitwise_equal_lanes=int((out == ref).all(dim=-1).sum()),
            max_abs_err=float(torch.abs(out - ref).max()),
            mean_transmittance=float(ref[mask].mean()) if bool(mask.any()) else 1.0,
            plain_ms=plain_ms, plain_loop_steps=len(cand),
            ms=median_ms(run, reps, flush),
            **track_bound(hm.scene, n, 29, 12, int(mask.sum()), tally.tr_segments,
                          sum(cand), FLOPS_TRANSMITTANCE_CANDIDATE)))

    for it, args in zip(CAPTURE_ITERATIONS, got["track_sample"]):
        sample_case(f"nee iteration {it}", *args)
    for it, args in zip(CAPTURE_ITERATIONS, got["track_transmittance"]):
        transmittance_case(f"nee iteration {it} NEE segments", *args)

    # the volume preset's lanes: the shapes volume_path gives track_sample
    vcfg = get_preset("volume")
    vtables, vcamk = volume_scene
    vcam = PinholeCamera.make(vcfg.width / vcfg.height, device=device, **vcamk)
    vinteg = make_volume_integrator(vtables, scene_statics(vtables), vcfg.max_depth,
                                    with_stats=True)
    vr = WavefrontRenderer(vtables, vcam, vinteg, vcfg.width, vcfg.height, seed=0)
    vgot = capture_tracking_inputs(vr, VOLUME_CAPTURE_ITERATIONS)["track_sample"]
    check(len(vgot) == len(VOLUME_CAPTURE_ITERATIONS),
          "volume: the wavefront loop did not call track_sample")
    for it, args in zip(VOLUME_CAPTURE_ITERATIONS, vgot):
        sample_case(f"volume iteration {it}", *args)
        check(cases["track_sample"][-1]["tracking_lanes"] > 0,
              f"volume iteration {it}: no lane tracks")
    sample_case(f"volume iteration 0, max_steps {EXHAUST_MAX_STEPS}",
                mkk.het_medium(vtables, EXHAUST_MAX_STEPS), *vgot[0][1:])
    check(cases["track_sample"][-1]["exhausted"] > 0,
          "volume: no lane ran into the step bound")

    # rays that miss the grid (density 0 along the whole span: no lane may
    # scatter), the uniform channel pick, and an all-masked wavefront
    hm, o, d, t0, t1, tp, keys, site, mask = got["track_sample"][0]
    far = o + torch.tensor([0.0, 5000.0, 0.0], device=device)
    sample_case("rays that miss the grid", hm, far, d, t0, t1, tp, keys, site, mask)
    check(cases["track_sample"][-1]["scattered"] == 0, "a ray outside the grid scattered")
    hm_u = mkk.het_medium(tables, hm.max_steps, chan_uniform=True)
    sample_case("nee iteration 0, uniform channel pick", hm_u, o, d, t0, t1, tp,
                keys, site, mask)
    none = torch.zeros_like(mask)
    zero = torch.zeros_like(t0)
    sample_case("all lanes masked", hm, o, d, zero, zero, tp, keys, site, none)
    t_none = mkk.track_sample(hm, o, d, zero, zero, tp, keys, site, none)[0]
    check(bool((t_none == 1e-3).all()), "masked lanes must stop at t1 + RAY_EPS")
    hm_t, p1, p2, keys_t, site_t, mask_t = got["track_transmittance"][0]
    transmittance_case("all lanes masked", hm_t, p1, p1, keys_t, site_t,
                       torch.zeros_like(mask_t))
    # the dense-grid fetch (eight loads), which grids past the packing gate take
    ic = list(hm.ic)
    ic[8] = 0
    hm_dense = dataclasses.replace(hm, ic=(ctypes.c_int * len(ic))(*ic))
    a = mkk.track_sample(hm_dense, o, d, t0, t1, tp, keys, site, mask)
    b = mkk.track_sample(hm, o, d, t0, t1, tp, keys, site, mask)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(x, y)) for x, y in zip(a, b)),
          "track_sample: the dense-grid fetch differs from the corner-row fetch")

    emit("kernel_checks", kernels="tracking", cases=cases, reps=reps,
         captured_from=f"nee preset {cfg.width}x{cfg.height}, sample 0, "
                       f"iterations {list(CAPTURE_ITERATIONS)}; volume preset "
                       f"{vcfg.width}x{vcfg.height}, sample 0, iterations "
                       f"{list(VOLUME_CAPTURE_ITERATIONS)}",
         dense_fetch_bitwise_equal=True,
         tolerances=dict(t=[TRACK_T_RTOL, TRACK_T_ATOL], w=[TRACK_W_RTOL, TRACK_W_ATOL],
                         lane_share=TRACK_LANE_SHARE))
    entries = []
    for name, head_case in (("track_sample", "nee iteration 0"),
                            ("track_transmittance", "nee iteration 0 NEE segments")):
        head = next(c for c in cases[name] if c["case"] == head_case)
        entries.append(dict(
            name=name, route="cuda", source="xraytracer_tpu_torch/csrc/media.cu",
            replaces=TRACK_REPLACES[name], launches=None, launches_by_path=None,
            max_abs_err=max(c["max_abs_err"] for c in cases[name]),
            err_of=("weight per lane and channel on lanes that agree on scattered "
                    "and scat_step, worst case" if name == "track_sample" else
                    "transmittance per lane and channel, worst case"),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=None,
            shape=f"{head['case']}: N={head['n']} tracking={head['tracking_lanes']} "
                  f"candidates={head['candidates']} grid=64^3",
            cases=[{k: c[k] for k in ("case", "n", "max_steps", "tracking_lanes",
                                      "candidates", "exhausted", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "lanes_off")}
                   for c in cases[name]],
        ))
    return entries


# --------------------------------------------------------------------------
# the heterogeneous whole-path kernels
# --------------------------------------------------------------------------
HET_REPLACES = {
    "het_path": "xraytracer_tpu/integrators/het_megakernel.py:548",
    "het_spp": "xraytracer_tpu/integrators/megakernel.py:1468",
    "het_spp_persistent": "xraytracer_tpu/integrators/megakernel.py:1519",
}


class TrackingTally:
    """Counts, over a plain render, the lanes that enter each host-side
    tracking loop of ``media.py``, the supergrid segments their spans cross
    (the segments of the plain walk that start before the span's end) and
    the collision candidates they draw: the work a whole-path heterogeneous
    kernel does in its tracking."""

    def __init__(self):
        self.sample_lanes = self.sample_candidates = self.sample_segments = 0
        self.tr_lanes = self.tr_candidates = self.tr_segments = 0

    def __enter__(self):
        import torch

        from xraytracer_tpu_torch import media

        self._orig = (media._track_sample, media._track_transmittance,
                      media._majorant_segments)
        orig_s, orig_t, orig_walk = self._orig
        crossed = []

        def walk(scene, med, rays, t0, t1):
            out = orig_walk(scene, med, rays, t0, t1)
            t0f = torch.where(torch.isfinite(t0), t0, torch.zeros_like(t0))
            t1f = torch.where(torch.isfinite(t1), torch.maximum(t1, t0f), t0f)
            crossed.append((out[0][:, :-1] < t1f[:, None]).sum(dim=1))
            return out

        def sample(*args, het_mask=None, candidates=None, **kw):
            cand = [] if candidates is None else candidates
            n0 = len(cand)
            crossed.clear()
            out = orig_s(*args, het_mask=het_mask, candidates=cand, **kw)
            self.sample_lanes += int(het_mask.sum())
            self.sample_segments += int(crossed[0][het_mask].sum())
            self.sample_candidates += sum(cand[n0:])
            return out

        def transmittance(scene, med, p1, p2, keys, site, max_steps, het_mask,
                          candidates=None, **kw):
            cand = [] if candidates is None else candidates
            n0 = len(cand)
            crossed.clear()
            out = orig_t(scene, med, p1, p2, keys, site, max_steps, het_mask,
                         candidates=cand, **kw)
            self.tr_lanes += int(het_mask.sum())
            self.tr_segments += int(crossed[0][het_mask].sum())
            self.tr_candidates += sum(cand[n0:])
            return out

        (media._track_sample, media._track_transmittance,
         media._majorant_segments) = sample, transmittance, walk
        return self

    def __exit__(self, *exc):
        from xraytracer_tpu_torch import media

        (media._track_sample, media._track_transmittance,
         media._majorant_segments) = self._orig
        return False


def live_grid_tally(hc, o, d, keys, grid):
    """The plain version's per-iteration counters and tracking tally of
    ``het_path`` on a live density grid (the gradient route's pass A)."""
    import dataclasses

    from xraytracer_tpu_torch.integrators import het_megakernel as hk

    live = dataclasses.replace(hc, scene=hk._live_scene(hc, grid))
    stats = {}
    with TrackingTally() as tally:
        hk.het_path_plain(live, o, d, keys, stats)
    return stats, tally


def het_bound(tables, n, n_spheres, nee, stats, tally, bytes_in, bytes_out):
    """bound_ms of a whole-path heterogeneous launch from the plain version's
    per-iteration counters and tracking tallies on the same inputs (see the
    docstring)."""
    rays = int(stats["rays"].sum())
    scattered = int(stats["scattered"].sum())
    hit_test = n_spheres * FLOPS_HET_SPHERE + FLOPS_VOL_BOX
    ops = (rays * (hit_test + FLOPS_VOL_RR)
           + tally.sample_segments * FLOPS_DDA_SEGMENT
           + tally.sample_candidates * FLOPS_TRACK_CANDIDATE
           + scattered * FLOPS_HET_SCATTER)
    if nee:
        ops += (scattered * (FLOPS_HET_CONE + hit_test + FLOPS_HET_NEE_REST)
                + tally.tr_segments * FLOPS_DDA_SEGMENT
                + tally.tr_candidates * FLOPS_TRANSMITTANCE_CANDIDATE)
    n_bytes = n * (bytes_in + bytes_out)
    if tally.sample_lanes or tally.tr_lanes:
        n_bytes += tables.grid_super.numel() * 4
    if tally.sample_candidates or tally.tr_candidates:
        n_bytes += tables.grid_density.numel() * 4
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                rays=rays, scattered=scattered, tracking_lanes=tally.sample_lanes,
                segments=tally.sample_segments, candidates=tally.sample_candidates,
                shadow_lanes=tally.tr_lanes, shadow_segments=tally.tr_segments,
                shadow_candidates=tally.tr_candidates)


def eight_light_cloud(device):
    """The nee preset's 64^3 cloud (g = 0.3) under 8 sphere lights of
    different colours, placed as in tests/test_het_megakernel.py: every light
    pick and shadow ray of the NEE block gets work."""
    import numpy as np

    from xraytracer_tpu_torch.scene.builder import SceneBuilder
    from xraytracer_tpu_torch.scene.presets import procedural_cloud

    b = SceneBuilder()
    b.set_density_grid(procedural_cloud(), np.array([-165.0, -110.0, -160.0], np.float32),
                       np.array([165.0, 110.0, 160.0], np.float32))
    b.add_heterogeneous_medium(0.3, (0.01, 0.01, 0.01), (0.05, 0.05, 0.05))
    g = np.random.default_rng(9)
    for i in range(8):
        c = g.uniform(-1.0, 1.0, 3) * np.array([300.0, 80.0, 300.0])
        c[1] += 330.0
        b.add_sphere_light(tuple(c), 40.0, (5.0 + 3.0 * i, 20.0 - 2.0 * i, 8.0))
    return b.build(device)


def phase_het_kernels(device, nee_scene, volume_scene, reps):
    """Hold the three whole-path heterogeneous kernels against their plain
    versions on the card: the nee preset (780x585, depth 32, NEE), the
    volume preset (512x512, depth 100) and the 8-light cloud (nee size,
    depth 8, NEE); on the camera rays of sample 0, and on a chunk of
    HET_CHECK_SPP samples per pixel, per-sample loop against merged loop
    (bitwise), raster against morton lane order (bitwise); a resumed chunk
    and the depth gate. Returns the ``kernels`` entries."""
    import numpy as np
    import torch

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.integrators import het_megakernel as hk
    from xraytracer_tpu_torch.integrators import megakernel as mk
    from xraytracer_tpu_torch.scene.builder import scene_statics

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    ncfg, vcfg = get_preset("nee"), get_preset("volume")
    scenes = [
        # label, tables, camera, width, height, depth, nee
        ("nee", *nee_scene, ncfg.width, ncfg.height, ncfg.max_depth, True),
        ("volume", *volume_scene, vcfg.width, vcfg.height, vcfg.max_depth, False),
        ("8 lights nee", eight_light_cloud(device), nee_scene[1], ncfg.width,
         ncfg.height, HET_LIGHTS_DEPTH, True),
    ]
    cases = {k: [] for k in ("het_path", "het_spp", "het_spp_persistent")}
    for label, tables, camk, w, h, depth, nee in scenes:
        st = scene_statics(tables)
        hc = hk._het_consts(tables, st, depth, nee, None, None)
        check(hc is not None, f"{label}: scene not eligible for the fused het route")
        cam = PinholeCamera.make(w / h, device=device, **camk)
        render = {order: hk.try_make_fused_het_spp_render(
            tables, st, cam, w, h, 0, depth, nee=nee, pixel_order=order)
            for order in ("raster", "morton")}
        view = render["raster"].view
        n = view.n
        n_sph = int(hc.ic[0])
        common = dict(n_spheres=n_sph, n_lights=int(hc.ic[1]), nee=nee, max_depth=depth,
                      n_iterations=hc.n_iterations, max_steps=hc.max_steps)

        # K9a on the camera rays of sample 0
        keys, o, d = mk._camera_rays_plain(view, 0)
        stats = {}
        with TrackingTally() as tally:
            ref, plain_ms = timed_once(lambda: hk.het_path_plain(hc, o, d, keys, stats))
        got = hk.het_path(hc, o, d, keys)
        torch.cuda.synchronize()
        case = compare_radiance(f"het_path, {label}", got, ref)
        case.update(case=label, n_spp=1, plain_ms=plain_ms,
                    ms=median_ms(lambda: hk.het_path(hc, o, d, keys), reps, flush),
                    **het_bound(tables, n, n_sph, nee, stats, tally, 28, 12), **common)
        cases["het_path"].append(case)
        del got, ref

        n_spp = HET_CHECK_SPP
        tag = f"{label}, {n_spp} spp"
        stats = {}
        with TrackingTally() as tally:
            (ref, ref_rej), plain_ms = timed_once(
                lambda: hk.het_spp_persistent_plain(hc, view, 0, n_spp, stats, n_spp))
        got_c, rej_c = hk.het_spp_persistent(hc, view, 0, n_spp)
        got_b, rej_b = hk.het_spp(hc, view, 0, n_spp)
        torch.cuda.synchronize()
        bound = het_bound(tables, n, n_sph, nee, stats, tally, 12, 16)
        for name, got, rej in (("het_spp_persistent", got_c, rej_c),
                               ("het_spp", got_b, rej_b)):
            case = compare_radiance(f"{name}, {tag}", got, ref, rej, ref_rej)
            fn = getattr(hk, name)
            case.update(case=tag, n_spp=n_spp, plain_ms=plain_ms, plain_batch=n_spp,
                        ms=median_ms(lambda: fn(hc, view, 0, n_spp), reps, flush),
                        **bound, **common)
            cases[name].append(case)
        # per-sample loop vs merged loop, raster vs morton: bitwise
        check(bool(torch.equal(got_b, got_c)) and bool(torch.equal(rej_b, rej_c)),
              f"{tag}: het_spp vs het_spp_persistent differ by "
              f"{float(torch.abs(got_b - got_c).max())}")
        rad_m, rej_m = render["morton"](0, n_spp)
        back = torch.empty_like(rad_m)
        back[torch.as_tensor(render["morton"].pixel_ids.astype(np.int64),
                             device=device)] = rad_m
        check(bool(torch.equal(back, got_c)) and int(rej_m) == int(rej_c.sum()),
              f"{tag}: morton lane order is not bitwise raster's image")
        cases["het_spp_persistent"][-1].update(vs_het_spp_bitwise_equal=True,
                                                morton_bitwise_equal=True)
        del got_c, got_b, ref, back

    # K9a at tools.fit_volume's shape: pass A of its gradient steps (grad
    # sampling, the live grid: eight corner loads per lookup), first view
    from xraytracer_tpu_torch.tools import fit_volume

    fw, fh = 96, 72
    ftables = fit_volume.build_scene(device)
    fst = scene_statics(ftables)
    fcam = fit_volume._cameras(fw, fh, device)[0]
    fstep = hk.try_make_fused_het_value_and_grad(ftables, fst, fcam, fw, fh,
                                                 fit_volume.MAX_DEPTH, nee=True)
    check(fstep is not None, "fit_volume scene: not eligible for the het gradient route")
    fhc = fstep.het_consts
    fgrid = torch.from_numpy(fit_volume._blob_target()).to(device)
    ids, xy = window_pixels(fw, fh, None, device)
    keys, o, d = het_grad_rays(fcam, fw, fh, ids, xy, 0, 0)
    ref, plain_ms = timed_once(lambda: hk.het_path_plain(fhc, o, d, keys, density=fgrid))
    stats, tally = live_grid_tally(fhc, o, d, keys, fgrid)
    got = hk.het_path(fhc, o, d, keys, density=fgrid)
    torch.cuda.synchronize()
    label = f"fit_volume view 0, {fw}x{fh}"
    case = compare_radiance(f"het_path, {label}", got, ref)
    case.update(case=label, n_spp=1, plain_ms=plain_ms,
                ms=median_ms(lambda: hk.het_path(fhc, o, d, keys, density=fgrid),
                             reps, flush),
                **het_bound(ftables, fw * fh, int(fhc.ic[0]), True, stats, tally, 28, 12),
                n_spheres=int(fhc.ic[0]), n_lights=int(fhc.ic[1]), nee=True,
                max_depth=fit_volume.MAX_DEPTH, n_iterations=fhc.n_iterations,
                max_steps=fhc.max_steps, grid="16^3, live (grad sampling)")
    cases["het_path"].append(case)

    # a resumed chunk continues the stream: (0, 2) + (2, 1) == (0, 3)
    tables, camk = nee_scene
    st = scene_statics(tables)
    cam = PinholeCamera.make(ncfg.width / ncfg.height, device=device, **camk)
    rc = hk.try_make_fused_het_spp_render(tables, st, cam, ncfg.width, ncfg.height, 0,
                                          ncfg.max_depth, nee=True)
    whole, _ = rc(0, 3)
    first, _ = rc(0, 2)
    last, _ = rc(2, 1)
    resumed_diff = float(torch.abs(first + last - whole).max())
    check(resumed_diff <= 1e-4, f"het: resumed chunk differs by {resumed_diff}")
    check(hk.try_make_fused_het_spp_render(tables, st, cam, ncfg.width, ncfg.height, 0,
                                           hk.MAX_DEPTH + 1) is None,
          "depth 129 must route to the wavefront volume integrator")

    attrs = het_kernel_attrs(hk._lib())
    for name, kcases in cases.items():
        for c in kcases:
            c.update(attrs[name])
    emit("kernel_checks", kernels="heterogeneous whole-path", cases=cases, reps=reps,
         resumed_chunk_max_abs_diff=resumed_diff, kernel_attrs=attrs,
         tolerances=dict(pixel=[K1_RTOL, K1_ATOL], pixel_share=K1_PIXEL_DIFF_SHARE,
                         loose=[K1_LOOSE_RTOL, K1_LOOSE_ATOL],
                         mean=MEAN_BAND_KERNEL_VS_PLAIN, loop_ab="bitwise"))
    headline = {"het_path": "nee", "het_spp": f"nee, {HET_CHECK_SPP} spp",
                "het_spp_persistent": f"nee, {HET_CHECK_SPP} spp"}
    entries = []
    for name in headline:
        head = next(c for c in cases[name] if c["case"] == headline[name])
        entries.append(dict(
            name=name, route="cuda",
            source="xraytracer_tpu_torch/csrc/het_megakernel.cu",
            replaces=HET_REPLACES[name],
            launches=None, launches_by_path=None,
            max_abs_err=max(c["max_abs_err"] for c in cases[name]),
            err_of="radiance (sum over the launch's samples) per pixel and "
                   "channel against the plain version, worst case",
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None,
            shape=f"{head['case']}: N={head['n']} depth={head['max_depth']} "
                  f"n_spp={head['n_spp']} grid=64^3",
            cases=[{k: c.get(k) for k in ("case", "n", "n_spp", "max_depth", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "segments", "candidates", "shadow_segments",
                                          "shadow_candidates", "pixels_beyond_gate",
                                          "registers", "stack_bytes",
                                          "smem_bytes_per_block")}
                   for c in cases[name]],
        ))
    return entries


PTXAS_KERNELS = ("het_path_kernel", "het_spp_kernel", "het_spp_persistent_kernel",
                 "het_grad_path_kernel", "track_sample_kernel",
                 "track_transmittance_kernel", "sweep_kernel", "chunk_boxes_kernel",
                 "mega_path_kernel", "mega_spp_kernel", "mega_spp_persistent_kernel",
                 "mega_grad_path_kernel", "mega_coeffs_kernel", "vol_path_kernel",
                 "vol_spp_kernel", "vol_spp_persistent_kernel")
SWEEP_MODES = ("sweep_nearest", "sweep_nearest_rec", "occluded_anyhit")
MEGA_WALKS = ("staged", "culled")  # csrc/megakernel.cu K1cWalk


def ptxas_table(text):
    """Registers, stack frame, spill stores / loads and static shared
    memory per kernel, from ``-Xptxas -v``'s report (nvcc's stderr)."""
    import re

    table, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            cur = next((k[:-len("_kernel")] for k in PTXAS_KERNELS
                        if f"{len(k)}{k}" in m.group(1)), None)
            if cur == "sweep":  # sweep_kernel<MODE>
                cur = SWEEP_MODES[int(re.search(r"ILi(\d)E", m.group(1)).group(1))]
            elif cur in ("mega_spp_persistent", "mega_path", "mega_spp"):  # <WALK>
                walk = re.search(r"ILi(\d)E", m.group(1))
                if walk:
                    cur += "<" + MEGA_WALKS[int(walk.group(1))] + ">"
            elif cur == "mega_grad_path":  # mega_grad_path_kernel<MB, WALK>
                mb = re.search(r"ILi(\d)ELi(\d)E", m.group(1))
                if mb:
                    cur += f"<{mb.group(1)},{MEGA_WALKS[int(mb.group(2))]}>"
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            table.setdefault(cur, {}).update(
                stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            table.setdefault(cur, {}).update(
                registers=int(m.group(1)),
                smem_bytes_per_block=int(smem.group(1)) if smem else 0)
    return table


def het_kernel_attrs(lib):
    """What the loaded heterogeneous library's kernels were compiled to
    (cudaFuncGetAttributes): registers, stack (local memory) bytes per
    thread and shared bytes per block (static; the launches add none)."""
    import ctypes

    from xraytracer_tpu_torch.integrators import het_megakernel as hk

    fn = lib.het_kernel_attrs
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = {}
    for which, name in enumerate(hk.KERNEL_NAMES):
        v = (ctypes.c_int * 4)()
        check(fn(which, v) == 0, f"cudaFuncGetAttributes failed for {name}")
        out[name] = dict(registers=v[0], stack_bytes=v[1], smem_bytes_per_block=v[2],
                         max_threads_per_block=v[3])
    return out


def build_sources(jobs):
    """Compile other builds of sources beside the package's libraries, one
    nvcc per (tag, source, extra flags) job, all started together; returns
    {tag: (library path, ptxas table)}."""
    from xraytracer_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for tag, src, flags in jobs:
        out = os.path.join(_build.BUILD_DIR, f"lib_{tag}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-o", out, src]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), out)
    built = {}
    for tag, (proc, out) in procs.items():
        so, se = proc.communicate()
        check(proc.returncode == 0, f"{tag}: build failed:\n{se}")
        built[tag] = (out, ptxas_table(so + se))
    return built


def phase_launch_bounds_ab(device, nee_scene, volume_scene, reps):
    """K9b and K9c at AB_SPP samples per pixel on the nee and volume presets,
    compiled with __launch_bounds__(128, m) for m = 1, 2, 4 (the package's
    own), 5 (the most blocks the 38,912-byte segment frames leave room for
    in an SM's shared memory) and 8: registers, stack, spills, shared bytes
    per block (ptxas) and times in one call, on one card."""
    import ctypes

    import torch

    from xraytracer_tpu_torch import _build
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.integrators import het_megakernel as hk
    from xraytracer_tpu_torch.scene.builder import scene_statics

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    src = os.path.join(_build.CSRC_DIR, "het_megakernel.cu")
    caps = (1, 2, 4, 5, 8)
    built = build_sources([(f"het_megakernel_mb{m}", src, [f"-DHET_MIN_BLOCKS={m}"])
                           for m in caps])
    libs = {m: hk._bind(ctypes.CDLL(built[f"het_megakernel_mb{m}"][0])) for m in caps}
    package_lib = hk._lib
    rows = []
    try:
        for preset, (tables, camk) in (("nee", nee_scene), ("volume", volume_scene)):
            cfg = get_preset(preset)
            st = scene_statics(tables)
            nee = cfg.integrator == "vpt_nee"
            hc = hk._het_consts(tables, st, cfg.max_depth, nee, None, None)
            cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **camk)
            view = hk.try_make_fused_het_spp_render(
                tables, st, cam, cfg.width, cfg.height, 0, cfg.max_depth, nee=nee).view
            ref = None
            for m, lib in libs.items():
                hk._lib = lambda lib=lib: lib
                out, _ = hk.het_spp_persistent(hc, view, 0, AB_SPP)
                torch.cuda.synchronize()
                if ref is None:
                    ref = out
                rows.append(dict(
                    preset=preset, min_blocks=m, n_spp=AB_SPP,
                    het_spp_persistent_ms=median_ms(
                        lambda: hk.het_spp_persistent(hc, view, 0, AB_SPP), reps, flush),
                    het_spp_ms=median_ms(
                        lambda: hk.het_spp(hc, view, 0, AB_SPP), reps, flush),
                    max_abs_diff_vs_first=float(torch.abs(out - ref).max())))
    finally:
        hk._lib = package_lib
    emit("launch_bounds_ab", block=128, rows=rows,
         ptxas={m: built[f"het_megakernel_mb{m}"][1] for m in libs})


def bind_launchers(module, lib, names):
    """Declare the C signatures of ``names`` (launchers of ``module``) on
    another build's library."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = module._ARGTYPES[name]
        fn.restype = ctypes.c_int
    lib._xrt_bound = True
    return lib


# the sources each A/B compares: a build whose copies of these equal the
# package's is not built again
SWEEP_SOURCES = ("sweep.cu", "sweep.cuh", "tri_test.cuh", "common.cuh")
TRACK_SOURCES = ("media.cu", "het_megakernel.cu", "media.cuh", "het_path.cuh",
                 "path_common.cuh", "tri_test.cuh", "common.cuh")
MEGA_SOURCES = ("megakernel.cu", "mega_path.cuh", "mega_grad.cuh", "sweep.cuh",
                "path_common.cuh", "tri_test.cuh", "common.cuh")
VOL_SOURCES = ("vol_megakernel.cu", "vol_path.cuh", "path_common.cuh", "common.cuh")
# the C signatures of a sweep.cu from before the chunk table
BRUTE_FORCE_ARGTYPES = {
    "sweep_nearest": [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int] + [ctypes.c_void_p] * 6,
    "sweep_nearest_rec": [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int] + [ctypes.c_void_p] * 8,
    "occluded_anyhit": [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int] + [ctypes.c_void_p] * 4,
}


def sources_differ(d, names):
    from xraytracer_tpu_torch import _build

    def read(path):
        return open(path, "rb").read() if os.path.exists(path) else None

    return any(read(os.path.join(d, n)) != read(os.path.join(_build.CSRC_DIR, n))
               for n in names)


class BruteForceSweeps:
    """A sweep library built from a sweep.cu that predates the chunk table
    (its launchers take the mask, no table), called through the package's
    argument lists: the table's v0, e1, e2 and mask pointers come from
    ``table``, set for each case; the chunk table is the package's and is
    not read."""

    def __init__(self, lib, package):
        for name, argtypes in BRUTE_FORCE_ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib, self.package, self.table = lib, package, None
        self.chunk_boxes = package.chunk_boxes

    def sweep_nearest(self, o, d, n, v0, e1, e2, t_total, center, boxes, coef, *outs):
        return self.lib.sweep_nearest(o, d, n, v0, e1, e2, self.table[3], t_total,
                                      center, *outs)

    def sweep_nearest_rec(self, o, d, n, v0, e1, e2, t_total, center, boxes, coef,
                          rec, *outs):
        return self.lib.sweep_nearest_rec(o, d, n, v0, e1, e2, self.table[3], t_total,
                                          center, rec, *outs)

    def occluded_anyhit(self, o, d, n, t_total, center, boxes, coef, *rest):
        return self.lib.occluded_anyhit(o, d, n, *self.table, t_total, center, *rest)


def bind_mega(lib):
    """A megakernel library of another build, bound through the package's
    C signatures; a build from before the chunk table (no ``mega_abi``)
    takes the scene arguments without the table's boxes."""
    from xraytracer_tpu_torch.integrators import megakernel as mk

    if hasattr(lib, "mega_abi"):
        return mk._bind(lib)
    return MegaWithoutBoxes(lib)


class MegaWithoutBoxes:
    """The launchers of a megakernel library whose scene arguments end
    before the chunk table's boxes (``megakernel._SCENE_ARGTYPES`` less its
    last entry), called with the package's argument lists."""

    def __init__(self, lib):
        from xraytracer_tpu_torch.integrators import megakernel as mk

        n_scene = len(mk._SCENE_ARGTYPES)
        self._calls = {}
        for name, argtypes in mk._ARGTYPES.items():
            first = 8 if name.startswith("mega_spp") else 4  # scene args' offset
            box = first + n_scene - 1
            fn = getattr(lib, name)
            fn.argtypes = argtypes[:box] + argtypes[box + 1:]
            fn.restype = ctypes.c_int
            self._calls[name] = (fn, box)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        fn, box = self._calls[name]
        return lambda *args: fn(*args[:box], *args[box + 1:])


def bind_vol(lib):
    """A volume library of another build, bound through the package's C
    signatures; a build of an older interface (``vol_abi`` below 2, or no
    ``vol_abi``: from before the work order) through ``VolOlderAbi``."""
    from xraytracer_tpu_torch.integrators import vol_megakernel as vm

    abi = lib.vol_abi() if hasattr(lib, "vol_abi") else 0
    return vm._bind(lib) if abi >= 2 else VolOlderAbi(lib, abi)


class VolOlderAbi:
    """The launchers of a volume library of interface 0 (no work order: lane
    i carries view lane i) or 1 (``vol_path`` reads int32 keys only, no
    stride), called with the package's argument lists, less what that build
    does not take. int64 keys reach such a ``vol_path`` as that build's
    wrapper passed them: converted to int32 bits in the call (the tensor
    found by its pointer in ``KEYS``, where the caller puts it)."""

    ORDER = 10  # the work order's offset in the spp launchers
    STRIDE = 3  # the keys' stride's offset in vol_path
    KEYS = {}   # data pointer -> int64 keys tensor

    def __init__(self, lib, abi):
        from xraytracer_tpu_torch.integrators import vol_megakernel as vm

        self._calls = {}
        for name, argtypes in vm._ARGTYPES.items():
            k = self.STRIDE if name == "vol_path" else (self.ORDER if abi == 0 else None)
            fn = getattr(lib, name)
            fn.argtypes = argtypes if k is None else argtypes[:k] + argtypes[k + 1:]
            fn.restype = ctypes.c_int
            self._calls[name] = (fn, k)
        self.lib = lib

    def _vol_path(self, fn, o, d, keys, stride, *rest):
        from xraytracer_tpu_torch.integrators import megakernel as mk

        if stride == 1:
            return fn(o, d, keys, *rest)
        k32 = mk._i32_bits(self.KEYS[keys])
        return fn(o, d, k32.data_ptr(), *rest)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._calls:
            return getattr(self.lib, name)
        fn, k = self._calls[name]
        if name == "vol_path":
            return lambda *a: self._vol_path(fn, *a)
        return fn if k is None else (lambda *a: fn(*a[:k], *a[k + 1:]))


def mega_ab_cases(device, ab_, cornell, builds, reps):
    """The whole-path surface kernels' cases of ``phase_csrc_ab``, run
    through its ``ab`` on every megakernel build (``builds``)."""
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.integrators import megakernel as mk
    from xraytracer_tpu_torch.scene.builder import scene_statics
    from xraytracer_tpu_torch.scene.presets import cornell_camera
    from xraytracer_tpu_torch.scene.tables import rejoin_appearance

    cornell_tables, cornell_cam = cornell
    check(get_preset("cornellbox_gi").spp == MAIN_SPP, "cornellbox_gi's spp changed")
    room_in = many_light_scene(device, face_in=True)
    mesh_small, mesh_cam = mesh_scene(device, K1_MESH_SIZE)
    mesh_one, _ = mesh_scene(device, K1_MESH_ONE_GROUP)
    mesh_128, _ = mesh_scene(device, K1_MESH_SMALL)
    turns = MEGA_AB_TURNS

    def ab(*args, **kw):
        ab_(*args, builds=builds, **kw)

    for label, tables, camk, opts, main in (
            ("cornell uniform", cornell_tables, cornell_cam,
             dict(max_depth=DEPTH, cosine_sampling=False), True),
            ("cornell cosine", cornell_tables, cornell_cam,
             dict(max_depth=DEPTH, cosine_sampling=True), False),
            ("mesh %dx%d, T=3072" % K1_MESH_SIZE, mesh_small, mesh_cam,
             dict(max_depth=DEPTH, cosine_sampling=True), False),
            ("mesh %dx%d, T=384" % K1_MESH_ONE_GROUP, mesh_one, mesh_cam,
             dict(max_depth=DEPTH, cosine_sampling=True), False),
            ("mesh %dx%d, T=128" % K1_MESH_SMALL, mesh_128, mesh_cam,
             dict(max_depth=DEPTH, cosine_sampling=True), False),
            ("64 lights facing in, one", room_in, cornell_camera(),
             dict(max_depth=3, cosine_sampling=True, nee_mode="one"), False),
            ("64 lights facing in, power", room_in, cornell_camera(),
             dict(max_depth=3, cosine_sampling=False, nee_mode="power"), False)):
        st = scene_statics(tables)
        cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **camk)
        fs = mk._bake(tables, st, opts["max_depth"], True, True, opts["cosine_sampling"],
                      nee_mode=opts.get("nee_mode", "all"))
        check(fs is not None, f"csrc_ab {label}: not eligible for the fused route")
        view = mk.try_make_fused_spp_render(tables, st, cam, WIDTH, HEIGHT, 0,
                                            nee=True, **opts).view
        keys, o, d = mk._camera_rays_plain(view, 0)
        # launches under a few ms read bimodal between turns: 4x the reps
        ab("mega_path", f"{label}, camera rays", lambda: mk.mega_path(fs, o, d, keys),
           turns=turns, reps_=4 * reps)
        for name in ("mega_spp", "mega_spp_persistent"):
            fn = getattr(mk, name)
            ab(name, f"{label}, {K1_SPP} spp", lambda fn=fn: fn(fs, view, 0, K1_SPP),
               turns=turns, reps_=4 * reps)
        if main:
            ab("mega_spp_persistent", f"{label}, {MAIN_SPP} spp (main path's launch)",
               lambda: mk.mega_spp_persistent(fs, view, 0, MAIN_SPP), reps_=3,
               turns=turns)
    # K5 on the cases of phase_grad_kernels
    for label, tables, camk, opts, albedo, le_scale in grad_cases(
            device, cornell_tables, cornell_cam):
        st = scene_statics(tables)
        f = mk.try_make_fused_grad_path(tables, st, opts["max_depth"], nee=True,
                                        cosine_sampling=opts["cosine_sampling"],
                                        nee_mode=opts["nee_mode"])
        check(f is not None, f"csrc_ab {label}: not eligible for the gradient kernel")
        gs = f.grad_scene
        keys, o, d = sample_rays(camk, device, GRAD_SAMPLE)
        le = tables.al_le * le_scale
        rec = rejoin_appearance(tables._replace(
            mat_albedo=tables.mat_albedo if albedo is None else albedo,
            al_le=le)).tri_rec.contiguous()
        ab("mega_grad_path", label, lambda: mk.mega_grad_path(gs, o, d, keys, rec, le),
           turns=turns, reps_=4 * reps)


def grad_steps_ab(device, cornell, builds, use, turns=4):
    """The gradient routes over K5 by every megakernel build (``builds``,
    bound by ``use``), in turns (the builds in order, then in reverse):
    ``grad_path``'s analytic step (one warm-up step, then GRAD_STEPS timed
    steps: camera rays per second) and ``tools.fit_scene.fit`` (FIT_STEPS
    steps: the median seconds per step), as the default phase runs them."""
    import numpy as np
    import torch

    from xraytracer_tpu_torch import diff
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.renderer import pixel_grid
    from xraytracer_tpu_torch.scene.builder import scene_statics
    from xraytracer_tpu_torch.tools.fit_scene import fit

    tables, camk = cornell
    st = scene_statics(tables)
    cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **camk)
    ids, xy = pixel_grid(WIDTH, HEIGHT, device=device)
    target = torch.zeros((WIDTH * HEIGHT, 3), device=device)
    params = {"mat_albedo": tables.mat_albedo, "al_le": tables.al_le}
    fast = diff.try_make_fast_value_and_grad(tables, st, cam, WIDTH, HEIGHT,
                                             max_depth=DEPTH, nee=True,
                                             cosine_sampling=True)
    check(fast is not None, "csrc_ab grad steps: Cornell did not take the analytic route")
    res = {name: dict(analytic_rays_per_s=[], fit_seconds_per_step=[]) for name in builds}
    for k in range(turns):
        for name in (builds if k % 2 == 0 else builds[::-1]):
            use(name)
            fast(params, ids, xy, target, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for s in range(1, 1 + GRAD_STEPS):
                fast(params, ids, xy, target, s)
            torch.cuda.synchronize()
            res[name]["analytic_rays_per_s"].append(
                WIDTH * HEIGHT * GRAD_STEPS / (time.perf_counter() - t0))
            stats = {}
            fit(width=WIDTH, height=HEIGHT, max_depth=DEPTH, steps=FIT_STEPS,
                spp=FIT_SPP, device="cuda", stats=stats)
            res[name]["fit_seconds_per_step"].append(float(np.median(stats["step_seconds"])))
    medians = {name: {k: sorted(v)[len(v) // 2] for k, v in r.items()}
               for name, r in res.items()}
    emit("csrc_ab_grad_steps", builds=builds, turns=turns, runs=res, median=medians)


def sub_view(view, lanes):
    """The RenderView of a subset of ``view``'s lanes (an index tensor), in
    that order: the same pixels, so the same streams and sums."""
    from xraytracer_tpu_torch.integrators.megakernel import RenderView

    return RenderView(n=int(lanes.shape[0]), cam=view.cam, cam_site=view.cam_site,
                      pixfold=view.pixfold[lanes],
                      pixfold_bits=view.pixfold_bits[lanes].contiguous(),
                      px=view.px[lanes].contiguous(), py=view.py[lanes].contiguous())


def vol_ab_cases(device, ab_, builds, reps):
    """The whole-path volume kernels' cases of ``phase_csrc_ab`` on every
    volume build (``builds``): K6a on the camera rays of sample 0 (vpt with
    and without NEE), K6b and K6c at the vpt preset's own launch (512x512,
    depth 10, 1024 spp), at VPT_NEE_SPP with NEE, at VOL_CHECK_SPP on every
    medium variant with and without NEE and on a box of g = 0.6, K6c at the
    main launch on the lanes whose pixels may reach the box alone and on
    the others alone (``vol_megakernel.reach_cost`` > 0), in two other
    orders, and on morton lanes. Returns what the timelines and the
    instruction count need: the main launch's scene, view and work
    order, and K6a's inputs on vpt mis without and with NEE ({label: (vc,
    o, d, keys)})."""
    import torch

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.integrators import megakernel as mk
    from xraytracer_tpu_torch.integrators import vol_megakernel as vm
    from xraytracer_tpu_torch.scene import presets
    from xraytracer_tpu_torch.scene.builder import scene_statics

    cfg = get_preset("vpt")
    w, h, depth = cfg.width, cfg.height, cfg.max_depth
    cam = PinholeCamera.make(w / h, device=device, **presets.preset_vpt(device=device)[1])
    turns = MEGA_AB_TURNS
    main = None
    paths = {}

    def ab(*args, **kw):
        ab_(*args, builds=builds, **kw)

    for variant, g, nee in (("mis", 0.0, False), ("mis", 0.0, True),
                            ("achromatic", 0.0, False), ("achromatic", 0.0, True),
                            ("nomis", 0.0, False), ("nomis", 0.0, True),
                            ("mis", 0.6, False), ("mis", 0.6, True)):
        label = f"vpt {variant}" + (f" g={g}" if g else "") + (" nee" if nee else "")
        tables = presets.build_vpt_scene(variant, g).build(device)
        st = scene_statics(tables)
        vc = vm._vol_consts(tables, st, depth, nee, None, None)
        check(vc is not None, f"csrc_ab {label}: not eligible for the fused volume route")
        view = vm.try_make_fused_volume_spp_render(tables, st, cam, w, h, 0, depth,
                                                   nee=nee).view
        order = vm.work_order(vc, view)
        keys, o, d = mk._camera_rays_plain(view, 0)
        VolOlderAbi.KEYS[keys.data_ptr()] = keys
        # int64 keys as the renderer passes them, and their int32 bits made
        # beforehand (the launch alone)
        k32 = mk._i32_bits(keys)
        ab("vol_path", f"{label}, camera rays", lambda: vm.vol_path(vc, o, d, keys),
           turns=turns, reps_=4 * reps)
        ab("vol_path", f"{label}, camera rays, int32 keys",
           lambda: vm.vol_path(vc, o, d, k32), turns=turns, reps_=4 * reps)
        if variant == "mis" and not g:
            paths[label] = (vc, o, d, keys)
        spps = [VOL_CHECK_SPP]
        if variant == "mis" and not g:
            spps.append(VPT_NEE_SPP if nee else cfg.spp)
        for n_spp in spps:
            for name in ("vol_spp", "vol_spp_persistent"):
                fn = getattr(vm, name)
                big = n_spp == cfg.spp
                case = f"{label}, {n_spp} spp" + (" (main path's launch)" if big else "")
                ab(name, case, lambda fn=fn, n_spp=n_spp, order=order: fn(
                    vc, view, 0, n_spp, order), turns=turns, reps_=3 if big else 4 * reps)
        if variant == "mis" and not g and not nee:
            main = (vc, view, order)
    vc, view, main_order = main
    reach = vm.reach_cost(vc, view) > 0.0
    long_, short = torch.nonzero(reach).flatten(), torch.nonzero(~reach).flatten()
    for cls, lanes in (("long", long_), ("short", short)):
        sv = sub_view(view, lanes)
        ab("vol_spp_persistent",
           f"vpt mis, {cfg.spp} spp, the {lanes.shape[0]} {cls} lanes alone",
           lambda sv=sv, order=vm.work_order(vc, sv): vm.vol_spp_persistent(
               vc, sv, 0, cfg.spp, order), turns=turns, reps_=3)
    for oname, order in (
            ("lane order", torch.arange(view.n, dtype=torch.int32, device=device)),
            ("long lanes first, each class in lane order",
             torch.cat([long_, short]).to(torch.int32))):
        for name in ("vol_spp", "vol_spp_persistent"):
            ab(name, f"vpt mis, {cfg.spp} spp, {oname}",
               lambda name=name, order=order: vm._vol_spp_launch(
                   name, vc, view, 0, cfg.spp, order),
               turns=turns, reps_=3)
    tables = presets.build_vpt_scene().build(device)
    morton = vm.try_make_fused_volume_spp_render(tables, scene_statics(tables), cam, w, h,
                                                 0, depth, pixel_order="morton").view
    order = vm.work_order(vc, morton)
    ab("vol_spp_persistent", f"vpt mis, {cfg.spp} spp, morton lane order",
       lambda: vm.vol_spp_persistent(vc, morton, 0, cfg.spp, order), turns=turns, reps_=3)
    return vc, view, main_order, paths


# a build that stamps every warp's start and end (csrc/vol_megakernel.cu)
VOL_TIMELINE_FLAGS = ["-DVOL_TIMELINE"]


def vol_timeline(lib, which, run, n_lanes):
    """Run ``run`` once on the timeline build ``lib`` and read each warp's
    start, end (%globaltimer, ns) and SM: over the launch, the mean share of
    the card's warp slots (resident blocks per SM x 4 x SMs) that hold a
    working warp, the share of the launch during which fewer than half do,
    the share after the last warp started, and inside blocks that hold a
    long warp (one that runs more than half the longest) the share of their
    warp slots' time spent finished while a sibling still works."""
    import numpy as np
    import torch

    n_warps = -(-n_lanes // 32)
    fn = lib.vol_timeline
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    occ = lib.vol_occupancy
    occ.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    run()
    torch.cuda.synchronize()
    t = np.zeros(2 * n_warps, np.uint64)
    sm = np.zeros(n_warps, np.uint32)
    check(fn(t.ctypes.data, sm.ctypes.data, n_warps) == 0, "vol_timeline failed")
    blocks = ctypes.c_int()
    check(occ(which, ctypes.byref(blocks)) == 0, "vol_occupancy failed")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cap = blocks.value * 4 * n_sm
    s, e = t[0::2].astype(np.int64), t[1::2].astype(np.int64)
    t0, t1 = int(s.min()), int(e.max())
    grid = np.linspace(t0, t1, 4001)[:-1] + (t1 - t0) / 8000.0
    starts, ends = np.sort(s), np.sort(e)
    active = np.searchsorted(starts, grid, "right") - np.searchsorted(ends, grid, "right")
    dur = e - s
    nb = n_warps // 4
    bs, be = s[:4 * nb].reshape(nb, 4), e[:4 * nb].reshape(nb, 4)
    bdur = be - bs
    long_b = bdur.max(axis=1) > dur.max() / 2
    span = be.max(axis=1, keepdims=True) - bs.min(axis=1, keepdims=True)
    idle = (be.max(axis=1, keepdims=True) - be)[long_b].sum()
    after_last = float((t1 - s.max()) / (t1 - t0))
    return dict(
        launch_ms=(t1 - t0) / 1e6, warps=n_warps, blocks_per_sm=blocks.value,
        sms=n_sm, warp_slots=cap, sms_used=int(len(np.unique(sm))),
        slot_use_mean=float(active.mean() / cap),
        share_below_half=float((active < cap / 2).mean()),
        share_after_last_start=after_last,
        slot_use_after_last_start=float(active[grid > s.max()].mean() / cap)
        if (grid > s.max()).any() else None,
        long_blocks=int(long_b.sum()),
        long_block_idle_share=float(idle / (4 * span[long_b]).sum()) if long_b.any() else 0.0,
        warp_ms_percentiles={str(q): float(np.percentile(dur, q) / 1e6)
                             for q in (5, 25, 50, 75, 95, 100)})


def vol_sass_regions(src):
    """Compile ``src`` (vol_megakernel.cu) with line information into a
    cubin and count each kernel's SASS instructions by region of
    ``vol_path.cuh`` (the "// sass: NAME" markers; an instruction counts in
    the region of the innermost vol_path.cuh line of its inlining chain, an
    intersection also by the region that called it). Static counts: an
    inlined copy counts each time it appears."""
    from xraytracer_tpu_torch import _build

    out = os.path.join(_build.BUILD_DIR, "vol_megakernel_lineinfo.cubin")
    nvcc = _build.find_nvcc()
    flags_c = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([nvcc, *flags_c, "-cubin", "-lineinfo", "-o", out, src],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"cubin build failed:\n{proc.stderr}")
    nvdisasm = os.path.join(os.path.dirname(nvcc), "nvdisasm")
    proc = subprocess.run([nvdisasm, "-gi", out], capture_output=True, text=True)
    check(proc.returncode == 0, f"nvdisasm failed:\n{proc.stderr}")
    with open(out + ".sass", "w") as f:
        f.write(proc.stdout)
    return sass_region_counts(proc.stdout, os.path.join(os.path.dirname(src), "vol_path.cuh"))


def vol_slot_bound(regions, stats, scale, nee, n_tris):
    """An instruction-slot figure for the iterations of a whole-path volume
    launch: each region of ``vol_bounce`` (``sass_region_counts``; the
    sample loops and the kernel's own code are left out) at its static
    instruction count times the times a lane runs it (the plain version's
    counters on the same lanes, ``stats``, at ``scale`` times fewer
    samples), over 32 lanes a warp instruction, at four warp instructions
    per SM and clock at the card's top SM clock. The triangle loop's region
    (its head and its body) runs ``n_tris`` times an intersection; it must
    be a rolled loop, as the package builds it. Every other region counts
    whole each time (untaken sub-branches, the accurate transcendentals'
    slow paths), and warps are taken as converged."""
    import torch

    rays = int(stats["rays"].sum()) * scale
    medium = int(stats["active_out"].sum()) * scale
    scattered = int(stats["scattered"].sum()) * scale
    shadow = scattered if nee else 0
    visits = {"bounce": rays, "intersect from bounce": rays,
              "triangle loop from bounce": rays * n_tris, "roulette and emitter": rays,
              "medium sample": medium, "escape weight": medium - scattered,
              "scatter weight": scattered, "advance": medium,
              "next-event estimation": shadow, "intersect from next-event estimation": shadow,
              "triangle loop from next-event estimation": shadow * n_tris}
    warp_instr = {r: regions.get(r, 0) * v / 32.0 for r, v in visits.items()}
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    total = sum(warp_instr.values())
    return dict(iterations=rays, medium_samples=medium, scattered=scattered,
                warp_instructions=total, sm_clock_mhz=mhz, sms=n_sm,
                slot_bound_ms=total / (4 * n_sm * mhz * 1e6) * 1e3,
                share_by_region={r: v / total for r, v in warp_instr.items()})


# the regions of vol_path.cuh's intersect, each counted also by its caller
INTERSECT_REGIONS = ("intersect", "triangle loop")


def sass_region_counts(text, marked):
    """Instructions per kernel and region of ``nvdisasm -gi`` output
    ``text``: each instruction counts in the region (a "// sass: NAME"
    marker of the source ``marked``) of the innermost line of ``marked`` in
    its inlining chain (the "//##" lines above it, innermost first); an
    intersection's regions (INTERSECT_REGIONS) count also by the region
    that called it."""
    import re

    marks = {}
    with open(marked) as f:
        region = "head"
        for k, ln in enumerate(f, start=1):
            m = re.match(r"\s*// sass: (.+)", ln)
            if m:
                region = m.group(1).strip()
            marks[k] = region
    name = os.path.basename(marked)
    counts, kernel, chain, fresh = {}, None, [], True
    for ln in text.splitlines():
        m = re.match(r"\s*\.text\.(\w+):", ln)
        if m:
            kernel = next((k for k in ("vol_path_kernel", "vol_spp_persistent_kernel",
                                       "vol_spp_kernel") if k in m.group(1)), m.group(1))
            counts.setdefault(kernel, {})
            chain, fresh = [], True
            continue
        if "//##" in ln:
            if fresh:
                chain, fresh = [], False
            chain += re.findall(r'"([^"]+)",\s*line (\d+)', ln)
            continue
        if kernel is None or not re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", ln):
            continue
        fresh = True
        frames = [marks.get(int(n)) for f_, n in chain if f_.endswith(name)]
        frames = [r for r in frames if r]
        region = frames[0] if frames else "outside " + name
        if region in INTERSECT_REGIONS:
            region += " from " + next((r for r in frames[1:] if r not in INTERSECT_REGIONS),
                                      "kernel")
        counts[kernel][region] = counts[kernel].get(region, 0) + 1
    return {k: dict(total=sum(v.values()), **v) for k, v in counts.items() if v}


def phase_csrc_ab(device, nee_scene, volume_scene, others, reps):
    """Other builds of the sources (``others``: {name: a directory holding
    another copy of csrc/, e.g. the parent commit's}) against the package's
    own, in one call on one card: outputs compared lane by lane (bitwise;
    K10's grid, summed by atomics, by its largest difference), and every
    build timed in turns (the builds in order, then in reverse).

    The sweeps (K2-K4, from every build whose sweep sources differ; one from
    before the chunk table is called through ``BruteForceSweeps``): on the
    Cornell table's camera and depth-0 shadow rays, the 13k mesh's camera,
    depth-1 bounce and depth-0 shadow rays, and the camera and depth-0
    shadow rays of the 51k mesh, each captured from one sample of the
    wavefront route; the package's build is also held against the plain
    versions there (on the 51k mesh on its first MESH51_PLAIN_RAYS rays),
    and each case's culled and brute-force bounds are counted as the
    default phase counts them.

    The tracking kernels (K7, K8) and the heterogeneous whole-path and
    gradient kernels (K9a-c, K10), from every build whose sources of them
    differ: on the nee and volume presets at AB_SPP samples per pixel, at
    their main paths' full spp chunks, on the camera rays of sample 0
    (K9a), on the nee preset's captured tracking inputs (K7, K8), and K9a
    (pass A) and K10 at K10's three shapes (the nee frame,
    tools.fit_volume's first view, the 16^3 cloud) on the dense and the
    packed live grid, with step_pair's two streams at the view as two
    launches and as one. pack_corners is the package's in every build.

    The whole-path surface kernels (K1a-c, K5), from every build whose
    sources of them differ: K1a on the camera rays of sample 0, K1b and
    K1c at K1_SPP samples per pixel, on Cornell (uniform and cosine), the
    3,072-, 384- and 128-row meshes and the 64-light rooms facing in
    (``one``, ``power``; all culled),
    K1c at the main path's own launch (Cornell uniform, MAIN_SPP samples,
    one chunk), and K5 on the cases of its default phase (``grad_cases``);
    sums, rejection counts, K1a's radiance and K5's planes compared
    bitwise, each case timed in MEGA_AB_TURNS turns; then the analytic
    gradient step and the trainer over each build (``grad_steps_ab``).

    The whole-path volume kernels (K6a-c), from every build whose sources
    of them differ (``vol_ab_cases``): sums, rejection counts and K6a's
    radiance bitwise, MEGA_AB_TURNS turns (K6a with the int64 keys the
    renderer passes and with their int32 bits made beforehand); then the
    package's timeline build (VOL_TIMELINE) on K6c and K6b at the vpt
    launch and on K6a on the camera rays of vpt mis without and with NEE,
    with an empty launch of K6a's grid and of the card's resident grid
    (``vol_timeline``), the package's SASS by region of ``vol_path.cuh``
    (``vol_sass_regions``) and the instruction-slot figure of K6c's
    iterations (``vol_slot_bound``).
    Each section runs only where some build differs from the package
    there."""
    import torch

    from xraytracer_tpu_torch import _build, cli
    from xraytracer_tpu_torch import media_kernels as mkk
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.geometry import kernels
    from xraytracer_tpu_torch.integrators import het_megakernel as hk
    from xraytracer_tpu_torch.integrators import make_path_integrator, make_volume_integrator
    from xraytracer_tpu_torch.integrators import megakernel as mk
    from xraytracer_tpu_torch.integrators import vol_megakernel as vm
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics
    from xraytracer_tpu_torch.tools import fit_volume

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    dirs = {"package": _build.CSRC_DIR, **others}
    sweep_names = ["package"] + [n for n, d in others.items()
                                 if sources_differ(d, SWEEP_SOURCES)]
    names = ["package"] + [n for n, d in others.items() if sources_differ(d, TRACK_SOURCES)]
    mega_names = ["package"] + [n for n, d in others.items()
                                if sources_differ(d, MEGA_SOURCES)]
    vol_src = os.path.join(_build.CSRC_DIR, "vol_megakernel.cu")
    # the volume builds: those whose sources differ, and the package's
    # timeline build
    vol_flags = {}
    vol_names = ["package"] + [n for n, d in others.items()
                               if sources_differ(d, VOL_SOURCES)]
    if len(vol_names) > 1:
        vol_flags["timeline"] = VOL_TIMELINE_FLAGS
        vol_names.append("timeline")
        dirs["timeline"] = _build.CSRC_DIR
    built = build_sources(
        [(f"ab_{name}_sweep", os.path.join(dirs[name], "sweep.cu"), [])
         for name in sweep_names]
        + [(f"ab_{name}_{lib}", os.path.join(dirs[name], f"{lib}.cu"), [])
           for name in names for lib in ("media", "het_megakernel")]
        + [(f"ab_{name}_megakernel", os.path.join(dirs[name], "megakernel.cu"), [])
           for name in mega_names]
        + [(f"ab_{name}_vol_megakernel", os.path.join(dirs[name], "vol_megakernel.cu"),
            vol_flags.get(name, [])) for name in vol_names])
    vol_libs = {name: bind_vol(ctypes.CDLL(built[f"ab_{name}_vol_megakernel"][0]))
                for name in vol_names}
    mega_libs = {name: bind_mega(ctypes.CDLL(built[f"ab_{name}_megakernel"][0]))
                 for name in mega_names}
    package_sweep = kernels._bind(ctypes.CDLL(built["ab_package_sweep"][0]))
    sweep_libs = {}
    for name in sweep_names:
        lib = ctypes.CDLL(built[f"ab_{name}_sweep"][0])
        sweep_libs[name] = (kernels._bind(lib) if hasattr(lib, "chunk_boxes")
                            else BruteForceSweeps(lib, package_sweep))
    # the tracking launchers of every build (pack_corners stays the
    # package's: an older media.cu may lack it)
    libs = {name: (bind_launchers(mkk, ctypes.CDLL(built[f"ab_{name}_media"][0]),
                                  ("track_sample", "track_transmittance")),
                   hk._bind(ctypes.CDLL(built[f"ab_{name}_het_megakernel"][0])))
            for name in names}
    ptxas = {name: {} for name in dirs}
    for tag, (_, table) in built.items():
        ptxas[next(n for n in dirs if tag.startswith(f"ab_{n}_"))].update(table)
    package_libs = mkk._lib, hk._lib, kernels._lib, mk._lib, vm._lib
    rows = []

    def use(name):
        kernels._lib = lambda lib=sweep_libs.get(name, package_sweep): lib
        if name in libs:
            mkk._lib = lambda lib=libs[name][0]: lib
            hk._lib = lambda lib=libs[name][1]: lib
        if name in mega_libs:
            mk._lib = lambda lib=mega_libs[name]: lib
        if name in vol_libs:
            vm._lib = lambda lib=vol_libs[name]: lib

    def pack(grid):
        mkk._lib = package_libs[0]
        return mkk.pack_corners(grid)

    def ab(kernel, case, run, exact=True, time_it=True, builds=None, reps_=None,
           turns=2):
        """Run ``run`` on every build (or on ``builds``): outputs vs the
        package's (lanes that differ, or the largest difference), then
        times in ``turns`` turns (the builds in order, then in reverse,
        and so on); ``median_ms`` per build is the median of its turns."""
        row = dict(kernel=kernel, case=case)
        ref = None
        differ = {}
        order = builds or names
        for name in order:
            use(name)
            out = run()
            torch.cuda.synchronize()
            out = [o.reshape(o.shape[0], -1) for o in (out if isinstance(out, tuple) else (out,))]
            if ref is None:
                ref = out
                continue
            if exact:
                bad = torch.zeros(out[0].shape[0], dtype=torch.bool, device=device)
                for a, b in zip(out, ref):
                    bad |= (a != b).any(dim=1)
                idx = torch.nonzero(bad)[:8, 0].tolist()
                differ[name] = dict(lanes=int(bad.sum()), first=idx,
                                    max_abs=max(float(torch.abs(a.float() - b.float()).max())
                                                for a, b in zip(out, ref)))
            else:
                differ[name] = dict(max_abs=max(float(torch.abs(a - b).max())
                                                for a, b in zip(out, ref)),
                                    scale=float(torch.abs(ref[-1]).max()))
        row["vs_package"] = differ
        if time_it:
            ms = {name: [] for name in order}
            for k in range(turns):
                for name in (order if k % 2 == 0 else order[::-1]):
                    use(name)
                    ms[name].append(median_ms(run, reps_ or reps, flush))
            row["ms"] = ms
            row["median_ms"] = {name: sorted(v)[len(v) // 2] for name, v in ms.items()}
        rows.append(row)
        emit("csrc_ab_case", **row)

    def set_table(v0, e1, e2, mask):
        for lib in sweep_libs.values():
            if isinstance(lib, BruteForceSweeps):
                lib.table = (v0.data_ptr(), e1.data_ptr(), e2.data_ptr(),
                             mask.view(torch.uint8).data_ptr())

    try:
        use("package")
        cornell = cli.build_scene(get_preset("cornellbox_gi", width=WIDTH, height=HEIGHT),
                                  device=device)
        if len(mega_names) > 1:
            mega_ab_cases(device, ab, cornell, mega_names, reps)
            grad_steps_ab(device, cornell, mega_names, use)
        if len(vol_names) > 1:
            vc, view, order, paths = vol_ab_cases(device, ab, vol_names, reps)
            cfg = get_preset("vpt")
            for which, name in ((2, "vol_spp_persistent"), (1, "vol_spp")):
                use("timeline")
                fn = getattr(vm, name)
                emit("vol_timeline", kernel=name, case=f"vpt mis, {cfg.spp} spp",
                     **vol_timeline(vol_libs["timeline"], which,
                                    lambda: fn(vc, view, 0, cfg.spp, order), view.n))
            # K6a on the camera rays of sample 0, and an empty launch of its grid
            tl = vol_libs["timeline"]
            tl.vol_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
            tl.vol_empty.restype = ctypes.c_int
            for label, (pvc, o, d, keys) in paths.items():
                use("timeline")
                tlr = vol_timeline(tl, 0, lambda: vm.vol_path(pvc, o, d, keys), o.shape[0])
                # an empty launch of one thread per ray, and of the grid the
                # card keeps resident
                empty = {}
                for what, lanes in (("one_per_ray", o.shape[0]),
                                    ("resident", tlr["blocks_per_sm"] * tlr["sms"] * 128)):
                    empty[what] = median_ms(
                        lambda lanes=lanes: check(tl.vol_empty(lanes, kernels._stream()) == 0,
                                                  "vol_empty launch failed"), 4 * reps, flush)
                emit("vol_timeline", kernel="vol_path", case=f"{label}, camera rays",
                     **tlr, empty_launch_ms=empty)
            use("package")
            regions = vol_sass_regions(vol_src)
            emit("vol_sass", source="package", regions=regions)
            stats = {}
            vm.vol_spp_plain(vc, view, 0, VOL_CHECK_SPP, stats, VOL_CHECK_SPP)
            emit("vol_slot_bound", kernel="vol_spp_persistent", case=f"vpt mis, {cfg.spp} spp",
                 **vol_slot_bound(regions["vol_spp_persistent_kernel"], stats,
                                   cfg.spp / VOL_CHECK_SPP, nee=False,
                                   n_tris=int(vc.ic[0])))
        # the sweeps, on rays captured from one sample of the wavefront route
        for label, (tables, camk), cosine, which in (() if len(sweep_names) == 1 else (
                ("cornell", cornell, False, ("camera", "shadow")),
                ("mesh13k", mesh_scene(device), True, ("camera", "bounce", "shadow")),
                ("mesh51k", mesh_scene(device, MESH51_SIZE), True, ("camera", "shadow")))):
            st = scene_statics(tables)
            cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **camk)
            integ = make_path_integrator(tables, st, DEPTH, nee=True, cosine_sampling=cosine,
                                         fused="never")
            use("package")
            got = capture_sweep_inputs(WavefrontRenderer(tables, cam, integ, WIDTH, HEIGHT,
                                                         seed=0))
            v0, e1, e2, rec = tables.tri_v0, tables.tri_e1, tables.tri_e2, tables.tri_rec
            valid = tables.tri_obj >= 0
            light = tables.obj_light[torch.clamp(tables.tri_obj, min=0).to(torch.int64)]
            blocks = valid & (light < 0)
            k = MESH51_PLAIN_RAYS if label == "mesh51k" else None
            tri_bytes = v0.shape[0] * (36 + 1) + 12
            # Cornell's launches (~0.05 ms) spread more: 4x the reps
            rr = 4 * reps if label == "cornell" else None
            t_rows = f"T={v0.shape[0]}"
            for w in which:
                if w == "shadow":
                    o, d, tm = got["shadow"][0]
                    case = f"{label} depth-0 shadow rays, {t_rows}"
                    set_table(v0, e1, e2, blocks)
                    ab("occluded_anyhit", case,
                       lambda: kernels.occluded_anyhit(o, d, v0, e1, e2, blocks, tm),
                       builds=sweep_names, reps_=rr)
                    use("package")
                    mine = kernels.occluded_anyhit(o[:k], d[:k], v0, e1, e2, blocks, tm[:k])
                    ref = kernels.occluded_anyhit_plain(o[:k], d[:k], v0, e1, e2, blocks,
                                                        tm[:k])
                    mism = int((mine != ref).sum())
                    check(mism <= max(1, BLOCKED_MISMATCH_SHARE * mine.shape[0]),
                          f"csrc_ab {case}: {mism} blocked flags differ from the plain version")
                    n_bytes = o.shape[0] * (24 + 4 + 1) + tri_bytes
                    tests, slabs = culled_tests_needed(o, d, v0, e1, e2, blocks, tm)
                    b_ms, b_by = bound_ms(
                        n_bytes, tests * FLOPS_PER_ANYHIT_TEST + slabs * FLOPS_PER_SLAB, 1)
                    emit("csrc_ab_bound", kernel="occluded_anyhit", case=case,
                         tests_needed=tests, slabs_needed=slabs, bound_ms=b_ms, bound_by=b_by,
                         brute_bound_ms=bound_ms(n_bytes, anyhit_tests_needed(
                             o, d, v0, e1, e2, blocks, tm), FLOPS_PER_ANYHIT_TEST)[0])
                    emit("csrc_ab_plain", kernel="occluded_anyhit", case=case,
                         n=mine.shape[0], blocked_mismatch=mism)
                    continue
                o, d = got["nearest"][0 if w == "camera" else 1]
                case = f"{label} depth-{0 if w == 'camera' else 1} {w} rays, {t_rows}"
                set_table(v0, e1, e2, valid)
                for name in (("sweep_nearest", "sweep_nearest_rec") if w == "camera"
                             else ("sweep_nearest_rec",)):
                    if name == "sweep_nearest":
                        run = lambda: kernels.sweep_nearest(o, d, v0, e1, e2, valid)
                    else:
                        run = lambda: kernels.sweep_nearest_rec(o, d, v0, e1, e2, valid, rec)
                    ab(name, case, run, builds=sweep_names, reps_=rr)
                n, n_tri = o.shape[0], v0.shape[0]
                tests, slabs = culled_tests_needed(o, d, v0, e1, e2, valid)
                for name, n_bytes in (("sweep_nearest", n * (24 + 16) + tri_bytes),
                                      ("sweep_nearest_rec",
                                       n * (24 + 16 + 128) + tri_bytes + n_tri * 128)):
                    b_ms, b_by = bound_ms(
                        n_bytes, tests * FLOPS_PER_TEST + slabs * FLOPS_PER_SLAB, 1)
                    emit("csrc_ab_bound", kernel=name, case=case, tests_needed=tests,
                         slabs_needed=slabs, bound_ms=b_ms, bound_by=b_by,
                         brute_bound_ms=bound_ms(n_bytes, n * n_tri, FLOPS_PER_TEST)[0])
                use("package")
                mine = kernels.sweep_nearest_rec(o[:k], d[:k], v0, e1, e2, valid, rec)
                ref = kernels.sweep_nearest_rec_plain(o[:k], d[:k], v0, e1, e2, valid, rec)
                emit("csrc_ab_plain", kernel="sweep_nearest_rec", case=case,
                     **compare_nearest(mine, ref, True))

        if len(names) > 1:
            ncfg = get_preset("nee")
            for label, (tables, camk), cfg, depth in (
                    ("nee", nee_scene, ncfg, ncfg.max_depth),
                    ("volume", volume_scene, get_preset("volume"), get_preset("volume").max_depth),
                    ("8 lights nee", (eight_light_cloud(device), nee_scene[1]), ncfg,
                     HET_LIGHTS_DEPTH)):
                nee = label != "volume"
                st = scene_statics(tables)
                hc = hk._het_consts(tables, st, depth, nee, None, None)
                cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **camk)
                view = hk.try_make_fused_het_spp_render(
                    tables, st, cam, cfg.width, cfg.height, 0, depth, nee=nee).view
                keys, o, d = mk._camera_rays_plain(view, 0)
                ab("het_path", f"{label}, camera rays", lambda: hk.het_path(hc, o, d, keys))
                for name in ("het_spp", "het_spp_persistent"):
                    fn = getattr(hk, name)
                    ab(name, f"{label}, {HET_CHECK_SPP} spp",
                       lambda fn=fn: fn(hc, view, 0, HET_CHECK_SPP), time_it=False)
                    if label != "8 lights nee":
                        ab(name, f"{label}, {AB_SPP} spp", lambda fn=fn: fn(hc, view, 0, AB_SPP))
                if label != "8 lights nee":
                    # the main path's whole chunk: the package and the first
                    # other build only, one timed launch per turn
                    full = cfg.spp
                    ab("het_spp_persistent", f"{label}, {full} spp (main path's chunk)",
                       lambda: hk.het_spp_persistent(hc, view, 0, full),
                       builds=names[:2], reps_=1)

            # K9a (pass A) and K10 at K10's three shapes: the nee frame at a zero
            # target, tools.fit_volume's first view (96x72, depth 6, blob grid)
            # and the 16^3 cloud (16x12, depth 3), at a target of 0.6 x the image
            # + 0.02 (every lane's residual non-zero); each on the live grid by
            # eight corner loads ("dense") and by its corner table ("packed"):
            # radiance and Le planes exact, the grid to its atomics' order
            tables, camk = nee_scene
            fw, fh = 96, 72
            ftables = fit_volume.build_scene(device)
            fcam = fit_volume._cameras(fw, fh, device)[0]
            ctables, ccamk, cgrid = grad_cloud_scene(device)
            shapes = (
                (f"nee {ncfg.width}x{ncfg.height}, zero target", tables,
                 PinholeCamera.make(ncfg.width / ncfg.height, device=device, **camk),
                 ncfg.width, ncfg.height, ncfg.max_depth, None, tables.grid_density.contiguous()),
                (f"fit_volume view 0, {fw}x{fh}", ftables, fcam, fw, fh, fit_volume.MAX_DEPTH,
                 None, torch.from_numpy(fit_volume._blob_target()).to(device)),
                ("16^3 cloud 16x12 d3", ctables,
                 PinholeCamera.make(16 / 12, device=device, **ccamk), 16, 12, 3, 32, cgrid))
            mkk._lib = package_libs[0]
            check_pack_corners(device, {s_[0]: (s_[7], s_[1].grid_packed if s_[1] is not ftables else None)
                                        for s_ in shapes}, reps, flush)
            for label, gtables, gcam, w, h, depth, max_steps, grid in shapes:
                hg = hk._het_consts(gtables, scene_statics(gtables), depth, True, max_steps, None,
                                    grad_sampling=True)
                ids, xy = window_pixels(w, h, None, device)
                n = int(ids.shape[0])
                gkeys, go, gd = het_grad_rays(gcam, w, h, ids, xy, 0, 0)
                packed = pack(grid)
                use("package")
                img_a = hk.het_path(hg, go, gd, gkeys, density=grid)
                tgt = torch.zeros_like(img_a) if label.startswith("nee") else img_a * 0.6 + 0.02
                rfac = (2.0 * (img_a - tgt) / (n * 3)).contiguous()
                # the small shapes' launches (under 1 ms) spread more: 4x the reps
                rr = reps if label.startswith("nee") else 4 * reps
                for mode, pk in (("dense", None), ("packed", packed)):
                    ab("het_path", f"{label}, pass A, {mode}",
                       lambda: hk.het_path(hg, go, gd, gkeys, density=grid, packed=pk), reps_=rr)
                    ab("het_grad_path", f"{label}, {mode}: image, Le planes",
                       lambda: hk.het_grad_path(hg, go, gd, gkeys, img_a, rfac, grid, packed=pk)[:2],
                       reps_=rr)
                    ab("het_grad_path", f"{label}, {mode}: gradient grid",
                       lambda: hk.het_grad_path(hg, go, gd, gkeys, img_a, rfac, grid,
                                                packed=pk)[2],
                       exact=False, time_it=False)
                if not label.startswith("fit_volume"):
                    continue
                # step_pair's two streams (seed 0, sample 0; seed 7919, sample 1)
                # at this view: two launches of N against one launch of 2N
                bkeys, bo, bd = het_grad_rays(gcam, w, h, ids, xy, 7919, 1)
                img_b = hk.het_path(hg, bo, bd, bkeys, density=grid)
                rfac_b = (2.0 * (img_b - tgt) / (n * 3)).contiguous()
                cat = [torch.cat(p).contiguous() for p in
                       ((go, bo), (gd, bd), (gkeys, bkeys), (img_a, img_b), (rfac, rfac_b))]
                for mode, pk in (("dense", None), ("packed", packed)):
                    ab("het_path", f"{label}, two streams, 2 launches of N, {mode}",
                       lambda: torch.cat([hk.het_path(hg, go, gd, gkeys, density=grid, packed=pk),
                                          hk.het_path(hg, bo, bd, bkeys, density=grid, packed=pk)]),
                       reps_=rr)
                    ab("het_path", f"{label}, two streams, 1 launch of 2N, {mode}",
                       lambda: hk.het_path(hg, *cat[:3], density=grid, packed=pk), reps_=rr)
                    ab("het_grad_path", f"{label}, two streams, 2 launches of N, {mode}",
                       lambda: hk.het_grad_path(hg, go, gd, gkeys, img_a, rfac, grid, packed=pk)[2]
                       + hk.het_grad_path(hg, bo, bd, bkeys, img_b, rfac_b, grid, packed=pk)[2],
                       exact=False, reps_=rr)
                    ab("het_grad_path", f"{label}, two streams, 1 launch of 2N, {mode}",
                       lambda: hk.het_grad_path(hg, *cat, grid, packed=pk)[2], exact=False,
                       reps_=rr)

            # K7, K8 on the nee preset's captured tracking inputs
            use("package")
            integ = make_volume_integrator(tables, scene_statics(tables), ncfg.max_depth,
                                           nee=True, with_stats=True)
            got = capture_tracking_inputs(
                WavefrontRenderer(tables, shapes[0][2], integ, ncfg.width, ncfg.height, seed=0),
                CAPTURE_ITERATIONS)
            for it, args in zip(CAPTURE_ITERATIONS, got["track_sample"]):
                ab("track_sample", f"nee iteration {it}",
                   lambda args=args: tuple(x.float() for x in mkk.track_sample(*args)))
            for it, args in zip(CAPTURE_ITERATIONS, got["track_transmittance"]):
                ab("track_transmittance", f"nee iteration {it} NEE segments",
                   lambda args=args: mkk.track_transmittance(*args))
    finally:
        mkk._lib, hk._lib, kernels._lib, mk._lib, vm._lib = package_libs
    emit("csrc_ab", builds=dirs, sweep_builds=sweep_names, tracking_builds=names,
         mega_builds=mega_names, vol_builds=vol_names, ptxas=ptxas, reps=reps,
         cases=len(rows))


def phase_het_entry_points(device, nee_scene, main_image_mean):
    """het_path and het_spp through their entry points at the nee preset's
    width and depth: ``try_make_fused_het_path_integrator`` under the
    per-sample renderer (one launch per sample), and the ``fused_spec`` with
    ``persistent=False`` under the renderer's chunk runner (one launch per
    chunk). Returns the run's launch counts."""
    import numpy as np

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.integrators import make_volume_integrator
    from xraytracer_tpu_torch.integrators.het_megakernel import (
        try_make_fused_het_path_integrator,
    )
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    cfg = get_preset("nee")
    tables, camk = nee_scene
    statics = scene_statics(tables)
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **camk)
    per_sample = try_make_fused_het_path_integrator(tables, statics, cfg.max_depth,
                                                    nee=True)
    check(per_sample is not None, "het_entry_points: scene not eligible")
    chunked = make_volume_integrator(tables, statics, cfg.max_depth, nee=True)
    chunked.fused_spec = dict(chunked.fused_spec, persistent=False)
    merged = make_volume_integrator(tables, statics, cfg.max_depth, nee=True)
    renderers = [WavefrontRenderer(tables, cam, integ, cfg.width, cfg.height,
                                   seed=cfg.seed)
                 for integ in (per_sample, chunked, merged)]
    reset_all_counts()
    res_a = renderers[0].render(HET_ENTRY_SPP)
    res_b = renderers[1].render(HET_ENTRY_SPP)
    counts = all_counts()
    res_c = renderers[2].render(HET_ENTRY_SPP)  # het_spp_persistent, to compare
    for name, want in (("het_path", HET_ENTRY_SPP), ("het_spp", 1)):
        check(counts[name]["launches"] == want,
              f"het_entry_points: {name} launched {counts[name]['launches']}x, "
              f"expected {want}")
    check(sum(c["launches"] for c in counts.values()) == HET_ENTRY_SPP + 1,
          "het_entry_points: another kernel was launched")
    check(sum(c["plain_calls"] for c in counts.values()) == 0,
          "het_entry_points: plain-version calls on the card")
    check(res_a.n_rejected == 0 and res_b.n_rejected == 0,
          "het_entry_points: rejected samples")
    check(bool(np.array_equal(res_b.image, res_c.image)),
          "het_entry_points: het_spp and het_spp_persistent images differ")
    # the per-sample route takes the wavefront renderer's camera ray
    # (division by the width)
    diff = np.abs(res_a.image - res_c.image)
    n_diff = int((diff > K1_ATOL + K1_RTOL * np.abs(res_c.image)).any(axis=-1).sum())
    check(n_diff <= K1_PIXEL_DIFF_SHARE * cfg.width * cfg.height,
          f"het_entry_points: het_path route differs from the whole-render "
          f"kernel on {n_diff} pixels")
    m = float(res_a.image.mean())
    check(abs(m - main_image_mean) <= MEAN_BAND_FULL_VS_REF * main_image_mean,
          f"het_entry_points: mean {m} vs nee_path {main_image_mean}")
    emit("het_entry_points", preset="nee", spp=HET_ENTRY_SPP,
         het_path=dict(seconds=res_a.seconds,
                       msamples_per_s=res_a.samples_per_sec / 1e6,
                       launches=counts["het_path"]["launches"]),
         het_spp=dict(seconds=res_b.seconds,
                      msamples_per_s=res_b.samples_per_sec / 1e6,
                      launches=counts["het_spp"]["launches"]),
         het_spp_vs_persistent_bitwise_equal=True,
         het_path_vs_persistent_pixels_beyond_gate=n_diff,
         het_path_vs_persistent_max_abs_diff=float(diff.max()),
         mean_radiance=m)
    return counts


def phase_nee_wavefront(device, nee_scene, nee_image_mean):
    """The nee preset at full width and depth by the wavefront volume route
    (``with_stats=True`` keeps it): 2 * max_depth + 2 iterations per sample,
    each with the record sweep twice (bounce and shadow rays) and the two
    tracking kernels once. Returns the run's launch counts."""
    import numpy as np

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.integrators import make_volume_integrator
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    cfg = get_preset("nee")
    tables, camk = nee_scene
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **camk)
    integ = make_volume_integrator(tables, scene_statics(tables), cfg.max_depth,
                                   nee=True, with_stats=True)
    check(getattr(integ, "fused_spec", None) is None,
          "nee_wavefront_path: with_stats took a fused route")
    renderer = WavefrontRenderer(tables, cam, integ, cfg.width, cfg.height, seed=0)
    renderer.render(1)  # warm-up
    reset_all_counts()
    result = renderer.render(NEE_WAVEFRONT_SPP)
    counts = all_counts()
    iters = NEE_WAVEFRONT_SPP * (2 * cfg.max_depth + 2)
    expected = {"track_sample": iters, "track_transmittance": iters,
                "sweep_nearest_rec": 2 * iters, "chunk_boxes": chunk_builds(tables, 1)}
    check(result.image.shape == (cfg.height, cfg.width, 3), "nee_wavefront_path: shape")
    check(bool(np.isfinite(result.image).all()), "nee_wavefront_path: non-finite pixels")
    check(result.n_rejected == 0, f"nee_wavefront_path: {result.n_rejected} rejected")
    for name, c in counts.items():
        check(c["launches"] == expected.get(name, 0),
              f"nee_wavefront_path: {name} launched {c['launches']}x, "
              f"expected {expected.get(name, 0)}")
    plain_calls = sum(c["plain_calls"] for c in counts.values())
    check(plain_calls == 0, f"nee_wavefront_path: {plain_calls} plain-version calls")
    m = float(result.image.mean())
    band = VOLUME_MEAN_BAND["nee_wavefront_path"]
    check(abs(m - nee_image_mean) <= band * nee_image_mean,
          f"nee_wavefront_path: mean {m} vs nee_path {nee_image_mean}")
    emit("nee_wavefront_path", preset="nee", integrator=cfg.integrator,
         route="wavefront (track_sample + track_transmittance, with_stats)",
         width=cfg.width, height=cfg.height, depth=cfg.max_depth,
         spp=NEE_WAVEFRONT_SPP, preset_spp=cfg.spp,
         spp_cut=f"cut from {cfg.spp} to {NEE_WAVEFRONT_SPP}",
         seconds=result.seconds, msamples_per_s=result.samples_per_sec / 1e6,
         total_rays=result.total_rays, n_rejected=result.n_rejected,
         mean_radiance=m, nee_path_mean=nee_image_mean, mean_band=band,
         rays=result.stats["rays"].tolist(),
         scattered=result.stats["scattered"].tolist(),
         launches={k: v["launches"] for k, v in counts.items() if v["launches"]},
         plain_calls=plain_calls)
    return counts


def phase_cloud_golden(device):
    """The CPU golden of the heterogeneous NEE integrator
    (tests/golden/cloud_nee_24x18_4spp_seed0.npy), reproduced on the card by
    the default route (the whole-render kernel ``het_spp_persistent``) and
    by the wavefront route (``with_stats=True``) through both tracking
    kernels."""
    import numpy as np
    import torch

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.integrators import make_volume_integrator
    from xraytracer_tpu_torch.math import from_rows
    from xraytracer_tpu_torch.renderer import render
    from xraytracer_tpu_torch.scene.builder import scene_statics
    from xraytracer_tpu_torch.scene.presets import build_volume_scene, procedural_cloud

    golden = np.load(os.path.join(_HERE, "tests", "golden",
                                  "cloud_nee_24x18_4spp_seed0.npy"))
    # the golden's grid is rounded to bfloat16 (exact in float32)
    density = torch.from_numpy(procedural_cloud(res=(24, 20, 16), seed=3)).to(
        torch.bfloat16).to(torch.float32).numpy()
    tables = build_volume_scene(
        density=density, absorption=(0.02, 0.02, 0.02),
        scattering=(0.06, 0.05, 0.04), le=30.0).build(device)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 70.0, 550.0, 1)
    cam = PinholeCamera.make(24 / 18, c2w=c2w, fov_deg=60.0, device=device)
    routes = (("het", {}, CLOUD_GOLDEN_HET_GATE, {"het_spp_persistent": 1}),
              ("tracking", dict(with_stats=True), CLOUD_GOLDEN_CARD_GATE,
               {"track_sample": 4 * 18, "track_transmittance": 4 * 18,
                "sweep_nearest_rec": 2 * 4 * 18, "chunk_boxes": chunk_builds(tables, 1)}))
    out = {}
    for route, kw, (rtol, atol), expected in routes:
        integ = make_volume_integrator(tables, scene_statics(tables), 8, nee=True,
                                       max_steps=96, **kw)
        reset_all_counts()
        r = render(tables, cam, integ, 24, 18, 4, seed=0)
        counts = all_counts()
        diff = np.abs(r.image - golden)
        own = int((diff > CLOUD_GOLDEN_GATE[1] + CLOUD_GOLDEN_GATE[0] * np.abs(golden)).sum())
        over = int((diff > atol + rtol * np.abs(golden)).sum())
        out[route] = dict(
            max_abs_diff=float(diff.max()), values_over_gate=over,
            gate=f"rtol {rtol} atol {atol}", values_over_golden_own_gate=own,
            n_rejected=r.n_rejected,
            launches={k: v["launches"] for k, v in counts.items() if v["launches"]})
        check(over == 0 and r.n_rejected == 0,
              f"cloud golden, {route} route: {over} values beyond rtol {rtol} / atol {atol}")
        for name, c in counts.items():
            check(c["launches"] == expected.get(name, 0),
                  f"cloud golden, {route} route: {name} launched {c['launches']}x, "
                  f"expected {expected.get(name, 0)}")
        check(sum(v["plain_calls"] for v in counts.values()) == 0,
              f"cloud golden, {route} route: plain-version calls on the card")
    emit("golden", image="cloud_nee_24x18_4spp_seed0", values=int(golden.size),
         golden_own_gate=f"rtol {CLOUD_GOLDEN_GATE[0]} atol {CLOUD_GOLDEN_GATE[1]}",
         **out)


def volume_reference(tables, camk, statics, size, depth, nee, spp, device, plain):
    """The scene at reference size, seed 0: through the route the card takes
    by default (a whole-render kernel), or (``plain``) through no kernel at
    all: that kernel's own plain version, which has the kernel's camera-ray
    formulas and traces the ``spp`` samples of every pixel as one
    wavefront."""
    from types import SimpleNamespace

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.integrators import het_megakernel as hk
    from xraytracer_tpu_torch.integrators import make_volume_integrator
    from xraytracer_tpu_torch.integrators import vol_megakernel as vm
    from xraytracer_tpu_torch.renderer import render

    w, h = size
    cam = PinholeCamera.make(w / h, device=device, **camk)
    if not plain:
        integ = make_volume_integrator(tables, statics, depth, nee=nee)
        return render(tables, cam, integ, w, h, spp, seed=0)
    if statics["has_heterogeneous"]:
        consts = hk._het_consts(tables, statics, depth, nee, None, None)
        view = hk.try_make_fused_het_spp_render(
            tables, statics, cam, w, h, 0, depth, nee=nee).view
        rad, _ = hk.het_spp_persistent_plain(consts, view, 0, spp, batch=spp)
    else:
        consts = vm._vol_consts(tables, statics, depth, nee, None, None)
        view = vm.try_make_fused_volume_spp_render(
            tables, statics, cam, w, h, 0, depth, nee=nee).view
        rad, _ = vm.vol_spp_persistent_plain(consts, view, 0, spp, batch=spp)
    return SimpleNamespace(image=rad.cpu().numpy().reshape(h, w, 3) / spp)


def phase_volume_path(label, device, preset, integrator, spp, expected_fn, ref_size,
                      scene=None):
    """Drive one volume preset at its full width and depth through the entry
    points a user calls, with counts set to 0 just before the run and read
    just after it; hold it against reference-size renders through the
    kernels and through the plain path. ``spp`` None = the preset's own.
    Returns the run's launch counts and result."""
    import numpy as np

    from xraytracer_tpu_torch import cli
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import PRESETS, get_preset
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    cfg = get_preset(preset, integrator=integrator, spp=spp)
    tables, camk = scene if scene is not None else cli.build_scene(cfg, device=device)
    statics = scene_statics(tables)
    nee = cfg.integrator == "vpt_nee"
    het = statics["has_heterogeneous"]
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **camk)
    integ = cli.make_integrator(cfg, tables, statics)
    # the default route of every volume preset is a whole-render kernel: the
    # heterogeneous one for the cloud presets, the homogeneous one for vpt
    kind = getattr(integ, "fused_spec", {}).get("kind")
    want_kind = "het_volume" if het else "volume"
    check(kind == want_kind, f"{label}: route {kind}, expected {want_kind}")
    renderer = WavefrontRenderer(tables, cam, integ, cfg.width, cfg.height,
                                 seed=cfg.seed)
    renderer.render(1)  # warm-up
    ref_depth = min(cfg.max_depth, HET_REF_PLAIN_DEPTH) if het else cfg.max_depth
    spp_full, spp_pair = VOL_REF_SPP[label]
    ref_full = volume_reference(tables, camk, statics, ref_size, cfg.max_depth, nee,
                                spp_full, device, plain=False)
    ref_k = ref_full if (ref_depth, spp_pair) == (cfg.max_depth, spp_full) else (
        volume_reference(tables, camk, statics, ref_size, ref_depth, nee, spp_pair,
                         device, plain=False))
    ref_p = volume_reference(tables, camk, statics, ref_size, ref_depth, nee,
                             spp_pair, device, plain=True)
    n_chunks = -(-cfg.spp // (cfg.spp_chunk or cfg.spp))
    reset_all_counts()
    result = renderer.render(cfg.spp, spp_chunk=cfg.spp_chunk or None)
    counts = all_counts()

    expected = expected_fn(cfg, n_chunks)
    check(result.image.shape == (cfg.height, cfg.width, 3), f"{label}: image shape")
    check(bool(np.isfinite(result.image).all()), f"{label}: non-finite pixels")
    check(result.n_rejected == 0, f"{label}: {result.n_rejected} rejected samples")
    for name, c in counts.items():
        want = expected.get(name, 0)
        check(c["launches"] == want,
              f"{label}: {name} launched {c['launches']}x, expected {want}")
    plain_calls = sum(c["plain_calls"] for c in counts.values())
    check(plain_calls == 0, f"{label}: {plain_calls} plain-version calls on the card")
    m_full, m_ref = float(result.image.mean()), float(ref_full.image.mean())
    m_k, m_p = float(ref_k.image.mean()), float(ref_p.image.mean())
    check(m_p > 0 and abs(m_k - m_p) <= MEAN_BAND_KERNEL_VS_PLAIN * m_p,
          f"{label}: {ref_size} depth-{ref_depth} mean {m_k} (kernels) vs {m_p} (plain)")
    band = VOLUME_MEAN_BAND[label]
    check(abs(m_full - m_ref) <= band * m_ref,
          f"{label}: full-size mean {m_full} vs reference-size mean {m_ref}")
    diff = np.abs(ref_k.image - ref_p.image)
    n_ref = ref_size[0] * ref_size[1]
    n_diff = int((diff > 1e-6 + 1e-4 * np.abs(ref_p.image)).any(axis=-1).sum())
    check(n_diff <= max(1, REF_PIXEL_DIFF_SHARE * n_ref),
          f"{label}: {n_diff} of {n_ref} reference pixels differ between the "
          f"kernels and the plain path")
    preset_spp = PRESETS[preset].spp
    emit(label, preset=preset, integrator=cfg.integrator,
         route="fused (het_spp_persistent)" if het else "fused (vol_spp_persistent)",
         width=cfg.width, height=cfg.height, depth=cfg.max_depth, spp=cfg.spp,
         preset_spp=preset_spp,
         spp_cut=None if cfg.spp == preset_spp else f"cut from {preset_spp} to {cfg.spp}",
         spp_chunks=n_chunks, seconds=result.seconds,
         msamples_per_s=result.samples_per_sec / 1e6, n_rejected=result.n_rejected,
         mean_radiance=m_full, ref_size=list(ref_size), ref_spp=spp_full,
         ref_mean_kernels_full_depth=m_ref, full_vs_ref_band=band,
         ref_pair_depth=ref_depth, ref_pair_spp=spp_pair,
         ref_mean_kernels=m_k, ref_mean_plain=m_p,
         ref_pixels_differing=n_diff, ref_pixels=n_ref,
         launches={k: v["launches"] for k, v in counts.items() if v["launches"]},
         plain_calls=plain_calls)
    return counts, result


def phase_vol_entry_points(device, main_image_mean):
    """vol_path and vol_spp through their entry points at the vpt preset's
    width and depth: ``try_make_fused_volume_integrator`` under the
    per-sample renderer (one launch per sample), and the ``fused_spec`` with
    ``persistent=False`` under the renderer's chunk runner (one launch per
    chunk). Returns the run's launch counts."""
    import numpy as np

    from xraytracer_tpu_torch import cli
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.integrators import make_volume_integrator
    from xraytracer_tpu_torch.integrators.vol_megakernel import (
        try_make_fused_volume_integrator,
    )
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    cfg = get_preset("vpt")
    tables, camk = cli.build_scene(cfg, device=device)
    statics = scene_statics(tables)
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **camk)
    per_sample = try_make_fused_volume_integrator(tables, statics, cfg.max_depth)
    check(per_sample is not None, "vol_entry_points: scene not eligible")
    chunked = make_volume_integrator(tables, statics, cfg.max_depth)
    chunked.fused_spec = dict(chunked.fused_spec, persistent=False)
    merged = make_volume_integrator(tables, statics, cfg.max_depth)
    renderers = [WavefrontRenderer(tables, cam, integ, cfg.width, cfg.height,
                                   seed=cfg.seed)
                 for integ in (per_sample, chunked, merged)]
    reset_all_counts()
    res_a = renderers[0].render(VOL_ENTRY_SPP)
    res_b = renderers[1].render(VOL_ENTRY_SPP)
    counts = all_counts()
    res_c = renderers[2].render(VOL_ENTRY_SPP)  # vol_spp_persistent, to compare
    for name, want in (("vol_path", VOL_ENTRY_SPP), ("vol_spp", 1)):
        check(counts[name]["launches"] == want,
              f"vol_entry_points: {name} launched {counts[name]['launches']}x, "
              f"expected {want}")
    check(sum(c["launches"] for c in counts.values()) == VOL_ENTRY_SPP + 1,
          "vol_entry_points: another kernel was launched")
    check(sum(c["plain_calls"] for c in counts.values()) == 0,
          "vol_entry_points: plain-version calls on the card")
    check(res_a.n_rejected == 0 and res_b.n_rejected == 0,
          "vol_entry_points: rejected samples")
    ab = np.abs(res_b.image - res_c.image)
    check(bool((ab <= K1_AB_ATOL + K1_AB_RTOL * np.abs(res_c.image)).all()),
          f"vol_entry_points: vol_spp vs vol_spp_persistent differ by {ab.max()}")
    diff = np.abs(res_a.image - res_c.image)
    n_diff = int((diff > K1_ATOL + K1_RTOL * np.abs(res_c.image)).any(axis=-1).sum())
    check(n_diff <= K1_PIXEL_DIFF_SHARE * cfg.width * cfg.height,
          f"vol_entry_points: vol_path route differs from the whole-render "
          f"kernel on {n_diff} pixels")
    m = float(res_a.image.mean())
    check(abs(m - main_image_mean) <= MEAN_BAND_FULL_VS_REF * main_image_mean,
          f"vol_entry_points: mean {m} vs vpt_path {main_image_mean}")
    emit("vol_entry_points", spp=VOL_ENTRY_SPP,
         vol_path=dict(seconds=res_a.seconds,
                       msamples_per_s=res_a.samples_per_sec / 1e6,
                       launches=counts["vol_path"]["launches"]),
         vol_spp=dict(seconds=res_b.seconds,
                      msamples_per_s=res_b.samples_per_sec / 1e6,
                      launches=counts["vol_spp"]["launches"]),
         vol_spp_vs_persistent_max_abs_diff=float(ab.max()),
         vol_path_vs_persistent_pixels_beyond_gate=n_diff,
         vol_path_vs_persistent_max_abs_diff=float(diff.max()),
         mean_radiance=m)
    return counts


def phase_profile_nee(device, nee_scene, top=12):
    """Trace the nee preset by its default route (the whole preset, one
    launch of het_spp_persistent) and 1 sample of its wavefront route
    (``with_stats=True``): the kernels that take most of the device time."""
    from torch.profiler import ProfilerActivity, profile

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.integrators import make_volume_integrator
    from xraytracer_tpu_torch.renderer import WavefrontRenderer
    from xraytracer_tpu_torch.scene.builder import scene_statics

    cfg = get_preset("nee")
    tables, camk = nee_scene
    cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **camk)
    for route, kw, n_spp in (("nee fused (het_spp_persistent)", {}, cfg.spp),
                             ("nee wavefront", dict(with_stats=True), 1)):
        integ = make_volume_integrator(tables, scene_statics(tables), cfg.max_depth,
                                       nee=True, **kw)
        renderer = WavefrontRenderer(tables, cam, integ, cfg.width, cfg.height, seed=0)
        renderer.render(1)
        plain = renderer.render(n_spp).seconds
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = renderer.render(n_spp).seconds
        emit_profile(prof, top, route=route, spp=n_spp, seconds_untraced=plain,
                     seconds_traced=traced)

# --------------------------------------------------------------------------
# surface gradients: K5, the autograd and analytic routes, the trainer
# --------------------------------------------------------------------------
GRAD_REPLACES = "xraytracer_tpu/integrators/megakernel.py:1127"


def light_box_scene(device):
    """The 16-light power-NEE box of tests/test_diff.py (floor, back wall and
    ceiling wound toward the room, 4 x 4 ceiling quads of skewed powers),
    built with the port's SceneBuilder, and its camera."""
    import numpy as np

    from xraytracer_tpu_torch.math import from_rows
    from xraytracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    white = b.add_lambert((0.7, 0.7, 0.7))
    quads = []
    for v0, v1, v2, v3 in (
        ((0, 0, 0), (556, 0, 0), (556, 0, 559), (0, 0, 559)),
        ((0, 0, 559), (556, 0, 559), (556, 548, 559), (0, 548, 559)),
        ((0, 548, 0), (556, 548, 0), (556, 548, 559), (0, 548, 559)),
    ):
        quads.append(np.asarray([[v0, v2, v1], [v0, v3, v2]], np.float32))
    b.add_mesh(np.concatenate(quads, axis=0), material=white)
    rng = np.random.default_rng(3)
    for i in range(4):
        for j in range(4):
            x0, z0 = 60.0 + i * 110.0, 60.0 + j * 110.0
            le = float(rng.uniform(1.0, 30.0))
            b.add_quad_light((x0, 547.0, z0), (x0 + 40.0, 547.0, z0),
                             (x0, 547.0, z0 + 40.0), (le, 0.8 * le, 0.6 * le))
    c2w = from_rows(-1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, -1.0, 0,
                    278.0, 273.0, -600.0, 1)
    return b.build(device), dict(c2w=c2w, fov_deg=38.0)


def sample_rays(camk, device, sample):
    """Path keys and camera rays of one sample of every pixel at the full
    size, as the gradient routes make them (``camera.sample_rays``)."""
    import torch

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.renderer import CAMERA_SITE, pixel_grid
    from xraytracer_tpu_torch.sampling import path_keys, uniform2

    cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **camk)
    ids, xy = pixel_grid(WIDTH, HEIGHT, device=device)
    keys = path_keys(0, ids, sample)
    u = uniform2(keys, CAMERA_SITE)
    rays = cam.sample_rays((xy + u) / torch.tensor([float(WIDTH), float(HEIGHT)],
                                                   device=device))
    return keys, rays.o.contiguous(), rays.d.contiguous()


def grad_bound(gs, stats, t_total, paths=None):
    """bound_ms of a K5 launch: the whole-path kernel's pair tests and bytes
    (mega_bound) plus the Jacobian updates of the events this run's paths
    take, from the plain version's per-bounce counters (docstring above). On
    a table the kernel culls, ``paths`` (``MegaRayLog``'s) count the pair,
    any-hit and slab tests as ``mega_culled_bound`` counts them; the
    brute-force figure is ``brute_bound_ms``."""
    fs = gs.fs
    n = int(stats["rays"][0])
    m9 = 9 * gs.n_mats
    n_shadow = fs.n_lights if fs.nee_mode == "all" else 1
    nee_lanes = (stats["shadow_rays"] // max(n_shadow, 1)) if fs.nee else 0 * stats["rays"]
    roulette = int((nee_lanes[1:] + stats["emitter_hits"][1:]).sum())
    emits = int(stats["emitter_hits"][0] if fs.le0 else stats["emitter_hits"].sum())
    nee = int(stats["shadow_rays"].sum())
    scatter = int(nee_lanes[:fs.max_depth - 1].sum())
    b = mega_bound(n, t_total, fs.n_lights, stats, 28, 4 * gs.n_planes)
    jac_ops = (m9 * (FLOPS_JAC_ROULETTE * roulette + FLOPS_JAC_EMIT * emits
                     + FLOPS_JAC_NEE * nee + FLOPS_JAC_SCATTER * scatter)
               + 3 * (emits + 2 * nee))
    by_bytes = (n * (28 + 4 * gs.n_planes) + t_total * (36 + 2 + 128)
                + fs.n_lights * 80) / PEAK_BYTES_PER_S * 1e3
    brute_ops = (b["rays"] * t_total * FLOPS_PER_TEST
                 + b["shadow_rays"] * t_total * FLOPS_PER_ANYHIT_TEST)
    walk_ops, extra = brute_ops, {}
    if paths is not None:
        culled = mega_culled_bound(fs, paths, 28, 4 * gs.n_planes, n)["culled"]
        walk_ops = (culled["pair_tests"] * FLOPS_PER_TEST
                    + culled["anyhit_tests"] * FLOPS_PER_ANYHIT_TEST
                    + culled["slab_tests"] * FLOPS_PER_SLAB)
        extra = dict(culled=culled, brute_bound_ms=max(
            by_bytes, (brute_ops + jac_ops) / PEAK_F32_FLOPS * 1e3))
    by_ops = (walk_ops + jac_ops) / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                rays=b["rays"], shadow_rays=b["shadow_rays"],
                jacobian_events=dict(roulette=roulette, emission=emits,
                                     nee=nee, scatter=scatter), **extra)


def compare_grad_lanes(what, got, ref):
    """K5 vs its plain version, lane by lane, for one of img / galb / gle:
    the count of lanes with any value beyond GRAD_LANE_RTOL * |ref| +
    GRAD_LANE_ATOL_REL * max |ref|, gated at GRAD_LANE_SHARE of the lanes."""
    import torch

    n = ref.shape[0]
    check(tuple(got.shape) == tuple(ref.shape) and bool(torch.isfinite(got).all()),
          f"{what}: shape {tuple(got.shape)} or non-finite values")
    diff = torch.abs(got - ref)
    scale = float(torch.abs(ref).max())
    lim = GRAD_LANE_RTOL * torch.abs(ref) + GRAD_LANE_ATOL_REL * scale
    beyond = int((diff > lim).reshape(n, -1).any(dim=1).sum())
    out = dict(max_abs_err=float(diff.max()), max_abs=scale,
               lanes_differing_at_all=int((diff > 0).reshape(n, -1).any(dim=1).sum()),
               lanes_beyond_gate=beyond)
    check(beyond <= max(2, GRAD_LANE_SHARE * n),
          f"{what}: {beyond} of {n} lanes beyond the per-lane gate")
    return out


def contract(img, galb, gle):
    """The L2 loss against a zero target, chained: d loss / d albedo (M, 3)
    and d loss / d Le (L, 3)."""
    import torch

    n = img.shape[0]
    r = 2.0 * img / (n * 3)
    return (torch.einsum("nc,nckm->mk", r, galb), torch.einsum("nc,ncl->lc", r, gle))


def rel_err(got, ref):
    import torch

    return float(torch.abs(got - ref).max() / torch.clamp(torch.abs(ref).max(), min=1e-30))


def grad_cases(device, cornell, cornell_cam):
    """K5's cases: (label, tables, camera, options, albedo or None, Le
    scale). Cornell at depth 3 with Le x 1.3 and red / green albedos of its
    own (white stays 1, the roulette's tie); the 16-light box with power
    picks at depth 2; 4 facing-in lights with NEE "all" and uniform
    sampling at depth 3; the 128-row sphere mesh, which the kernel culls."""
    import torch

    from xraytracer_tpu_torch.scene.presets import cornell_camera

    box, box_cam = light_box_scene(device)
    room = many_light_scene(device, n_side=2, face_in=True)
    mesh_128, mesh_cam = mesh_scene(device, K1_MESH_SMALL)
    alb = cornell.mat_albedo.clone()
    alb[1] = torch.tensor([0.12, 0.75, 0.1], device=device)
    alb[2] = torch.tensor([0.8, 0.1, 0.05], device=device)
    return [
        ("cornell, Le x 1.3, own albedos", cornell, cornell_cam,
         dict(max_depth=DEPTH, cosine_sampling=True, nee_mode="all"), alb, 1.3),
        ("16-light box, power", box, box_cam,
         dict(max_depth=2, cosine_sampling=True, nee_mode="power"), None, 1.0),
        ("4 lights facing in, all, uniform", room, cornell_camera(),
         dict(max_depth=DEPTH, cosine_sampling=False, nee_mode="all"), None, 1.3),
        ("mesh %dx%d, culled" % K1_MESH_SMALL, mesh_128, mesh_cam,
         dict(max_depth=DEPTH, cosine_sampling=True, nee_mode="all"), None, 1.0),
    ]


def phase_grad_kernels(device, cornell, cornell_cam, reps):
    """Hold K5 (mega_grad_path) against its plain version (forward-mode
    autodiff of the wavefront integrator along every parameter direction)
    on the card, on sample GRAD_SAMPLE's camera rays at 780x585, on the
    cases of ``grad_cases``. Returns the ``kernels`` entry."""
    import torch

    from xraytracer_tpu_torch.geometry import Rays
    from xraytracer_tpu_torch.geometry.intersect import intersect_triangles_mm
    from xraytracer_tpu_torch.integrators import make_path_integrator
    from xraytracer_tpu_torch.integrators import megakernel as mk
    from xraytracer_tpu_torch.scene.builder import scene_statics
    from xraytracer_tpu_torch.scene.tables import rejoin_appearance

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    scenes = grad_cases(device, cornell, cornell_cam)
    cases = []
    for label, tables, camk, opts, albedo, le_scale in scenes:
        st = scene_statics(tables)
        f = mk.try_make_fused_grad_path(tables, st, opts["max_depth"], nee=True,
                                        cosine_sampling=opts["cosine_sampling"],
                                        nee_mode=opts["nee_mode"])
        check(f is not None, f"{label}: scene not eligible for the gradient kernel")
        gs = f.grad_scene
        keys, o, d = sample_rays(camk, device, GRAD_SAMPLE)
        le = tables.al_le * le_scale
        rec = rejoin_appearance(tables._replace(
            mat_albedo=tables.mat_albedo if albedo is None else albedo,
            al_le=le)).tri_rec.contiguous()
        ref, plain_ms = timed_once(
            lambda: mk.mega_grad_path_plain(gs, o, d, keys, rec, le))
        got = mk.mega_grad_path(gs, o, d, keys, rec, le)
        torch.cuda.synchronize()
        case = dict(case=label, n=int(o.shape[0]), t_total=int(tables.tri_v0.shape[0]),
                    n_mats=gs.n_mats, n_lights=gs.fs.n_lights, planes=gs.n_planes,
                    **{k: v for k, v in opts.items()})
        for what, a, b in zip(("img", "galb", "gle"), got, ref):
            case[what] = compare_grad_lanes(f"mega_grad_path, {label}, {what}", a, b)
        (ka, kl), (pa, pl) = contract(*got), contract(*ref)
        case["contracted_rel_err"] = dict(mat_albedo=rel_err(ka, pa), al_le=rel_err(kl, pl))
        for k, (x, y) in (("mat_albedo", (ka, pa)), ("al_le", (kl, pl))):
            ok = bool((torch.abs(x - y) <= GRAD_RTOL * torch.abs(y)
                       + GRAD_ATOL_REL * float(torch.abs(y).max())).all())
            check(ok, f"mega_grad_path, {label}: contracted d loss / d {k} off by "
                      f"{case['contracted_rel_err'][k]} (relative to its largest)")
        case["max_abs_err"] = max(case[w]["max_abs_err"] for w in ("img", "galb", "gle"))
        # the plain version's per-bounce counters on the same inputs, for the bound
        sc = tables._replace(tri_rec=rec, al_le=le)
        with MegaRayLog(opts["max_depth"], on=gs.fs.culls) as log:
            _, stats = make_path_integrator(
                sc, st, opts["max_depth"], nee=True,
                cosine_sampling=opts["cosine_sampling"], tri_fn=intersect_triangles_mm,
                nee_mode=opts["nee_mode"], pick_weights=gs.fs.pick_weights,
                fused="never", with_stats=True,
            )(Rays(o=o, d=d), keys)
        stats = {k: v.cpu() for k, v in stats.items()}
        case.update(plain_ms=plain_ms,
                    ms=median_ms(lambda: mk.mega_grad_path(gs, o, d, keys, rec, le),
                                 reps, flush),
                    **grad_bound(gs, stats, case["t_total"],
                                 log.paths if gs.fs.culls else None))
        del log
        cases.append(case)
        del got, ref
    # the cap on materials routes a scene back
    many = cornell._replace(mat_albedo=torch.rand((mk.MAX_GRAD_MATS + 1, 3), device=device))
    check(mk.try_make_fused_grad_path(many, scene_statics(cornell), DEPTH) is None,
          f"more than {mk.MAX_GRAD_MATS} materials must not take the gradient kernel")
    emit("kernel_checks", kernels="surface gradient", cases=cases, reps=reps,
         tolerances=dict(lane=[GRAD_LANE_RTOL, GRAD_LANE_ATOL_REL],
                         lane_share=GRAD_LANE_SHARE,
                         contracted=[GRAD_RTOL, GRAD_ATOL_REL]))
    head = cases[0]
    return [dict(
        name="mega_grad_path", route="cuda",
        source="xraytracer_tpu_torch/csrc/megakernel.cu",
        replaces=GRAD_REPLACES, launches=None, launches_by_path=None,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        err_of="radiance, d radiance / d albedo and d radiance / d Le per lane "
               "against the plain version (forward-mode autodiff), worst case",
        ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=None,
        shape=f"{head['case']}: N={head['n']} T={head['t_total']} "
              f"M={head['n_mats']} L={head['n_lights']} planes={head['planes']}",
        cases=[{k: c[k] for k in ("case", "n", "t_total", "n_mats", "n_lights", "ms",
                                  "plain_ms", "bound_ms", "bound_by", "brute_bound_ms",
                                  "contracted_rel_err") if k in c}
               for c in cases],
    )]


def phase_grad_path(device, cornell, cornell_cam):
    """The gradient of the L2 loss (zero target) w.r.t. albedo and Le at
    780x585, depth 3, cosine sampling, NEE all, by both routes a user calls:
    autograd through ``diff.make_loss_fn(diff.make_radiance_fn(...))``
    (K2 through the stopgrad sweep, K4 for the shadow rays) and
    ``diff.try_make_fast_value_and_grad`` (one K5 launch per step). One
    warm-up step at sample 0, whose results the two routes must agree on,
    then GRAD_STEPS timed steps, counted from 0 (bench.py:109-117's
    protocol). Returns the counts of the two timed runs."""
    import torch

    from xraytracer_tpu_torch import diff
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.renderer import pixel_grid
    from xraytracer_tpu_torch.scene.builder import scene_statics

    st = scene_statics(cornell)
    cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **cornell_cam)
    ids, xy = pixel_grid(WIDTH, HEIGHT, device=device)
    target = torch.zeros((WIDTH * HEIGHT, 3), device=device)
    params = {"mat_albedo": cornell.mat_albedo, "al_le": cornell.al_le}
    radiance = diff.make_radiance_fn(cornell, st, cam, WIDTH, HEIGHT,
                                     max_depth=DEPTH, cosine_sampling=True)
    fast = diff.try_make_fast_value_and_grad(cornell, st, cam, WIDTH, HEIGHT,
                                             max_depth=DEPTH, nee=True,
                                             cosine_sampling=True)
    check(fast is not None, "grad_path: Cornell did not take the analytic route")
    n_lights = st["n_area_lights"]
    routes = (
        ("autograd", diff.value_and_grad(diff.make_loss_fn(radiance)),
         {"sweep_nearest": DEPTH * GRAD_STEPS,
          "occluded_anyhit": DEPTH * n_lights * GRAD_STEPS,
          "chunk_boxes": chunk_builds(cornell, 2)}),
        ("analytic", fast, {"mega_grad_path": GRAD_STEPS}),
    )
    out, by_path, first = {}, {}, {}
    for route, fn, expected in routes:
        val0, g0 = fn(params, ids, xy, target, 0)
        torch.cuda.synchronize()
        first[route] = (float(val0), g0)
        reset_all_counts()
        t0 = time.perf_counter()
        for s in range(1, 1 + GRAD_STEPS):
            val, g = fn(params, ids, xy, target, s)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = all_counts()
        for name, c in counts.items():
            check(c["launches"] == expected.get(name, 0),
                  f"grad_path, {route}: {name} launched {c['launches']}x, "
                  f"expected {expected.get(name, 0)}")
            check(c["plain_calls"] == 0, f"grad_path, {route}: plain calls of {name}")
        check(all(bool(torch.isfinite(v).all()) for v in g.values()),
              f"grad_path, {route}: non-finite gradients")
        by_path[f"grad_path_{route}"] = counts
        out[route] = dict(
            seconds=secs, steps=GRAD_STEPS, rays_per_s=WIDTH * HEIGHT * GRAD_STEPS / secs,
            loss_sample0=float(val0),
            launches={k: v["launches"] for k, v in counts.items() if v["launches"]})
    (va, ga), (vf, gf) = first["autograd"], first["analytic"]
    check(abs(vf - va) <= GRAD_LOSS_RTOL * abs(va),
          f"grad_path: analytic loss {vf} vs autograd {va}")
    errs = {}
    for k in params:
        errs[k] = rel_err(gf[k], ga[k])
        ok = bool((torch.abs(gf[k] - ga[k]) <= GRAD_RTOL * torch.abs(ga[k])
                   + GRAD_ATOL_REL * float(torch.abs(ga[k]).max())).all())
        check(ok, f"grad_path: d loss / d {k}, analytic vs autograd off by {errs[k]}")
    emit("grad_path", width=WIDTH, height=HEIGHT, depth=DEPTH, cosine_sampling=True,
         nee_mode="all", target="zero", routes=out,
         autodiff_rays_per_s=out["autograd"]["rays_per_s"],
         analytic_rays_per_s=out["analytic"]["rays_per_s"],
         grads_sample0={r: {k: v.tolist() for k, v in first[r][1].items()}
                        for r in first},
         analytic_vs_autograd_rel_err=errs,
         tolerances=dict(loss=GRAD_LOSS_RTOL, grads=[GRAD_RTOL, GRAD_ATOL_REL]))
    return by_path


def phase_profile_grad(device, cornell, cornell_cam, top=12):
    """Trace one step of each gradient route of ``grad_path`` (after a
    warm-up and one untraced step): the kernels that take most of the
    device time, the host operators that take most of the host's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xraytracer_tpu_torch import diff
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.renderer import pixel_grid
    from xraytracer_tpu_torch.scene.builder import scene_statics

    st = scene_statics(cornell)
    cam = PinholeCamera.make(WIDTH / HEIGHT, device=device, **cornell_cam)
    ids, xy = pixel_grid(WIDTH, HEIGHT, device=device)
    target = torch.zeros((WIDTH * HEIGHT, 3), device=device)
    params = {"mat_albedo": cornell.mat_albedo, "al_le": cornell.al_le}
    radiance = diff.make_radiance_fn(cornell, st, cam, WIDTH, HEIGHT,
                                     max_depth=DEPTH, cosine_sampling=True)
    routes = (
        ("grad autograd", diff.value_and_grad(diff.make_loss_fn(radiance))),
        ("grad analytic", diff.try_make_fast_value_and_grad(
            cornell, st, cam, WIDTH, HEIGHT, max_depth=DEPTH, nee=True,
            cosine_sampling=True)),
    )
    for route, fn in routes:
        def step(s):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(params, ids, xy, target, s)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        step(0)
        plain = step(1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = step(2)
        emit_profile(prof, top, route=route, steps=1, seconds_untraced=plain,
                     seconds_traced=traced)


def phase_profile_vol_grad(device, nee_scene, top=12):
    """Trace one analytic step of ``vol_grad_path`` (nee, 780x585, after a
    warm-up and one untraced step): the kernels that take most of the
    device time, the host operators that take most of the host's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xraytracer_tpu_torch import diff
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.renderer import pixel_grid
    from xraytracer_tpu_torch.scene.builder import scene_statics

    ncfg = get_preset("nee")
    tables, camk = nee_scene
    w, h = ncfg.width, ncfg.height
    cam = PinholeCamera.make(w / h, device=device, **camk)
    fn = diff.try_make_fast_value_and_grad(tables, scene_statics(tables), cam, w, h,
                                           max_depth=ncfg.max_depth, nee=True)
    ids, xy = pixel_grid(w, h, device=device)
    target = torch.zeros((w * h, 3), device=device)
    params = {"grid_density": tables.grid_density, "al_le": tables.al_le}

    def step(s):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(params, ids, xy, target, s)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    step(0)
    plain = step(1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = step(2)
    emit_profile(prof, top, route="volume grad analytic", steps=1,
                 seconds_untraced=plain, seconds_traced=traced)


def phase_fit_path(device):
    """``tools.fit_scene.fit`` at 780x585, depth 3, FIT_STEPS steps of
    FIT_SPP sample through K5: the trainer a user runs, counted from 0.
    Returns its counts."""
    import numpy as np

    from xraytracer_tpu_torch.tools.fit_scene import fit

    stats = {}
    reset_all_counts()
    t0 = time.perf_counter()
    hist, fitted, true = fit(width=WIDTH, height=HEIGHT, max_depth=DEPTH,
                             steps=FIT_STEPS, spp=FIT_SPP, device="cuda", stats=stats)
    secs = time.perf_counter() - t0
    counts = all_counts()
    check(stats["route"] == "analytic", f"fit_path: took the {stats['route']} route")
    k5 = counts["mega_grad_path"]["launches"]
    check(k5 == FIT_STEPS * FIT_SPP,
          f"fit_path: mega_grad_path launched {k5}x, expected {FIT_STEPS * FIT_SPP}")
    plain = sum(c["plain_calls"] for c in counts.values())
    check(plain == 0, f"fit_path: {plain} plain-version calls on the card")
    first, last = float(np.mean(hist[:4])), float(np.mean(hist[-4:]))
    check(last < first, f"fit_path: loss did not fall ({first} -> {last})")
    check(stats["grads_finite"] and bool(np.isfinite(hist).all()),
          "fit_path: non-finite loss or gradient")
    check(stats["n_rejected"] == 0, f"fit_path: {stats['n_rejected']} rejected samples")
    emit("fit_path", width=WIDTH, height=HEIGHT, depth=DEPTH, steps=FIT_STEPS,
         spp=FIT_SPP, route=stats["route"], seconds=secs,
         seconds_per_step=float(np.median(stats["step_seconds"])),
         step_seconds=stats["step_seconds"], loss=hist,
         loss_first4=first, loss_last4=last, n_rejected=stats["n_rejected"],
         albedo_mae=float(np.abs(fitted["mat_albedo"] - true["mat_albedo"]).mean()),
         le_fitted=fitted["al_le"].tolist(),
         launches={k: v["launches"] for k, v in counts.items() if v["launches"]})
    return counts


HET_GRAD_REPLACES = "xraytracer_tpu/integrators/het_megakernel.py:948"


def grad_cloud_scene(device):
    """The 16^3 cloud of tests/test_het_grad_kernel.py (seeded uniform
    densities in the inner 10^3 voxels, under one sphere light), its camera
    and its density as a tensor."""
    import numpy as np
    import torch

    from xraytracer_tpu_torch.math import from_rows
    from xraytracer_tpu_torch.scene.presets import build_volume_scene

    g = np.zeros((16, 16, 16), np.float32)
    g[3:13, 3:13, 3:13] = np.random.default_rng(7).uniform(0.3, 1.0, (10, 10, 10))
    tables = build_volume_scene(
        res=g.shape, density=g, absorption=(0.02, 0.03, 0.04),
        scattering=(0.10, 0.08, 0.06), le=25.0, light_center=(0.0, 400.0, 0.0),
    ).build(device)
    camk = dict(c2w=from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 60.0, 520.0, 1),
                fov_deg=60.0)
    return tables, camk, torch.from_numpy(g).to(device)


def window_pixels(w, h, window, device):
    """Pixel ids and (x, y) of the whole w x h frame, or of the centred
    ``window`` = (ww, wh) of it."""
    from xraytracer_tpu_torch.renderer import pixel_grid

    ids, xy = pixel_grid(w, h, device=device)
    if window is None:
        return ids, xy
    ww, wh = window
    x0, y0 = (w - ww) // 2, (h - wh) // 2
    sel = (xy[:, 0] >= x0) & (xy[:, 0] < x0 + ww) & (xy[:, 1] >= y0) & (xy[:, 1] < y0 + wh)
    return ids[sel].contiguous(), xy[sel].contiguous()


def het_grad_rays(cam, w, h, ids, xy, seed, sample):
    """Path keys and camera rays of one sample, as the analytic step makes
    them."""
    import torch

    from xraytracer_tpu_torch.renderer import CAMERA_SITE
    from xraytracer_tpu_torch.sampling import path_keys, uniform2

    keys = path_keys(seed, ids, sample)
    u = uniform2(keys, CAMERA_SITE)
    rays = cam.sample_rays((xy + u) / torch.tensor([float(w), float(h)], device=xy.device))
    return keys, rays.o.contiguous(), rays.d.contiguous()


def het_grad_by(plain, hc, cam, w, h, ids, xy, grid, target, samples, seed=0):
    """The loss and gradients (grid, Le (L, 3)) of ``step`` (one sample) or
    ``step_pair`` (two samples, streams seed and seed + 7919), by the
    kernels (K9a + K10 on the live grid's corner table, each stream
    replayed apart) or by their plain versions (autograd), on the same
    draws. Also returns the pass-A images."""
    import torch

    from xraytracer_tpu_torch.integrators import het_megakernel as hk

    from xraytracer_tpu_torch import media_kernels as mkk

    fwd = hk.het_path_plain if plain else hk.het_path
    bwd = hk.het_grad_path_plain if plain else hk.het_grad_path
    table = {} if plain else {"packed": mkk.pack_corners(grid)}
    runs = []
    for k, sample in enumerate(samples):
        keys, o, d = het_grad_rays(cam, w, h, ids, xy, seed + 7919 * k, sample)
        runs.append((o, d, keys, fwd(hc, o, d, keys, density=grid, **table)))
    n = ids.shape[0]
    if len(runs) == 1:
        img = runs[0][3]
        loss = torch.mean((img - target) ** 2)
        rfacs = [2.0 * (img - target) / (n * 3)]
    else:
        a, b = runs[0][3], runs[1][3]
        loss = torch.mean((a - target) * (b - target))
        rfacs = [(b - target) / (n * 3), (a - target) / (n * 3)]
    g_grid = g_le = 0.0
    for (o, d, keys, img), rfac in zip(runs, rfacs):
        _, gle, gg = bwd(hc, o, d, keys, img, rfac.contiguous(), grid, **table)
        g_grid = g_grid + gg
        g_le = g_le + torch.einsum("nc,ncl->lc", rfac, gle)
    return float(loss), g_grid, g_le, [r[3] for r in runs]


def het_grad_bound(tables, n, n_spheres, n_lights, stats, tally):
    """bound_ms of a K10 launch: a replay of the K9 path on the same draws
    (het_bound), each transmittance walk once, and per candidate
    the gradient event (coefficient and eight corner weights and atomic
    adds); bytes: rays, keys, image and residual in, image and 3L planes
    out, the grid and the supergrid read, the gradient grid written."""
    rays = int(stats["rays"].sum())
    scattered = int(stats["scattered"].sum())
    hit_test = n_spheres * FLOPS_HET_SPHERE + FLOPS_VOL_BOX
    ops = (rays * (hit_test + FLOPS_VOL_RR)
           + tally.sample_segments * FLOPS_DDA_SEGMENT
           + tally.sample_candidates * (FLOPS_TRACK_CANDIDATE + FLOPS_SAMPLE_GRAD_EVENT)
           + scattered * (FLOPS_HET_SCATTER + FLOPS_HET_CONE + hit_test + FLOPS_HET_NEE_REST)
           + tally.tr_segments * FLOPS_DDA_SEGMENT
           + tally.tr_candidates * (FLOPS_TRANSMITTANCE_CANDIDATE + FLOPS_TR_GRAD_EVENT))
    n_bytes = (n * (52 + 12 + 12 * n_lights) + tables.grid_super.numel() * 4
               + 2 * tables.grid_density.numel() * 4)
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                rays=rays, scattered=scattered, tracking_lanes=tally.sample_lanes,
                segments=tally.sample_segments, candidates=tally.sample_candidates,
                shadow_lanes=tally.tr_lanes, shadow_segments=tally.tr_segments,
                shadow_candidates=tally.tr_candidates)


PACK_REPLACES = "xraytracer_tpu/scene/builder.py:417"


def check_pack_corners(device, grids, reps, flush):
    """pack_corners (the corner table of a live grid) against its plain
    version on each of ``grids`` ({label: (grid, build-time table or
    None)}), bitwise, and against the scene builder's table where there is
    one; timed, beside its bytes bound (the grid read once, the table
    written once: 9 x cells x 4 B). Returns the ``kernels`` entry."""
    import torch

    from xraytracer_tpu_torch import media_kernels as mkk

    cases = []
    for label, (grid, built) in grids.items():
        got = mkk.pack_corners(grid)
        ref = mkk.pack_corners_plain(grid)
        torch.cuda.synchronize()
        bad = int((got != ref).any(dim=1).sum())
        check(bad == 0, f"pack_corners, {label}: {bad} rows differ from the plain version")
        if built is not None:
            check(torch.equal(got, built), f"pack_corners, {label}: not the builder's table")
        out = torch.empty_like(got)
        cells = grid.numel()
        cases.append(dict(
            case=label, cells=cells, rows_differ=bad, builder_table=built is not None,
            ms=median_ms(lambda: mkk.pack_corners(grid, out=out), reps, flush),
            plain_ms=median_ms(lambda: mkk.pack_corners_plain(grid), reps, flush),
            bound_ms=9 * cells * 4 / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
            max_abs_err=float(torch.abs(got - ref).max())))
    emit("kernel_checks", kernels="corner table of a live grid", cases=cases, reps=reps)
    head = cases[0]
    return dict(
        name="pack_corners", route="cuda", source="xraytracer_tpu_torch/csrc/media.cu",
        replaces=PACK_REPLACES, launches=None, launches_by_path=None,
        replaces_note="no TPU kernel: a helper of het_grad_path's route, in place of "
                      "the scene builder's host packing",
        max_abs_err=max(c["max_abs_err"] for c in cases),
        err_of="corner table against the plain version, bitwise (0 rows differ)",
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=None, shape=f"{head['case']}: {head['cells']} cells",
        cases=[{k: c[k] for k in ("case", "cells", "ms", "bound_ms", "plain_ms")}
               for c in cases])


def phase_het_grad_kernels(device, nee_scene, reps):
    """Hold K10 (het_grad_path, with K9a het_path as pass A) against its
    plain version (autograd through the wavefront route on the same draws)
    for ``step`` and ``step_pair``: (a) the 16^3 cloud of
    tests/test_het_grad_kernel.py at 16x12, depth 3, max_steps 32; (b)
    tools.fit_volume's scene, blob density and first camera at 96x72,
    depth 6; (c) the nee preset (64^3 cloud, depth 32, max_steps 110) on the
    centred HET_GRAD_WINDOW of its 780x585 frame. Pass B's recomputed
    radiance is held against pass A's on every lane. Then K10 is timed on
    the nee preset's full 780x585 camera rays. Returns the ``kernels``
    entry."""
    import torch

    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.integrators import het_megakernel as hk
    from xraytracer_tpu_torch.scene.builder import scene_statics
    from xraytracer_tpu_torch.tools import fit_volume

    from xraytracer_tpu_torch import media_kernels as mkk

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    ncfg = get_preset("nee")
    attrs = het_kernel_attrs(hk._lib())
    cloud, cloud_cam, cloud_grid = grad_cloud_scene(device)
    fw, fh = 96, 72
    fit_tables = fit_volume.build_scene(device)
    fit_cam = fit_volume._cameras(fw, fh, device)[0]
    nee_tables, nee_camk = nee_scene
    scenes = [
        # label, tables, camera, width, height, window, depth, max_steps, grid
        ("16^3 cloud", cloud, PinholeCamera.make(16 / 12, device=device, **cloud_cam),
         16, 12, None, 3, 32, cloud_grid),
        ("fit_volume scene, first view", fit_tables, fit_cam, fw, fh, None,
         fit_volume.MAX_DEPTH, None,
         torch.from_numpy(fit_volume._blob_target()).to(device)),
        (f"nee, {HET_GRAD_WINDOW[0]}x{HET_GRAD_WINDOW[1]} window", nee_tables,
         PinholeCamera.make(ncfg.width / ncfg.height, device=device, **nee_camk),
         ncfg.width, ncfg.height, HET_GRAD_WINDOW, ncfg.max_depth,
         ncfg.max_steps or None, nee_tables.grid_density.contiguous()),
    ]
    cases = []
    for label, tables, cam, w, h, window, depth, max_steps, grid in scenes:
        st = scene_statics(tables)
        step = hk.try_make_fused_het_value_and_grad(tables, st, cam, w, h, depth,
                                                    nee=True, max_steps=max_steps)
        check(step is not None, f"{label}: scene not eligible for the het gradient route")
        hc = step.het_consts
        ids, xy = window_pixels(w, h, window, device)
        n = int(ids.shape[0])
        case = dict(case=label, n=n, max_depth=depth, max_steps=hc.max_steps,
                    n_lights=int(hc.ic[1]), grid=list(grid.shape))
        # the targets of tests/test_het_grad_kernel.py
        keys, o, d = het_grad_rays(cam, w, h, ids, xy, 0, 0)
        img0 = hk.het_path(hc, o, d, keys, density=grid)
        for what, samples, target in (("step", (0,), img0 * 0.7 + 0.01),
                                      ("step_pair", (4, 5), img0 * 0.6 + 0.02)):
            (pl, pg, pe, _), plain_ms = timed_once(
                lambda: het_grad_by(True, hc, cam, w, h, ids, xy, grid, target, samples))
            kl, kg, ke, imgs = het_grad_by(False, hc, cam, w, h, ids, xy, grid, target,
                                           samples)
            # the public step functions give the kernels' numbers
            params = {"grid_density": grid, "al_le": tables.al_le}
            if what == "step":
                sl, sg = step(params, ids, xy, target, samples[0])
            else:
                sl, sg = step.step_pair(params, ids, xy, target, *samples)
            torch.cuda.synchronize()
            sle = sg["al_le"][:ke.shape[0]]
            sle_beyond = int((torch.abs(sle - ke) > HET_GRAD_LE_RTOL * torch.abs(ke)
                              + HET_GRAD_LE_ATOL).sum())
            scale = float(torch.abs(pg).max())
            check(scale > 0.0, f"het_grad_path, {label}, {what}: the gradient is zero")
            grid_err = torch.abs(kg - pg)
            beyond = int((grid_err > HET_GRAD_RTOL * torch.abs(pg)
                          + HET_GRAD_ATOL_REL * scale).sum())
            le_err = torch.abs(ke - pe)
            le_beyond = int((le_err > HET_GRAD_LE_RTOL * torch.abs(pe) + HET_GRAD_LE_ATOL).sum())
            r = dict(loss=kl, loss_plain=pl, loss_rel_err=abs(kl - pl) / max(abs(pl), 1e-30),
                     grid_max_abs_err=float(grid_err.max()), grid_max_abs=scale,
                     grid_cells_beyond_gate=beyond, grid_cells=int(pg.numel()),
                     al_le=ke.tolist(), al_le_plain=pe.tolist(),
                     al_le_max_abs_err=float(le_err.max()), al_le_beyond_gate=le_beyond,
                     plain_ms=plain_ms,
                     step_fn_vs_kernels=dict(
                         loss=abs(float(sl) - kl),
                         grid=float(torch.abs(sg["grid_density"] - kg).max()) / scale,
                         al_le_max_abs_err=float(torch.abs(sle - ke).max()),
                         al_le_beyond_gate=sle_beyond))
            check(r["loss_rel_err"] <= HET_GRAD_LOSS_RTOL,
                  f"het_grad_path, {label}, {what}: loss {kl} vs plain {pl}")
            check(beyond == 0, f"het_grad_path, {label}, {what}: {beyond} grid cells "
                               f"beyond the gate (max abs err {r['grid_max_abs_err']}, "
                               f"max |g| {scale})")
            check(le_beyond == 0, f"het_grad_path, {label}, {what}: d loss / d Le "
                                  f"{ke.tolist()} vs plain {pe.tolist()}")
            check(bool(torch.isfinite(kg).all()), f"{label}, {what}: non-finite gradient")
            # the same step through the public function: the same draws, each
            # lane's image bitwise (so the loss too), the grid and Le up to the
            # order of the sums (step_pair replays both streams in one launch)
            check(r["step_fn_vs_kernels"]["loss"] == 0.0,
                  f"{label}, {what}: step()'s loss {float(sl)} is not its kernels' {kl}")
            check(r["step_fn_vs_kernels"]["grid"] <= HET_GRAD_ATOL_REL,
                  f"{label}, {what}: step() differs from its own kernels")
            check(sle_beyond == 0 and not bool(sg["al_le"][ke.shape[0]:].any()),
                  f"{label}, {what}: step()'s d loss / d Le {sle.tolist()} is not its "
                  f"kernels' {ke.tolist()}")
            case[what] = r
        # pass A on the live grid's corner table against pass A by eight
        # corner loads, and pass B's recomputed radiance against pass A's:
        # every lane, bitwise
        packed = mkk.pack_corners(grid)
        img_a = hk.het_path(hc, o, d, keys, density=grid, packed=packed)
        img_dense = hk.het_path(hc, o, d, keys, density=grid)
        rfac = (2.0 * (img_a - img0 * 0.7 - 0.01) / (n * 3)).contiguous()
        img_b, _, _ = hk.het_grad_path(hc, o, d, keys, img_a, rfac, grid, packed=packed)
        torch.cuda.synchronize()
        packed_lanes = int((img_a != img_dense).any(dim=1).sum())
        check(packed_lanes == 0, f"het_path, {label}: the corner table's radiance differs "
                                 f"from the dense grid's on {packed_lanes} of {n} lanes")
        diff = torch.abs(img_b - img_a)
        lanes_beyond = int((diff > HET_REPLAY_RTOL * torch.abs(img_a) + HET_REPLAY_ATOL)
                           .any(dim=1).sum())
        case["replay_vs_pass_a"] = dict(
            max_abs_err=float(diff.max()), lanes_not_bitwise=int((diff > 0).any(dim=1).sum()),
            lanes_beyond_gate=lanes_beyond)
        case["pass_a_packed_vs_dense_lanes_differ"] = packed_lanes
        check(case["replay_vs_pass_a"]["lanes_not_bitwise"] == 0,
              f"het_grad_path, {label}: pass B's radiance differs from pass A's on "
              f"{case['replay_vs_pass_a']['lanes_not_bitwise']} of {n} lanes "
              f"({lanes_beyond} beyond {HET_REPLAY_RTOL} / {HET_REPLAY_ATOL})")
        case["ms_packed"] = median_ms(
            lambda: hk.het_grad_path(hc, o, d, keys, img_a, rfac, grid, packed=packed),
            reps, flush)
        case["ms_dense"] = median_ms(
            lambda: hk.het_grad_path(hc, o, d, keys, img_a, rfac, grid), reps, flush)
        # the step functions' route: a grid of at most PACK_MIN cells is read
        # by corner loads
        case["ms"] = case["ms_packed" if grid.numel() > mkk.PACK_MIN else "ms_dense"]
        stats, tally = live_grid_tally(hc, o, d, keys, grid)
        case.update(het_grad_bound(tables, n, int(hc.ic[0]), int(hc.ic[1]), stats, tally))
        case["max_abs_err"] = max(case[k]["grid_max_abs_err"] for k in ("step", "step_pair"))
        cases.append(case)

    # K10 on the nee preset's full 780x585 camera rays (sample 0, zero target)
    st = scene_statics(nee_tables)
    cam = scenes[2][2]
    hc = hk._het_consts(nee_tables, st, ncfg.max_depth, True, ncfg.max_steps or None,
                        None, grad_sampling=True)
    ids, xy = window_pixels(ncfg.width, ncfg.height, None, device)
    keys, o, d = het_grad_rays(cam, ncfg.width, ncfg.height, ids, xy, 0, 0)
    grid = nee_tables.grid_density.contiguous()
    packed = mkk.pack_corners(grid)
    img_a = hk.het_path(hc, o, d, keys, density=grid, packed=packed)
    img_dense = hk.het_path(hc, o, d, keys, density=grid)
    n = int(ids.shape[0])
    rfac = (2.0 * img_a / (n * 3)).contiguous()
    img_b, gle, gg = hk.het_grad_path(hc, o, d, keys, img_a, rfac, grid, packed=packed)
    torch.cuda.synchronize()
    packed_lanes = int((img_a != img_dense).any(dim=1).sum())
    check(packed_lanes == 0, f"het_path, nee full frame: the corner table's radiance differs "
                             f"from the dense grid's on {packed_lanes} of {n} lanes")
    diff = torch.abs(img_b - img_a)
    full = dict(case=f"nee {ncfg.width}x{ncfg.height}, zero target", n=n,
                max_depth=ncfg.max_depth, max_steps=hc.max_steps,
                replay_vs_pass_a=dict(max_abs_err=float(diff.max()),
                                      lanes_not_bitwise=int((diff > 0).any(dim=1).sum())),
                grad_finite=bool(torch.isfinite(gg).all()),
                grad_max_abs=float(torch.abs(gg).max()))
    check(full["grad_finite"] and bool(torch.isfinite(gle).all()),
          "het_grad_path, nee full frame: non-finite gradient")
    check(full["replay_vs_pass_a"]["lanes_not_bitwise"] == 0,
          f"het_grad_path, nee full frame: pass B's radiance differs from pass A's on "
          f"{full['replay_vs_pass_a']['lanes_not_bitwise']} of {n} lanes")
    stats = {}
    with TrackingTally() as tally:
        hk.het_path_plain(hc, o, d, keys, stats)
    full.update(ms=median_ms(
                    lambda: hk.het_grad_path(hc, o, d, keys, img_a, rfac, grid, packed=packed),
                    reps, flush),
                ms_dense=median_ms(lambda: hk.het_grad_path(hc, o, d, keys, img_a, rfac, grid),
                                   reps, flush),
                pass_a_ms=median_ms(
                    lambda: hk.het_path(hc, o, d, keys, density=grid, packed=packed),
                    reps, flush),
                pass_a_dense_ms=median_ms(lambda: hk.het_path(hc, o, d, keys, density=grid),
                                          reps, flush),
                **het_grad_bound(nee_tables, n, int(hc.ic[0]), int(hc.ic[1]), stats, tally))
    emit("kernel_checks", kernels="heterogeneous gradient", cases=cases, full_frame=full,
         reps=reps, window=list(HET_GRAD_WINDOW),
         kernel_attrs=attrs["het_grad_path"],
         tolerances=dict(loss=HET_GRAD_LOSS_RTOL, grid=[HET_GRAD_RTOL, HET_GRAD_ATOL_REL],
                         al_le=[HET_GRAD_LE_RTOL, HET_GRAD_LE_ATOL],
                         replay=[HET_REPLAY_RTOL, HET_REPLAY_ATOL]))
    pack_entry = check_pack_corners(device, {
        "nee 64^3": (grid, nee_tables.grid_packed),
        "fit_volume blob 16^3": (scenes[1][8], None),
        "16^3 cloud": (cloud_grid, cloud.grid_packed)}, reps, flush)
    head = cases[2]
    return [pack_entry, dict(
        name="het_grad_path", route="cuda",
        source="xraytracer_tpu_torch/csrc/het_megakernel.cu",
        replaces=HET_GRAD_REPLACES, launches=None, launches_by_path=None,
        max_abs_err=max(c["max_abs_err"] for c in cases),
        err_of="d loss / d density per grid cell (step and step_pair) against the "
               "plain version (autograd on the same draws), worst case",
        ms=full["ms"], plain_ms=head["step"]["plain_ms"],
        plain_ms_of=f"{head['case']}, step: both passes of the plain version "
                    f"(the tape of the whole frame does not fit the card)",
        bound_ms=full["bound_ms"], bound_by=full["bound_by"], library_ms=None,
        shape=f"{full['case']}: N={full['n']} depth={full['max_depth']} grid=64^3 L=1",
        kernel_attrs=attrs["het_grad_path"],
        cases=[{k: c[k] for k in ("case", "n", "max_depth", "ms", "ms_dense", "ms_packed",
                                  "bound_ms", "bound_by")}
               for c in cases]
        + [{k: full[k] for k in ("case", "n", "max_depth", "ms", "ms_dense", "bound_ms",
                                 "bound_by", "pass_a_ms", "pass_a_dense_ms")}],
    )]


def phase_vol_grad_path(device, nee_scene):
    """The gradient of the L2 loss (zero target) w.r.t. the density grid and
    Le on the nee preset (depth 32, max_steps 110), by both routes a user
    calls: ``diff.try_make_fast_value_and_grad`` (pass A het_path + pass B
    het_grad_path per step) at the full 780x585, and autograd through
    ``diff.make_loss_fn(diff.make_radiance_fn(..., score_terms=True,
    grad_sampling=True))`` on the HET_GRAD_WINDOW (the whole frame's tape
    does not fit). One warm-up step at sample 0, then VOL_GRAD_STEPS
    (analytic) resp. VOL_GRAD_AUTOGRAD_STEPS (autograd) timed steps,
    counted from 0. Returns the counts of the two timed runs."""
    import torch

    from xraytracer_tpu_torch import diff
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.scene.builder import scene_statics

    ncfg = get_preset("nee")
    tables, camk = nee_scene
    st = scene_statics(tables)
    w, h = ncfg.width, ncfg.height
    cam = PinholeCamera.make(w / h, device=device, **camk)
    params = {"grid_density": tables.grid_density, "al_le": tables.al_le}
    fast = diff.try_make_fast_value_and_grad(tables, st, cam, w, h,
                                             max_depth=ncfg.max_depth, nee=True)
    check(fast is not None, "vol_grad_path: nee did not take the analytic route")
    radiance = diff.make_radiance_fn(tables, st, cam, w, h, max_depth=ncfg.max_depth,
                                     nee=True, max_steps=ncfg.max_steps or None,
                                     score_terms=True, grad_sampling=True)
    routes = (
        ("analytic", fast, None, VOL_GRAD_STEPS,
         {"het_path": VOL_GRAD_STEPS, "het_grad_path": VOL_GRAD_STEPS,
          "pack_corners": VOL_GRAD_STEPS}),
        ("autograd", diff.value_and_grad(diff.make_loss_fn(radiance)), HET_GRAD_WINDOW,
         VOL_GRAD_AUTOGRAD_STEPS, None),
    )
    out, by_path = {}, {}
    for route, fn, window, steps, expected in routes:
        ids, xy = window_pixels(w, h, window, device)
        target = torch.zeros((ids.shape[0], 3), device=device)
        val0, g0 = fn(params, ids, xy, target, 0)
        torch.cuda.synchronize()
        reset_all_counts()
        t0 = time.perf_counter()
        for s in range(1, 1 + steps):
            val, g = fn(params, ids, xy, target, s)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = all_counts()
        for name, c in counts.items():
            if expected is not None:
                check(c["launches"] == expected.get(name, 0),
                      f"vol_grad_path, {route}: {name} launched {c['launches']}x, "
                      f"expected {expected.get(name, 0)}")
            check(c["plain_calls"] == 0, f"vol_grad_path, {route}: plain calls of {name}")
        check(all(bool(torch.isfinite(v).all()) for v in g.values()),
              f"vol_grad_path, {route}: non-finite gradients")
        check(float(torch.abs(g["grid_density"]).max()) > 0.0,
              f"vol_grad_path, {route}: zero density gradient")
        by_path[f"vol_grad_path_{route}"] = counts
        n = int(ids.shape[0])
        out[route] = dict(
            pixels=n, window=None if window is None else list(window), seconds=secs,
            steps=steps, rays_per_s=n * steps / secs, loss_sample0=float(val0),
            launches={k: v["launches"] for k, v in counts.items() if v["launches"]})
    check(out["analytic"]["launches"].get("het_grad_path", 0) > 0,
          "vol_grad_path: het_grad_path never launched")
    emit("vol_grad_path", width=w, height=h, depth=ncfg.max_depth, target="zero",
         routes=out, analytic_rays_per_s=out["analytic"]["rays_per_s"],
         autodiff_rays_per_s=out["autograd"]["rays_per_s"])
    return by_path


def phase_fit_volume_path(device):
    """``tools.fit_volume.fit`` at its published 96x72, depth 6, 3 views, 2
    pairs, 64 target renders per view, FIT_VOL_STEPS steps through K9a +
    K10 (and one K9a render per view and step for its eval loss): the
    trainer a user runs, counted from 0. Its line is printed
    before the checks. Returns its counts."""
    import numpy as np

    from xraytracer_tpu_torch.tools.fit_volume import fit

    stats = {}
    reset_all_counts()
    t0 = time.perf_counter()
    hist, fitted, tgt = fit(steps=FIT_VOL_STEPS, device="cuda", stats=stats)
    secs = time.perf_counter() - t0
    counts = all_counts()
    views, pairs, target_pairs = 3, 2, 64
    # the step losses are product losses on fresh streams each: their noise
    # (~8 per step here) hides any trend, and at one fixed pair of streams
    # the loss sits on the target's own noise (~5.19, flat within 0.01 over
    # 600 steps); the fit's eval loss, the L2 error against the true blob's
    # render with the same draws, goes to 0 with the density error
    first, last = float(np.mean(hist[:4])), float(np.mean(hist[-4:]))
    ev = stats["eval_loss"]
    ev_first, ev_last = float(np.mean(ev[:4])), float(np.mean(ev[-4:]))
    mae = stats["mae"]
    c0, c1 = 4, 12
    # per step and view: one pass-A and one pass-B launch per pair (both
    # streams in one), one eval render; the 16^3 grid is read by corner
    # loads (media_kernels.PACK_MIN), so nothing is packed
    per_step = {"het_path": views * (pairs + 1), "het_grad_path": views * pairs}
    set_up = {"het_path": views * (target_pairs + 1)}
    expected = {k: set_up.get(k, 0) + FIT_VOL_STEPS * v for k, v in per_step.items()}
    emit("fit_volume_path", width=96, height=72, depth=6, views=views, pairs=pairs,
         target_pairs=target_pairs, steps=FIT_VOL_STEPS, seconds=secs,
         seconds_per_step=float(np.median(stats["step_seconds"])),
         loss_first4=first, loss_last4=last, loss=hist[:: max(1, len(hist) // 60)],
         eval_loss_first4=ev_first, eval_loss_last4=ev_last,
         eval_loss=ev[:: max(1, len(ev) // 60)],
         mae_start=mae[0], mae_end=mae[-1], mae=mae[:: max(1, len(mae) // 60)],
         center=float(fitted[c0:c1, c0:c1, c0:c1].mean()),
         outer=float((fitted.sum() - fitted[c0:c1, c0:c1, c0:c1].sum()) / (16 ** 3 - 8 ** 3)),
         n_rejected=stats["n_rejected"], grads_finite=stats["grads_finite"],
         launches={k: v["launches"] for k, v in counts.items() if v["launches"]},
         launches_per_step=per_step)
    for name, c in counts.items():
        check(c["launches"] == expected.get(name, 0),
              f"fit_volume_path: {name} launched {c['launches']}x, "
              f"expected {expected.get(name, 0)}")
        check(c["plain_calls"] == 0, f"fit_volume_path: plain calls of {name}")
    check(ev_last < ev_first, f"fit_volume_path: loss did not fall ({ev_first} -> {ev_last} "
                              f"against the blob's render with the same draws; {first} -> "
                              f"{last} on the steps' own)")
    check(mae[-1] < mae[0], f"fit_volume_path: density MAE did not fall ({mae[0]} -> {mae[-1]})")
    check(stats["grads_finite"] and bool(np.isfinite(hist).all()),
          "fit_volume_path: non-finite loss or gradient")
    check(stats["n_rejected"] == 0, f"fit_volume_path: {stats['n_rejected']} rejected samples")
    return counts


# --------------------------------------------------------------------------
# the last modules: parallel/ over torch.distributed, and the grid tools
# --------------------------------------------------------------------------
SHARD_WORLD = 2           # gloo ranks on one card (NCCL refuses two on one device)
SHARD_VPT_SPP = 64        # vpt through K6c on each rank's block, cut from 1024
SHARD_NEE_SPP = 16        # nee through K9c on each rank's block, cut from 1024
SHARD_SPP_AXIS = 8        # Cornell's spp axis: samples k, k + 2, ... on rank k
SHARD_COLLECTIVE_TIMEOUT_S = 120
SHARD_JOIN_TIMEOUT_S = 300
TOOLS_CLOUD = 64          # tools_path: the procedural cloud's resolution
TOOLS_SPP = 16            # tools_path: the nee preset's render, cut from 1024


def sum_counts(*runs):
    """Launch and plain-call counts of several counted runs, added."""
    out = {}
    for counts in runs:
        for name, c in counts.items():
            o = out.setdefault(name, {"launches": 0, "plain_calls": 0})
            o["launches"] += c["launches"]
            o["plain_calls"] += c["plain_calls"]
    return out


def check_counts(label, counts, expected):
    for name, c in counts.items():
        want = expected.get(name, 0)
        check(c["launches"] == want,
              f"{label}: {name} launched {c['launches']}x, expected {want}")
        check(c["plain_calls"] == 0, f"{label}: {c['plain_calls']} plain calls of {name}")


def shard_cases(device, group):
    """The cases of shard_path on ``group`` (a world of one: the single
    references), each counted from 0: (results, counts by case, expected
    launches by case)."""
    import torch

    from xraytracer_tpu_torch import cli, diff, parallel
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.renderer import (
        WavefrontRenderer,
        make_sample_fn,
        pixel_grid,
        pixel_sharding,
    )
    from xraytracer_tpu_torch.scene.builder import scene_statics

    sharding = pixel_sharding(group) if group.world > 1 else None
    out, counts, expected = {}, {}, {}
    cornell = None
    for label, cfg, kernel in (
            ("main", get_preset("cornellbox_gi", width=WIDTH, height=HEIGHT,
                                spp=MAIN_SPP), "mega_spp_persistent"),
            ("vpt", get_preset("vpt", spp=SHARD_VPT_SPP), "vol_spp_persistent"),
            ("nee", get_preset("nee", spp=SHARD_NEE_SPP), "het_spp_persistent")):
        tables, camk = cli.build_scene(cfg, device=device)
        # every rank renders rank 0's tables
        tables = parallel.replicated(group, tables)
        st = scene_statics(tables)
        cam = PinholeCamera.make(cfg.width / cfg.height, device=device, **camk)
        integ = cli.make_integrator(cfg, tables, st)
        r = WavefrontRenderer(tables, cam, integ, cfg.width, cfg.height,
                              seed=cfg.seed, sharding=sharding)
        if label == "main":
            cornell, cornell_cfg, cornell_st, cornell_cam, cornell_integ = (
                tables, cfg, st, cam, integ)
        reset_all_counts()
        res = r.render(cfg.spp)
        counts[label] = all_counts()
        expected[label] = {kernel: 1}
        check(res.n_rejected == 0, f"shard_path {label}: {res.n_rejected} rejected")
        out[label] = res.image
        out[f"{label}_seconds"] = res.seconds

    # Cornell's spp axis, one mega_path launch per sample of the rank
    ids, xy = pixel_grid(WIDTH, HEIGHT, order="raster", device=device)
    sample_once = make_sample_fn(cornell, cornell_cam, cornell_integ, WIDTH, HEIGHT,
                                 cornell_cfg.seed)
    reset_all_counts()
    acc, rej = parallel.spp_parallel_render(cornell, sample_once, ids, xy,
                                            SHARD_SPP_AXIS, group)
    counts["spp_axis"] = all_counts()
    expected["spp_axis"] = {"mega_path": len(range(group.rank, SHARD_SPP_AXIS, group.world))}
    check(int(rej) == 0, "shard_path spp_axis: rejected samples")
    out["spp_axis"] = (acc / SHARD_SPP_AXIS).cpu().numpy()

    # one analytic gradient step (K5) over the pixel split
    fast = diff.try_make_fast_value_and_grad(
        cornell, cornell_st, cornell_cam, WIDTH, HEIGHT, max_depth=DEPTH,
        cosine_sampling=True, group=group if sharding is not None else None)
    check(fast is not None, "shard_path: Cornell did not take the analytic route")
    params = {"mat_albedo": cornell.mat_albedo, "al_le": cornell.al_le}
    target = torch.zeros((WIDTH * HEIGHT, 3), device=device)
    reset_all_counts()
    loss, g = fast(params, ids, xy, target, GRAD_SAMPLE)
    counts["grad_step"] = all_counts()
    expected["grad_step"] = {"mega_grad_path": 1}
    out["grad_loss"] = float(loss)
    for k, v in g.items():
        out[f"grad_{k}"] = v.cpu().numpy()
    return out, counts, expected


def shard_rank(rank, world, backend, device, store, out_dir):
    """One rank of a split run on ``device``: join the group, run
    ``shard_cases``, save the results. Any failure exits non-zero."""
    import pickle

    import torch

    from xraytracer_tpu_torch import parallel

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    parallel.multihost_init(f"file://{store}", world, rank, backend=backend,
                            timeout=SHARD_COLLECTIVE_TIMEOUT_S)
    group = parallel.make_mesh(device)
    check((group.rank, group.world, group.backend) == (rank, world, backend),
          f"shard_path: rank {rank} joined as {group}")
    got = shard_cases(device, group)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(got, f)
    torch.distributed.destroy_process_group()


def run_split(label, backend, devices):
    """Spawn one ``shard_rank`` per entry of ``devices``, wait for all of
    them (killing any left at the time limit), check their exit codes,
    launch counts and that every rank returned the same results, and hold
    those against ``shard_cases`` in a world of one on ``devices[0]``.
    Returns (the ranks' results, the single ones, the checks' line fields,
    the counts summed over the ranks, the temporary directory)."""
    import multiprocessing
    import pickle
    import tempfile

    import numpy as np

    from xraytracer_tpu_torch import parallel

    world = len(devices)
    tmp = tempfile.mkdtemp(prefix="xrt_shard_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=shard_rank, args=(
        r, world, backend, str(devices[r]), os.path.join(tmp, "store"), tmp))
        for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, SHARD_JOIN_TIMEOUT_S - (time.perf_counter() - t0)))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    ranks_s = time.perf_counter() - t0
    check(not hung, f"{label}: ranks {hung} did not finish in {SHARD_JOIN_TIMEOUT_S} s")
    codes = [p.exitcode for p in procs]
    check(codes == [0] * world, f"{label}: rank exit codes {codes}")
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    got = ranks[0][0]
    for other in ranks[1:]:
        for k, v in got.items():
            if not k.endswith("_seconds"):
                check(np.array_equal(v, other[0][k]), f"{label}: ranks differ on {k}")
    per_rank = []
    for r, (_, counts, expected) in enumerate(ranks):
        for case, c in counts.items():
            check_counts(f"{label} rank {r} {case}", c, expected[case])
        per_rank.append(sum_counts(*counts.values()))

    # the single references, on one process (a world of one)
    want, _, _ = shard_cases(devices[0], parallel.PixelGroup(0, 1, devices[0]))
    bitwise = {}
    for case in ("main", "vpt", "nee"):
        bitwise[case] = bool(np.array_equal(got[case], want[case]))
        check(bitwise[case], f"{label} {case}: the split image differs from the "
                             f"single render at "
                             f"{int((got[case] != want[case]).any(axis=-1).sum())} pixels")
    spp_err = float(np.abs(got["spp_axis"] - want["spp_axis"]).max())
    check(spp_err <= 1e-5, f"{label} spp_axis: {spp_err} from single")
    check(abs(got["grad_loss"] - want["grad_loss"]) <= GRAD_LOSS_RTOL * abs(want["grad_loss"]),
          f"{label} grad_step: loss {got['grad_loss']} vs {want['grad_loss']}")
    grad_err = {}
    for k in ("mat_albedo", "al_le"):
        a, b = got[f"grad_{k}"], want[f"grad_{k}"]
        grad_err[k] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        check(bool((np.abs(a - b) <= GRAD_RTOL * np.abs(b)
                    + GRAD_ATOL_REL * np.abs(b).max()).all()),
              f"{label} grad_step: d loss / d {k} off by {grad_err[k]}")
    line = dict(
        world=world, backend=backend, devices=[str(d) for d in devices],
        ranks_seconds=ranks_s,
        cases=dict(main=dict(preset="cornellbox_gi", width=WIDTH, height=HEIGHT,
                             depth=DEPTH, spp=MAIN_SPP, route="mega_spp_persistent"),
                   vpt=dict(preset="vpt", spp=SHARD_VPT_SPP, route="vol_spp_persistent"),
                   nee=dict(preset="nee", spp=SHARD_NEE_SPP, route="het_spp_persistent"),
                   spp_axis=dict(preset="cornellbox_gi", spp=SHARD_SPP_AXIS,
                                 route="mega_path per sample"),
                   grad_step=dict(route="mega_grad_path", sample=GRAD_SAMPLE)),
        split_bitwise_single=bitwise, spp_axis_max_abs_err=spp_err,
        grad_loss=[got["grad_loss"], want["grad_loss"]], grad_rel_err=grad_err,
        render_seconds_rank0={c: got[f"{c}_seconds"] for c in ("main", "vpt", "nee")},
        render_seconds_single={c: want[f"{c}_seconds"] for c in ("main", "vpt", "nee")},
        launches_by_rank=[{k: v["launches"] for k, v in c.items() if v["launches"]}
                          for c in per_rank])
    return want, line, sum_counts(*per_rank), tmp


def phase_shard(device, main_result):
    """shard_path: the port's parallel/ on the card. Two gloo ranks on
    cuda:0 (spawned processes) each render their block of the lanes:
    cornellbox_gi at its 512 spp through K1c, vpt through K6c and nee through
    K9c at reduced spp, each bitwise the single render; Cornell's spp axis
    through K1a within 1e-5 of single; one analytic gradient step (K5) split
    against single; then ``--shard`` through the CLI in a world of one,
    bitwise main_path's image. Returns the counts summed over the ranks."""
    import numpy as np

    from xraytracer_tpu_torch import cli

    want, line, rank_counts, tmp = run_split(
        "shard_path", "gloo", [device] * SHARD_WORLD)
    check(np.array_equal(want["main"], main_result.image),
          "shard_path: the single render differs from main_path's")

    # --shard through the CLI: no launcher, so a world of one
    images = []
    write = cli.write_image
    cli.write_image = lambda path, img, gamma: images.append(img)
    os.environ.pop("WORLD_SIZE", None)
    try:
        reset_all_counts()
        check(cli.main(["--preset", "cornellbox_gi", "--shard",
                        "-o", os.path.join(tmp, "shard.png")]) == 0,
              "shard_path: the CLI failed")
        cli_counts = all_counts()
    finally:
        cli.write_image = write
    check_counts("shard_path cli", cli_counts, {"mega_spp_persistent": 1})
    check(len(images) == 1 and np.array_equal(images[0], main_result.image),
          "shard_path: --shard in a world of one differs from main_path's image")
    counts = sum_counts(rank_counts, cli_counts)
    emit("shard_path", **line, cli_world_of_one_bitwise_main=True,
         launches_cli={k: v["launches"] for k, v in cli_counts.items() if v["launches"]},
         plain_calls=sum(c["plain_calls"] for c in counts.values()))
    return counts


def phase_shard_nccl():
    """The same split over every card of the box, one rank per card under
    NCCL (``--nccl``; needs two cards or more): each rank renders its block
    of the lanes on its own card, the images bitwise the single render on
    cuda:0."""
    import torch

    n = torch.cuda.device_count()
    check(n >= 2, f"--nccl: needs two cards or more, found {n}")
    _, line, _, _ = run_split("shard_nccl", "nccl",
                              [torch.device("cuda", r) for r in range(n)])
    emit("shard_nccl", **line)


def phase_tools(device):
    """tools_path: the 64^3 procedural cloud written as .vdb (zip) by
    ``tools.vdb.write_vdb``, converted to .npy by ``tools.grid_convert``, and
    rendered by the CLI as ``--preset nee --density-grid`` at 780x585
    through K9c. The converted grid must be the window of the active voxels
    of the cloud, bitwise, and the image bitwise the render fed that window
    as an in-memory array."""
    import tempfile

    import numpy as np

    from xraytracer_tpu_torch import cli
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.config import get_preset
    from xraytracer_tpu_torch.renderer import render
    from xraytracer_tpu_torch.scene.builder import scene_statics
    from xraytracer_tpu_torch.scene.presets import procedural_cloud
    from xraytracer_tpu_torch.tools import grid_convert, vdb

    tmp = tempfile.mkdtemp(prefix="xrt_tools_")
    cloud = procedural_cloud((TOOLS_CLOUD,) * 3)
    p_vdb, p_npy = os.path.join(tmp, "cloud.vdb"), os.path.join(tmp, "cloud.npy")
    vdb.write_vdb(p_vdb, cloud, compression="zip")
    grid_convert.main([p_vdb, p_npy])
    conv = np.load(p_npy)
    g = vdb.read_vdb(p_vdb)
    lo, shape = np.asarray(g.bbox_min), conv.shape
    window = cloud[lo[0]:lo[0] + shape[0], lo[1]:lo[1] + shape[1], lo[2]:lo[2] + shape[2]]
    check(conv.dtype == np.float32 and np.array_equal(conv, window),
          "tools_path: the converted grid is not the cloud's active window")
    check(np.count_nonzero(window) == np.count_nonzero(cloud),
          "tools_path: an active voxel of the cloud lies outside the window")

    cfg = get_preset("nee", spp=TOOLS_SPP)
    images = []
    write = cli.write_image
    cli.write_image = lambda path, img, gamma: images.append(img)
    try:
        reset_all_counts()
        check(cli.main(["--preset", "nee", "--density-grid", p_npy, "--spp",
                        str(TOOLS_SPP), "-o", os.path.join(tmp, "nee.png")]) == 0,
              "tools_path: the CLI failed")
        counts = all_counts()
    finally:
        cli.write_image = write
    check_counts("tools_path", counts, {"het_spp_persistent": 1})
    tables, camk = cli.build_scene(cfg, device=device, density_grid=window.copy())
    st = scene_statics(tables)
    ref = render(tables, PinholeCamera.make(cfg.width / cfg.height, device=device, **camk),
                 cli.make_integrator(cfg, tables, st), cfg.width, cfg.height, cfg.spp,
                 seed=cfg.seed)
    check(len(images) == 1 and images[0].shape == (cfg.height, cfg.width, 3),
          "tools_path: no image")
    check(bool(np.isfinite(images[0]).all()) and float(images[0].mean()) > 0,
          "tools_path: the image is not finite and positive")
    check(np.array_equal(images[0], ref.image),
          "tools_path: the CLI's image differs from the in-memory window's")
    emit("tools_path", cloud=[TOOLS_CLOUD] * 3, vdb_bytes=os.path.getsize(p_vdb),
         compression="zip", window_min=lo.tolist(), window_shape=list(shape),
         width=cfg.width, height=cfg.height, depth=cfg.max_depth, spp=TOOLS_SPP,
         spp_cut=f"cut from {get_preset('nee').spp} to {TOOLS_SPP}",
         mean_radiance=float(images[0].mean()), bitwise_in_memory=True,
         route="fused (het_spp_persistent)",
         launches={k: v["launches"] for k, v in counts.items() if v["launches"]},
         plain_calls=sum(c["plain_calls"] for c in counts.values()))
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fmad-ab", action="store_true",
                    help="also build and check the sweeps with -fmad=false")
    ap.add_argument("--profile", action="store_true",
                    help="also trace the main path, 2 samples of the Cornell "
                         "wavefront route, the nee preset by its default route, "
                         "1 sample of its wavefront route, one step of each "
                         "surface gradient route and one analytic volume "
                         "gradient step with torch.profiler")
    ap.add_argument("--launch-bounds-ab", action="store_true",
                    help="also build the heterogeneous whole-path kernels under "
                         "other __launch_bounds__ caps and time them")
    ap.add_argument("--ab-csrc", action="append", default=[], metavar="NAME=DIR",
                    help="also build sweep.cu, media.cu, het_megakernel.cu, "
                         "megakernel.cu and vol_megakernel.cu from DIR (another copy "
                         "of xraytracer_tpu_torch/csrc, e.g. the parent commit's; each "
                         "where its sources differ from the package's) and hold "
                         "K1-K10 of that build against the package's own, bitwise, "
                         "timing both in turns; repeatable")
    ap.add_argument("--ab-only", action="store_true",
                    help="with --ab-csrc: run that comparison alone and stop "
                         "(no result line)")
    ap.add_argument("--k1b-probe", action="store_true",
                    help="build megakernel.cu with K1b walking every shadow ray "
                         "at once on a staged table, with and without -fmad=false, "
                         "count the pixels where K1b parts from K1c, and stop "
                         "(no result line)")
    ap.add_argument("--nccl", action="store_true",
                    help="run shard_path's split over every card of the box, one "
                         "rank per card under NCCL (two cards or more), against "
                         "the single render, and stop (no result line)")
    ap.add_argument("--frame", action="store_true",
                    help="run frame_path alone (the renderer's assembly on "
                         "the card, bitwise the host assembly, one frame "
                         "copy a render) and stop (no result line)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed launches per kernel and case (median)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script never falls back to the CPU",
              file=sys.stderr)
        return 1

    from xraytracer_tpu_torch import _build, cli
    from xraytracer_tpu_torch.config import get_preset

    t_start = time.perf_counter()
    device = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         kind=torch.cuda.get_device_name(0))
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must be off")

    t_build = time.perf_counter()
    paths = _build.build(verbose=True)
    build_s = time.perf_counter() - t_build
    emit("build", seconds=build_s, libraries=sorted(
        os.path.relpath(p, _HERE) for p in paths.values()),
        flags=" ".join(_build.NVCC_FLAGS))

    others = dict(a.split("=", 1) for a in args.ab_csrc)
    check(all(os.path.isdir(d) for d in others.values()), "--ab-csrc: no such directory")
    if others:
        phase_csrc_ab(device, cli.build_scene(get_preset("nee"), device=device),
                      cli.build_scene(get_preset("volume"), device=device), others,
                      args.reps)
        if args.ab_only:
            emit("total", seconds=time.perf_counter() - t_start)
            return 0
    check(not args.ab_only, "--ab-only needs --ab-csrc")

    if args.nccl:
        phase_shard_nccl()
        emit("total", seconds=time.perf_counter() - t_start)
        return 0
    if args.frame:
        phase_frame_path(device)
        emit("total", seconds=time.perf_counter() - t_start)
        return 0
    cfg = get_preset("cornellbox_gi", width=WIDTH, height=HEIGHT, spp=MAIN_SPP)
    check((cfg.width, cfg.height, cfg.max_depth, cfg.integrator) ==
          (WIDTH, HEIGHT, DEPTH, "gi"), "cornellbox_gi preset changed")
    cornell, cornell_cam = cli.build_scene(cfg, device=device)
    if args.k1b_probe:
        phase_k1b_probe(device, cornell, cornell_cam)
        emit("total", seconds=time.perf_counter() - t_start)
        return 0
    mesh, mesh_cam = mesh_scene(device)

    entries = phase_kernels(device, {
        "cornell": (cornell, cornell_cam, False),
        "mesh13k": (mesh, mesh_cam, True),
    }, args.reps, args.fmad_ab)
    merge_cases(entries, phase_delta_kernels(device, args.reps))
    entries += phase_mega_kernels(device, cornell, cornell_cam, args.reps)
    entries += phase_vol_kernels(device, args.reps)
    nee_scene = cli.build_scene(get_preset("nee"), device=device)
    volume_scene = cli.build_scene(get_preset("volume"), device=device)
    entries += phase_track_kernels(device, nee_scene, volume_scene, args.reps)
    entries += phase_het_kernels(device, nee_scene, volume_scene, args.reps)
    entries += phase_grad_kernels(device, cornell, cornell_cam, args.reps)
    entries += phase_het_grad_kernels(device, nee_scene, args.reps)
    if args.launch_bounds_ab:
        phase_launch_bounds_ab(device, nee_scene, volume_scene, args.reps)
    phase_golden(device)
    phase_cloud_golden(device)
    by_path = {}
    by_path["main_path"], main_result = phase_main(device, cfg, cornell, cornell_cam)
    main_mean = float(main_result.image.mean())
    phase_frame_path(device)
    by_path["fused_entry_points"] = phase_fused_entry_points(
        device, cfg, cornell, cornell_cam, main_mean)
    by_path.update(phase_wavefront(device, cfg, cornell, cornell_cam, main_mean))
    by_path["mesh_path"] = phase_mesh(device, mesh, mesh_cam)
    # the furnace, direct and Whitted integrators and the example preset, each
    # through the CLI's entry points at its preset's own size, and --obj
    for label, cfg_s in (("whitted_path", get_preset("whitted")),
                         ("example_path", get_preset("example")),
                         ("direct_path", get_preset("cornellbox", integrator="direct")),
                         ("furnace_path", get_preset("cornellbox", integrator="furnace"))):
        check((cfg_s.width, cfg_s.height, cfg_s.spp) == (WIDTH, HEIGHT, SURFACE_SPP),
              f"{label}: preset size changed")
        by_path[label], _ = phase_surface_path(label, device, cfg_s)
    by_path["obj_path"] = phase_obj_path(device)
    # the volume paths, each by its default route
    by_path["vpt_path"], vpt_result = phase_volume_path(
        "vpt_path", device, "vpt", "vpt", None,
        lambda c, chunks: {"vol_spp_persistent": chunks}, (96, 96))
    by_path["vpt_nee_path"], _ = phase_volume_path(
        "vpt_nee_path", device, "vpt", "vpt_nee", VPT_NEE_SPP,
        lambda c, chunks: {"vol_spp_persistent": chunks}, (96, 96))
    by_path["vol_entry_points"] = phase_vol_entry_points(
        device, float(vpt_result.image.mean()))
    by_path["nee_path"], nee_result = phase_volume_path(
        "nee_path", device, "nee", None, None,
        lambda c, chunks: {"het_spp_persistent": chunks},
        (REF_W, REF_H), scene=nee_scene)
    nee_mean = float(nee_result.image.mean())
    by_path["het_entry_points"] = phase_het_entry_points(device, nee_scene, nee_mean)
    by_path["nee_wavefront_path"] = phase_nee_wavefront(device, nee_scene, nee_mean)
    by_path["volume_path"], _ = phase_volume_path(
        "volume_path", device, "volume", None, None,
        lambda c, chunks: {"het_spp_persistent": chunks},
        (96, 96), scene=volume_scene)
    # the surface gradients: both routes of one loss, and the trainer
    by_path.update(phase_grad_path(device, cornell, cornell_cam))
    by_path["fit_path"] = phase_fit_path(device)
    # the volume gradients: both routes of one loss, and the trainer
    by_path.update(phase_vol_grad_path(device, nee_scene))
    by_path["fit_volume_path"] = phase_fit_volume_path(device)
    # the last modules: the pixel split over two ranks, and the grid tools
    by_path["shard_path"] = phase_shard(device, main_result)
    by_path["tools_path"] = phase_tools(device)
    # the path on which each kernel must have run, by that path's own count
    runs_on = {"mega_spp_persistent": "main_path", "chunk_boxes": "mesh_path",
               "mega_path": "fused_entry_points", "mega_spp": "fused_entry_points",
               "sweep_nearest": "tri_fn_path", "sweep_nearest_rec": "wavefront_path",
               "occluded_anyhit": "wavefront_path",
               "vol_spp_persistent": "vpt_path", "vol_path": "vol_entry_points",
               "vol_spp": "vol_entry_points", "track_sample": "nee_wavefront_path",
               "track_transmittance": "nee_wavefront_path",
               "het_spp_persistent": "nee_path", "het_path": "het_entry_points",
               "het_spp": "het_entry_points", "mega_grad_path": "grad_path_analytic",
               "het_grad_path": "vol_grad_path_analytic",
               "pack_corners": "vol_grad_path_analytic"}
    check(len(entries) == 18, "the kernels line must list eighteen kernels")
    for e in entries:
        e["runs_on"] = runs_on[e["name"]]
        e["launches_by_path"] = {
            path: counts[e["name"]]["launches"] for path, counts in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        check(e["launches_by_path"][runs_on[e["name"]]] > 0,
              f"{e['name']} was never launched on {runs_on[e['name']]}")
    if args.profile:
        phase_profile(device, cfg, cornell, cornell_cam)
        phase_profile_nee(device, nee_scene)
        phase_profile_grad(device, cornell, cornell_cam)
        phase_profile_vol_grad(device, nee_scene)

    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
