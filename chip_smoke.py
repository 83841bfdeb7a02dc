"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero without a result
line):

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles the kernels from pathtracer_tpu_torch/csrc with nvcc (one
   process per source, in parallel) and prints ptxas's registers, stack
   frame and spills for each kernel, and a census of its machine code
   (16-byte loads, local loads and stores, NaN-propagating min/max,
   convergence regions); K1-K4 may not spill and must fetch nodes and
   triangle rows in 16-byte loads, the box test must have compiled to
   NaN-propagating min/max without a convergence region of its own, and
   P2's node variants must read a node in 16-byte shared-memory loads;
3. resident kernel parity on scenes/glasstorus.txt (10,000 triangles) at
   800x800: K1 (closest hit) and K2 (shadow any-hit) against their plain
   PyTorch versions on the card, K1 on the 640,000 camera rays and one
   bounce's continuation rays, plus dead-lane and t-cap variants, K2 on two
   sets of NEE shadow rays toward the lamp (from the camera rays' hits and
   from the continuation rays' hits, the latter with ended paths as dead
   lanes), each also with occluded0 lanes and -FLT_MAX lanes; median times;
4. stream kernel parity on scenes/glasstorus160k.txt (160,000 triangles,
   past the resident budget) at 800x800, on the same kinds of rays: K3
   (closest hit) and K4 (shadow any-hit) against their plain versions, and
   against K1/K2 on the same mesh's wide tables (t bitwise equal, occlusion
   equal: a lost or doubled triangle of the split would show), K3, K4 and
   K5 through the tables derived for them with the scene (padded triangle
   rows, per-block rows, K5's padded root boxes and group boxes), whose
   16-byte alignment is asserted; K5 (block-major closest hit) against its
   plain version and against K3 (t bitwise equal, exact-t tie lanes
   counted); median times of K1, K3, K5 on the camera and the continuation
   rays, and the box tests per live lane of K5's walk (group, root and node
   tests) beside K3's;
5. the same K5-against-K3 check on scenes/glasstorus640k.txt (640,000
   triangles, stream tables past the L2), K4 against K2 there, the table
   bytes, and median times of K1, K3, K5 on both closest-hit ray sets and
   of K2 and K4 on both shadow sets there;
6. main paths, as a user calls them: Renderer(scene, MIS, device="cuda") at
   800x800, depth 8, 8 spp, for scenes/cornell_spheres.txt (the analytic
   Cornell box with all five materials: must launch none of K1-K5, and S1
   and S2), for glasstorus (must launch K1, K2, S1 and S2), for
   glasstorus160k (must launch K3
   and K4, and neither K1 nor K2), and for glasstorus640k twice, with
   STREAM_BLOCKMAJOR off (K3 and K4 only) and on (K5 and K4 only), the two
   images held to the slice tolerance; launch counts are zeroed just before
   each path and read just after; each scene's tables are built once and
   serve its kernel checks too;
7. textured and environment-lit main paths, as a user calls them, on the
   procedural assets that tools/make_texture_assets.py writes at first use:
   scenes/texcube.txt (albedo, metallic and roughness maps) and
   scenes/envtorus.txt (a 2048x1024 HDR sky, with env_importance on, so that
   the sky is a light whose shadow rays run through K2) at 800x800, depth 8,
   8 spp, MIS: each must launch K1 and K2 and no stream kernel; and the
   RGBE texel scale on the card equal to the CPU's for every exponent;
8. card against CPU: cornell_spheres, glasstorus and glasstorus160k (the
   latter with the flag off and on), texcube, normalcube (a normal map),
   envtorus and envtorus with env_importance at 64x64, depth 8, 2 spp, MIS,
   rendered on "cuda" and on "cpu", held to the CPU slice test's image
   tolerance;
9. the probes P1 and P2 against their plain versions bit for bit (P1 at
   2,000 laps and at 1, 3 and 5; every P2 variant at a small pop count, from
   the probe's accumulator start and from a small one); their times at the
   TPU probes' sizes with the SM clock sampled meanwhile: P1's ns and cycles
   a lap, every P2 variant's ns and cycles a pop, each beside its bound on
   one SM by term (probe_bound: operations, bytes, the accumulator's chain)
   and held to time >= bound / PROBE_SLACK;
10. the kernels on the pools the scheduler hands them: K1/K2 (glasstorus)
   and K3/K4 (glasstorus160k) against their plain versions on the sorted
   continuation pool of lap 1, on its first shrink-ladder prefix (a view of
   the sorted columns, not a copy), on a prefix of 40,001 lanes (not a
   multiple of a CTA), and on the NEE shadow rays from its hits sorted as
   the shadow sort sorts them (and a 40,001-lane prefix of those), and on
   the same rays in lane order and in the pool's order, with median times
   of each kernel on both orders; occlusion_test with the shadow sort equal
   to it without;
11. the scheduler and ray regeneration on the main paths of
   cornell_spheres, glasstorus, glasstorus160k, texcube and envtorus (env
   importance) at 800x800, depth 8, MIS, 1 + 8 spp, on the tables built for
   the earlier phases: compaction=False (no sort, no ladder), the default
   schedule (sort and ladder), and the shadow sort with the half level, whose
   HDR sums must be bitwise equal; and ray_regen=8 (the warm-up, then one
   batch of 8), within the image tolerance of them with the rays counted
   exactly equal.  Per path: s/iteration, launches of K1-K5 per iteration
   (counts zeroed just before the path, read just after; each path must
   launch its scene's kernels), device ops and host-issued launches in all
   and device-busy ms per sample under torch.profiler over one more
   iteration (or batch of 8), laps per sample and the pool's length at each
   lap;
12. checkpoint/resume on glasstorus (MIS, 800x800, depth 8): 3 spp,
   save_checkpoint, 2 more, against a new Renderer that loads the file and
   renders 2 (HDR sums bitwise equal, rays equal), the same with
   ray_regen=8, held also to an uninterrupted 5 spp within the tolerance;
13. the preview server (start_preview_thread on port 0) driven over HTTP:
   the page, /frame.png decoded (800x800), /stats.json rising, /orbit,
   /zoom and /pan each restarting accumulation, /mode?m=0 (the new
   renderer on the card in BSDF mode, the old one freed), /save; frames per
   second; K1 and K2 must launch;
14. `cli bench` on glasstorus (MIS, 800x800, 8 spp): its JSON line beside the
   card's name and power limit;
15. the plain walks: the MTBVH walk's triangle ids against K1 (glasstorus),
   K3 (glasstorus160k, six trees; glasstorus640k, one tree, checked beside
   phase 6) on the camera rays and one bounce's continuation pool, the sweep's
   against K1 on 4,077 of glasstorus's lanes (lanes that differ must be
   exact-t ties); 128x128 MIS renders with pallas_traversal=False and with
   use_bvh=False held to the default render, seconds per iteration each,
   launching none of K1-K5 (S1 and S2 sweep the walls on every route);
16. sharding over the visible cards (the first min(4, count) distinct ones;
   with one card, [cuda:0, cuda:0], logged as measuring no concurrency):
   Renderer(devices=N) on the graph route (each shard's iteration replayed
   as CUDA graphs on its own card, the shards' laps in lockstep) against
   the one-device graph route with the swizzle off, HDR sums bitwise and
   rays equal, on glasstorus (K1/K2), glasstorus160k (K3/K4),
   cornell_spheres at 800x800 depth 8 MIS, and glasstorus at 800x799, which
   pads rows; K1-K5 launches equal to the sum of the shards' counters and,
   for one more iteration under the profiler (glasstorus, glasstorus160k),
   to what each card runs; printed: s/iteration, medians of 5, of the
   one-device graphs, the sharded graphs and (glasstorus) the shards in
   turn on the eager loop (its image bitwise too);
   each shard's capture seconds, each card's memory reserved at most and
   device-busy ms; then sample_parallel_step bitwise the sequential
   iterations.  Held under SHARD_PHASE_S;
17. profiling: the program's spans (utils/profiling.py) on glasstorus's
   graph route: a step with tracing on (it captures the traced graphs)
   bitwise the untraced step from the same state, the untraced graphs'
   nodes unchanged; three traced steps' device ms by step key and by stage
   and the idle gaps by host span (Tracer.summary); %globaltimer's
   resolution; one traced step under device_trace, where each replay's
   device span must bracket its graph launch's kernels in the profiler's
   trace (the edges' error printed); the trace's top 10 device ops
   (top_ops_from_trace);
18. a mesh that fits neither kernel table: glasstorus built with both
   budgets at 0 (restored after) has no streaming split, its walk_route the
   MTBVH walk off the kernels and ray_regen ignored; closest_hit's
   triangle ids on the 640,000 camera rays against K1's on the normal build
   (lanes that differ must be exact-t ties); a 128x128 MIS render, depth 8,
   2 spp, that launches none of K1-K5 (S1 and S2 do), held to the normal
   build's render, with both seconds per iteration;
19. the independent oracle (tools/oracle.py, numpy, on the host's CPU)
   against the port on the card through tools/oracle_compare_torch.py:
   cornell_spheres MIS (64 spp) and envtorus MIS with env importance on the
   port's side (32 spp), 32x32, seeds 0 and 1; each row's cross RMSE after
   the display transform must not exceed the quadrature of the two noise
   floors;
20. the driver entry (pathtracer_tpu_torch/entry.py), as a driver calls it:
   entry()'s step on the card ((4096, 3), rays > 0, depth >= 1) bitwise a
   Renderer's first iteration of cornell_spheres at 64x64, depth 4, MIS,
   launching none of K1-K5; then dryrun_multichip over phase 16's mesh:
   pixel sharding on cornell_spheres and on glasstorus (K1 and K2 must
   launch, K3-K5 not) and sample sharding, each pass bitwise the one-device
   steps; the phase's seconds beside the card's name and power limit, held
   under ENTRY_PHASE_S;
21. the Renderer's compiled iteration (integrator/graphs.py): on glasstorus
   (K1/K2), glasstorus160k (K3/K4), cornell_spheres, texcube, envtorus with
   env_importance and glasstorus with ray_regen=8, MIS 800x800 depth 8, the
   Renderer's graph route against its eager loop (render_iteration, the
   route switched off in this process) over the same iterations: HDR sums
   bitwise, rays, laps and the pool's length at each lap equal, K1-K5
   launches per iteration equal; the graph route may not enter the eager
   loop.  Printed: the graphs captured and their seconds, replays per
   iteration, the memory reserved, s/iteration of both paths (medians of 5
   iterations, or under ray_regen of 5 batches of 2 samples, per sample;
   glasstorus also at 128x128), the case's seconds, and, for one more
   iteration under the profiler (glasstorus on both routes, glasstorus160k
   on the graph route), host-issued launches and device-busy ms, and K1-K5's
   runs on the device, which must equal the launch counters over it and the
   eager loop's launches an iteration.  The cases of one scene and film
   share one Renderer, the options swapped in.  After the 128x128 case's
   timed steps, a set_seed and then a set_orbit, a step after each, on both
   paths: the images bitwise equal, the graphs recaptured for the seed.
   Held under GRAPH_PHASE_S;
22. the analytic sweep (run after phase 2, on cornell_spheres and then on
   glasstorus, at 800x800): S1 (geoms_closest) and S2 (geoms_occluded)
   against their plain versions, bit for bit on every output and lane, on
   the camera rays, one bounce's continuation pool and the camera origins
   with axis directions (S1), and the shadow rays toward the lamp from the
   camera and the continuation hits (S2); each wrapper launches once a
   call; median times of kernel and plain version beside the bound
   (sweep_bound: bytes once, or SWEEP_OPS over half the float32 peak).
   The main paths of phase 6 on cornell_spheres and glasstorus must launch
   S1 and S2 through their graphs' replays;
23. the material lobes (run after phase 22, on cornell_spheres and then on
   glasstorus, at 800x800): M1 (scatter_lobes) against pixel_uniforms +
   scatter_sample and M2 (eval_lobes) against bsdf_eval + pdf_eval, bit for
   bit on every output and lane, NaN where NaN, on the shading inputs of the
   camera lap and the continuation lap (bounce's trace), and on the camera
   lap with edge values spliced in (grazing rays, roughness at its clamps,
   metallic 0 and 1, ior 1, NaN inputs) and per-lane and one-word counters;
   M1's draw alone against pixel_uniforms word for word; each wrapper
   launches once a call; median times of kernel and plain version beside the
   bound (shade_bound: SHADE_BYTES once, or SHADE_OPS over half the float32
   peak).  The main paths of phase 6 on cornell_spheres and glasstorus must
   launch M1 and M2 through their graphs' replays;
24. the light side of NEE (run after phase 23, on cornell_spheres and then
   on glasstorus, at 800x800): L1 (sample_lights) against pixel_uniforms
   (STAGE_LIGHT) + light_samples, with the MIS lap's NEE mask and without,
   and L2 (eval_light_pdf) against light_pdf, bit for bit on every output
   and lane, NaN where NaN, on the camera lap and the continuation lap
   (bounce's trace) and on the camera lap with per-lane counters, a first
   pixel past the film and NaN points; each wrapper launches once a call;
   median times of kernel and plain version beside the bound (light_bound:
   LIGHT_BYTES once, or LIGHT_OPS over half the float32 peak).  The main
   paths of phase 6 on cornell_spheres and glasstorus must launch L1 and L2
   through their graphs' replays.  tests/test_torch_lights_cuda.py's card
   cases add cube and triangle lights and the environment's split.

Every Renderer on the card (phases 6-8, 11-14, 16, 18-19, 21) replays its
iteration as CUDA graphs, and so do the step factory and the sharded steps
(phases 16, 20), but for the triangle scenes off the kernels (phase 15's
and 18's walks), which run the eager loop as the JAX Renderer runs them
staged; the main path (phase 6) must replay graphs.

    python tools/shard_cards.py

runs phases 1, 2, 16 and 20 alone (for a machine with four cards).

The line before the last is a JSON object with one entry per kernel (times,
errors, launches, and the least time the card could take for the same work:
for P1 and P2, the least time on the one SM each runs on);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from pathtracer_tpu_torch.ops import _build
from tools.cuda_timing import median_ms

ROOT = Path(__file__).resolve().parent
SCENE_CORNELL = ROOT / "scenes" / "cornell_spheres.txt"
SCENE = ROOT / "scenes" / "glasstorus.txt"
SCENE_160K = ROOT / "scenes" / "glasstorus160k.txt"
SCENE_640K = ROOT / "scenes" / "glasstorus640k.txt"
SCENE_TEXCUBE = ROOT / "scenes" / "texcube.txt"
SCENE_NORMALCUBE = ROOT / "scenes" / "normalcube.txt"
SCENE_ENVTORUS = ROOT / "scenes" / "envtorus.txt"
TORUS_160K = (ROOT / "scenes" / "assets" / "torus160k.obj", 400, 200)
TORUS_640K = (ROOT / "scenes" / "assets" / "torus640k.obj", 800, 400)
RES, DEPTH, SPP = 800, 8, 8
DEVICE = "cuda"
IMG_RTOL, IMG_ATOL, IMG_MIN_FRAC = 1e-4, 1e-5, 0.999  # tests/test_torch_render.py
# the schedules held bitwise equal on the main paths, and the regeneration batch
SCHEDULES = (("compaction=False", {"compaction": False}), ("default schedule", {}),
             ("shadow_sort, shrink_half", {"shadow_sort": True, "shrink_half": True}))
REGEN_K = 8
ODD_PREFIX = 40_001  # lanes: not a multiple of the kernels' 128-thread CTAs
KERNEL_RTOL = 1e-5
# P2: pops per parity check from the probe's start and from a small one, and
# per timed call of the kernels line (the plain version takes one Python step
# per pop, so not the probe's 20,000).  The small start's P2_WRAP_F pops run
# past the 311 nodes (loads4: 4 a pop), so every variant's node index wraps;
# the probe's start 1e30 absorbs each pop's addend, so it would not show a
# node read out of turn.
P2_CHECK_F, P2_WRAP_F, P2_ROW_F, P2_ROW = 64, 320, 500, "push_branchless"
# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): float32 outside the
# tensor cores, and device memory.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# Operations of one box test (csrc/traverse_common.cuh slab: 6 subtractions,
# 6 multiplications, 10 min/max, 2 comparisons, and the comparison with the
# ray's cap) and one triangle test (moller_trumbore: 27 multiplications, 19
# additions or subtractions, 1 division, 1 select, 6 comparisons, and the
# comparison with the ray's best t or window).
BOX_OPS, TRI_OPS = 25, 55
# The probes' bound on one SM (probe_bound).  Each probe is a serial chain of
# laps on one tile, one CTA on one SM, so the chip-wide rates above do not
# bound it.  The SM's rates: 128 FP32/INT lanes a clock (4 schedulers of 32),
# 128 bytes a clock into shared memory or out of L1 (32 banks of 4 bytes a
# clock; CUDA C++ Programming Guide, "Shared Memory"), and 4 clocks for each
# dependent arithmetic operation (the same guide, "Multiprocessor Level":
# typically 4 clock cycles for most arithmetic instructions, compute
# capability 7.x on; P2's loop_empty, one dependent add a lap with its loop's
# counter, compare and branch, measures at most that plus the loop).
SM_LANES, SM_BYTES_PER_CLOCK, DEP_CLOCKS = 128, 128, 4
P2_LANES_PER_SM = 128  # one CTA of 128 lanes on each of 16 SMs
# Per lap of P1 and per pop of each P2 variant: the function's operations on
# the SM that carries the most lanes, the bytes the lap brings to that SM, and
# the operations of the accumulator's dependent chain (csrc/probes.cu's header
# note says where each count comes from).
#   P1: 8 columns x 1,024 lanes x (2 comparisons, the and, the any), 1,023
#       adds of the row sum, 8 of the bits, 2 of the accumulator; 8 rows of
#       512 bytes from L2; the accumulator's two adds.
#   P2, per lane: a box test BOX_OPS (its cap comparison included), a vote,
#       a link test or a push 1 each, a triangle test TRI_OPS with its 6 edge
#       subtractions and the select of the hit; the node's 8 boxes (192
#       bytes) and links (32); the chain as the cheapest form that keeps the
#       result: aabb compare, select, add for each child; the votes' variants
#       compare, vote (or OR), count, convert, multiply, add; any1 compare,
#       vote, select, add; the loops and leaf_mt one add or select.
_P2_PER_LANE = {  # variant: (operations a lane, bytes, chain operations)
    "loop_empty": (1, 0, 1),
    "while_empty": (3, 0, 1),  # the counter's add and compare, the add
    "loop_and": (3, 0, 1),  # and, convert, add
    "loop_only": (3, 0, 1),  # remainder, convert, add
    "loads": (56 + 8 + 1, 224, 1),  # 56 adds, 8 conversions, the add
    "loads4": (4 * (56 + 8) + 1, 4 * 224, 1),
    "aabb": (8 * (BOX_OPS + 4), 224, 8 * 3),  # + link add, convert, multiply, add
    "any1": (BOX_OPS + 3, 24, 4),  # one box: + vote, select, add
    "aabb_any": (8 * (BOX_OPS + 2) + 3, 192, 6),  # + vote, count; convert, multiply, add
    "push_branchless": (8 * (BOX_OPS + 3) + 3, 224, 6),  # + vote, link test, push
    "push_packed": (8 * (BOX_OPS + 1 + 3) + 1 + 3, 224, 6),  # + pack bit; the OR
    "leaf_mt": (8 * (TRI_OPS + 6 + 1), 8 * 36, 1),
}
PROBE_COUNTS = {"P1": (8 * 1024 * 4 + 1023 + 8 + 2, 8 * 512, 2)} | {
    v: (ops * P2_LANES_PER_SM, nb, chain) for v, (ops, nb, chain) in _P2_PER_LANE.items()}
# a probe whose time is under its bound / PROBE_SLACK fails: the bound is wrong
PROBE_SLACK = 1.05
# The kernels of csrc/walk_core.cuh, K1, K3, K5 (closest hit) and K2, K4 (any
# hit), with the 16-byte loads each must hold at least: 12 for a node's boxes,
# 2 for its links, 3 for a triangle row, of which the compiler may narrow the
# third to the one float of it that counts (e2z), as it does in the any-hit walk
WALK_KERNELS = {"closest_hit_wbvh_kernel": 17, "closest_hit_stream_kernel": 17,
                "closest_hit_blockmajor_kernel": 17,
                "occlusion_wbvh_kernel": 16, "occlusion_stream_kernel": 16}
# the P2 variants that read whole nodes (csrc/walk_core.cuh fetch_node's loads)
P2_FETCH_KERNELS = tuple(f"p2_{v}_kernel" for v in (
    "loads", "loads4", "aabb", "aabb_any", "push_branchless", "push_packed"))
# convergence regions of K2, K4 and K5 before they took the shared walk
BSSY_BEFORE = {"occlusion_wbvh_kernel": 29, "occlusion_stream_kernel": 61,
               "closest_hit_blockmajor_kernel": 31}
CLOSEST_SETS = ("camera", "continuation")  # the kernels line's times are the second set's
SHADOW_SETS = ("NEE", "NEE continuation")  # the kernels line's times are the first set's
SRC_RESIDENT = "pathtracer_tpu_torch/csrc/wbvh_traverse.cu"
SRC_STREAM = "pathtracer_tpu_torch/csrc/stream_traverse.cu"
SRC_PROBES = "pathtracer_tpu_torch/csrc/probes.cu"
SRC_SWEEP = "pathtracer_tpu_torch/csrc/analytic_sweep.cu"
SRC_SHADE = "pathtracer_tpu_torch/csrc/shade.cu"
SRC_LIGHTS = "pathtracer_tpu_torch/csrc/lights.cu"
WALK_TAGS = ("K1", "K2", "K3", "K4", "K5")  # the triangle walks; S1/S2 sweep on every route
# Operations a lane of the analytic sweep (csrc/analytic_sweep.cu), each
# multiplication, addition, comparison, min/max and select one, a division or
# a square root one: per geom tested, S1's (with the winner's bookkeeping) and
# S2's (with the window), by type; and the winner's world normal, once a hit
# lane in S1 (an xform_vector and a normalize).  Without fused multiply-adds
# (-fmad=false) a lane does one a clock: half the float32 peak, which counts
# an FMA as two.
#   common: xform_point 18, xform_vector 15, normalize 13; the pull-back 7,
#     xform_point 18, the world t 10
#   sphere: vdd 5, radicand 8, root 2, t1/t2 3, validity 3, t_obj 5
#   cube: slabs 12 (6 of them divisions), gating 9, tmin 2, tmax 5, validity
#     2, t_obj 2; S1's normal 18
#   S1's strictly-nearer test 2 and 8 selects; S2's window 4
SWEEP_OPS = {"S1": {0: 117, 1: 141}, "S2": {0: 111, 1: 117}}
SWEEP_NORMAL_OPS = 28
SWEEP_OP_RATE = PEAK_FLOPS / 2
# Operations a lane of the material lobes (csrc/shade.cu), counted as
# SWEEP_OPS counts them (sinf, cosf, a division or a square root one), by
# material type (0 Lambertian, 1 MetallicWorkflow, 2 Dielectric, 3
# Microfacet, 4 Light); each lobe's longest branch.
#   M1's draw (every type but Light): threefry-2x32 twice, 2 + 20 x 5 (add,
#     two shifts, or, xor) + 5 x 2 key injections = 112 each, the third key
#     word 2, the counter word 6, the pixel 1, three uniforms 9: 242
#   shared: onb_pixar 14; normalize 11; ops/materials.py's GGX terms (a2, the
#     two cosines, the half vector, the NDF, the Fresnel cosine) 45;
#     smith_g2 20, smith_g1 11, fresnel_schlick 13
#   M1 Lambertian: bsdf 3, cosine hemisphere 24 + onb, pdf 6: 47
#   M1 Dielectric: the cosine and side 9, fresnel_maxwell 30, refract_dir 42
#     (reflect_dir 26), the scale 4, |cos| 7, bsdf 6, the pick 1: 99
#   M1 Microfacet: wo_out 3, the VNDF sample 142, reflect 12, the GGX terms,
#     the bad test 2, microfacet_bsdf 44, microfacet_pdf 15, selects 4: 267
#   M1 MetallicWorkflow: wo_out 3, the lobe pick 3, the VNDF sample 143 and
#     reflect 12, the GGX terms, the bad test 3, metallic_bsdf 69,
#     metallic_pdf 22, selects 4: 304
#   M2: Lambertian 9; Microfacet wo_out 3, the GGX terms, bsdf 44, pdf 15:
#     107; MetallicWorkflow 3 + 45 + 69 + 22: 139; Dielectric and Light 0
SHADE_DRAW_OPS = 242
SHADE_OPS = {"M1": {0: SHADE_DRAW_OPS + 47, 1: SHADE_DRAW_OPS + 304, 2: SHADE_DRAW_OPS + 99,
                    3: SHADE_DRAW_OPS + 267, 4: 0},
             "M2": {0: 9, 1: 139, 2: 0, 3: 107, 4: 0}}
# Bytes a lane, each input read once and each output written once: M1 reads
# type, albedo, roughness, metallic, ior, emission, normal, ray direction and
# lane id (68) and writes bsdf, pdf and direction (28); M2 reads type, albedo,
# roughness, metallic, normal, ray and light directions (60) and writes bsdf
# and pdf (16)
SHADE_BYTES = {"M1": 68 + 28, "M2": 60 + 16}
# Operations a lane of the light side of NEE (csrc/lights.cu), counted as
# SWEEP_OPS counts them (sinf, cosf, a division or a square root one), by the
# branch a lane runs.
#   L1's draw: SHADE_DRAW_OPS and the fourth uniform 3: 245; the pick (a
#     multiply, a min, the conversion, the env test, the index clamp 2, the
#     emission's select) 7; the tail (the direction 14, the shadow origin 6,
#     the mask 2) 22
#   L1 sphere: xform_point 18, normalize 14, onb_pixar 14, the cone's cosine
#     11, cos_t 3, sin_t 4, phi 1, dc 2, ds 8, sin_a 2, cos_a 4, cos/sin and
#     their products 4, the object normal 18, the pdf 4, the scale 3,
#     xform_point 18: 128
#   L1 triangle: the barycentrics 6, the point 15, the normal 26, the area
#     23, the pdf 31: 101; a cube light or the environment: none
#   L2: the branch tests 3; a sphere: xform_point 18, the cone's cosine 11,
#     the pdf 4: 33; a triangle: the area 23, the pdf 31: 54
LIGHT_OPS = {"L1": {"sphere": 245 + 7 + 128 + 22, "triangle": 245 + 7 + 101 + 22,
                    "other": 245 + 7 + 22},
             "L2": {"sphere": 3 + 33, "triangle": 3 + 54, "other": 3}}
# Bytes a lane, each input read once and each output written once: L1 reads
# the view point, lane id and NEE mask (17) and writes the light point,
# emission, pdf, shadow origin and direction and mask (53); L2 reads the ray
# origin, hit point, normal, triangle and geom (44) and writes the pdf (4)
LIGHT_BYTES = {"L1": 17 + 53, "L2": 44 + 4}
ENTRY_PHASE_S = 30.0  # phase 20 fails past this many seconds
GRAPH_PHASE_S = 60.0  # phase 21 fails past this many seconds
SHARD_PHASE_S = 90.0  # phase 16 fails past this many seconds
SHARD_CARDS, SHARD_ITERS = 4, 5  # phase 16: distinct cards at most, timed iterations
SHARD_CASES = (  # phase 16: name, scene, film, kernels it launches, profiled
    ("glasstorus", SCENE, (RES, RES), ("K1", "K2"), True),
    ("glasstorus160k", SCENE_160K, (RES, RES), ("K3", "K4"), True),
    ("cornell_spheres", SCENE_CORNELL, (RES, RES), (), False),
    (f"glasstorus {RES}x{RES - 1}", SCENE, (RES, RES - 1), ("K1", "K2"), False),
)
GRAPH_CASES = (  # phase 21: name, scene, options, kernels it launches, the timed steps
    ("glasstorus", SCENE, {}, ("K1", "K2"), (1,) * 5),
    # five batches of 2 samples (refills and all): on H100 machines the eager loop's 40 samples
    # of five full batches took 21 s of the phase, its 20 of five batches of 4 up to 10 s
    (f"glasstorus ray_regen={REGEN_K}", SCENE, {"ray_regen": REGEN_K}, ("K1", "K2"), (2,) * 5),
    ("glasstorus160k", SCENE_160K, {}, ("K3", "K4"), (1,) * 5),
    ("cornell_spheres", SCENE_CORNELL, {}, (), (1,) * 5),
    ("texcube", SCENE_TEXCUBE, {}, ("K1", "K2"), (1,) * 5),
    ("envtorus env_importance", SCENE_ENVTORUS, {"env_importance": True}, ("K1", "K2"), (1,) * 5),
)
# phase 21 profiles one more iteration of these cases, on these routes
GRAPH_PROFILED = {"glasstorus": ("eager", "graphs"), "glasstorus160k": ("graphs",)}


def log(msg: str) -> None:
    print(msg, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(in_out_bytes: int, counts: dict) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the bytes the call must move over
    the memory rate and the operations its walk does over the float32 rate."""
    ops = counts["box"] * BOX_OPS + counts["tri"] * TRI_OPS
    bytes_ms = in_out_bytes / PEAK_BYTES * 1e3
    ops_ms = ops / PEAK_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def probe_bound(probe: str, laps: int, mhz: float) -> dict:
    """The least time of `laps` laps of probe `probe` ("P1" or a P2 variant)
    on one SM at `mhz`: per lap, the largest of its operations over the SM's
    lanes, its bytes over the SM's rate and its dependent chain's latency.
    Returns the three terms in clocks a lap, the one that binds, its clocks
    a lap and the bound in ms."""
    ops, nb, chain = PROBE_COUNTS[probe]
    clocks = {"operations": ops / SM_LANES, "bytes": nb / SM_BYTES_PER_CLOCK,
              "chain": chain * DEP_CLOCKS}
    by = max(clocks, key=clocks.get)
    return {"clocks": clocks, "by": by, "clocks_per_lap": clocks[by],
            "ms": clocks[by] * laps / (mhz * 1e3)}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        raise SystemExit(1)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    log(f"nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from pathtracer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({len(_build._sources())} sources, one nvcc each, in parallel)")
    for kernel, props in sorted(_build.ptxas_report().items()):
        log(f"ptxas {kernel}: {props.get('registers')} registers, "
            f"{props.get('stack_bytes')} bytes stack frame, "
            f"{props.get('spill_store_bytes')} bytes spill stores, "
            f"{props.get('spill_load_bytes')} bytes spill loads")
        # the walks hold a node's 48 box floats in registers: they must not
        # spill, and their frame is the 64-entry stack alone
        if kernel in WALK_KERNELS and (props.get("spill_store_bytes") or props.get("spill_load_bytes")
                                       or props.get("stack_bytes") != 256):
            raise AssertionError(f"{kernel} spills registers: {props}")
    census = _build.sass_census()
    for kernel, ops in sorted(census.items()):
        was = f" (BSSY {BSSY_BEFORE[kernel]} before the shared walk)" if kernel in BSSY_BEFORE else ""
        log(f"sass {kernel}: " + ", ".join(f"{op} {n}" for op, n in ops.items()) + was)
    # a box test alone (the probe's aabb variant: 8 slab tests a pop, 10 min/max
    # each) must not branch: each min/max is one NaN-propagating opcode,
    # where a branchy form opens 12 regions a box
    aabb = census["p2_aabb_kernel"]
    if aabb["FMNMX.NAN"] < 80 or aabb["BSSY"] >= 12:
        raise AssertionError(f"the box test of p2_aabb_kernel still branches: {aabb}")
    for kernel, need in WALK_KERNELS.items():
        ops = census[kernel]
        if ops["LDG.E.128"] < need or ops["FMNMX.NAN"] != ops["FMNMX"]:
            raise AssertionError(f"{kernel} does not fetch in 16-byte loads: {ops}")
    # P2's node variants read a node as the walks do, 12 + 2 loads of 16 bytes,
    # from the tables staged in shared memory
    for kernel in P2_FETCH_KERNELS:
        if census[kernel]["LDS.128"] < 14:
            raise AssertionError(f"{kernel} does not pop through the walks' node fetch: "
                                 f"{census[kernel]}")


def _max_err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def build_renderer(scene_path, **options):
    """The main path's Renderer for `scene_path` (MIS, RES x RES, DEPTH, on
    the card, RenderOptions `options` besides), with the host's parse and
    table seconds."""
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.scene.parser import load_scene
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    t0 = time.perf_counter()
    scene = load_scene(scene_path)
    t1 = time.perf_counter()
    r = Renderer(scene, RenderOptions(sample_mode=SampleMode.MIS, **options),
                 resolution=(RES, RES), trace_depth=DEPTH, device=DEVICE)
    return r, t1 - t0, time.perf_counter() - t1


def ray_cases(r):
    """The main path's rays for renderer `r` at RES x RES: camera rays and
    one bounce's continuation rays (with dead-lane and t-cap variants) for
    the closest-hit kernels; for the any-hit kernels two sets of NEE shadow
    rays toward the lamp, from the camera rays' hits ("NEE", the most
    coherent shadow launch of an iteration) and from the continuation rays'
    hits ("NEE continuation": ended paths are -FLT_MAX lanes, and the root
    box has culled as occlusion_test does), each plain and with occluded0
    every 7th lane and 25% of lanes at -FLT_MAX."""
    import torch

    from pathtracer_tpu_torch.integrator.wavefront import bounce, camera_rays, new_pool
    from pathtracer_tpu_torch.ops import sweep_cuda as sw
    from pathtracer_tpu_torch.ops import traverse as tv
    from pathtracer_tpu_torch.utils.config import SampleMode

    flat, static = r.flat, r.static
    o, d = camera_rays(r._cam_arrays(), RES, RES, r.key, 1, pixel_xy=r.pixel_xy)
    n = o.shape[0]
    t_geo, *_ = sw.geoms_closest(flat, static, o, d)
    t_cam = tv._root_box_cull(flat, o, d, t_geo)
    pool, _ = bounce(flat, static, SampleMode.MIS, r.key, 1, 0, new_pool(o, d))
    o2, d2 = pool.o, pool.d
    t_geo2, *_ = sw.geoms_closest(flat, static, o2, d2)
    t_cont = tv._root_box_cull(flat, o2, d2, torch.where(pool.alive, t_geo2, tv.DEAD_T))
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    dead = torch.rand(n, device=DEVICE, generator=gen) < 0.25
    closest = {
        "camera": (o, d, t_cam),
        "continuation": (o2, d2, t_cont),
        "camera, 25% dead": (o, d, torch.where(dead, tv.DEAD_T, t_cam)),
        "continuation, t cap 2.0": (o2, d2, torch.clamp(t_cont, max=2.0)),
    }
    lamp = flat.geom_transform[static.analytic_lights[0][1]][:3, 3]
    occ0 = torch.arange(n, device=DEVICE) % 7 == 0

    def nee(label, point, live=None):
        to_l = lamp[None, :] - point
        min_t = torch.sqrt((to_l * to_l).sum(1))
        sd = to_l / min_t[:, None]
        so = point + 1e-5 * sd
        if live is not None:
            min_t = tv._root_box_cull(flat, so, sd, torch.where(live, min_t, tv.DEAD_T))
        return {
            label: (so, sd, min_t, torch.zeros_like(occ0)),
            f"{label}, occluded0 every 7th, 25% -FLT_MAX":
                (so, sd, torch.where(dead, tv.DEAD_T, min_t), occ0),
        }

    shadow = nee(SHADOW_SETS[0], tv.closest_hit(flat, static, o, d).point)
    hit1 = tv.closest_hit(flat, static, o2, d2, alive=pool.alive)
    shadow.update(nee(SHADOW_SETS[1], hit1.point, live=pool.alive & (hit1.geom >= 0)))
    torch.cuda.synchronize()
    return closest, shadow


def check_closest(label, kname, got, ref, n):
    """Kernel against its plain version: tri identical on every lane, t/u/v
    within KERNEL_RTOL on hits and identical on misses; returns the largest
    absolute t/u/v difference on hits."""
    import torch

    same_tri = torch.equal(got[1], ref[1])
    hit = ref[1] >= 0
    errs = [_max_err(a[hit], b[hit]) for a, b in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3]))]
    miss_same = torch.equal(got[0][~hit], ref[0][~hit])
    log(f"{kname} {label}: {n} lanes, {int(hit.sum())} hits, tri identical: {same_tri}, "
        f"t/u/v max abs err {errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}, miss t identical: {miss_same}")
    if not (same_tri and miss_same):
        raise AssertionError(f"{kname} disagrees with its plain version ({label})")
    for a, b in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
        torch.testing.assert_close(a[hit], b[hit], rtol=KERNEL_RTOL, atol=0.0)
    return max(errs)


def check_shadow(label, kname, got, ref, mt, o0, n):
    import torch

    same = torch.equal(got, ref)
    kept, clear = bool(got[o0].all()), not bool(got[(mt < 0) & ~o0].any())
    enter = ~o0 & (mt >= 0)
    log(f"{kname} {label}: {n} lanes, {int(enter.sum())} enter the walk "
        f"({float(enter.float().mean()):.4f}), {int((ref & enter).sum())} of them end blocked "
        f"({float((ref & enter).sum() / enter.sum().clamp(min=1)):.4f}), {int(ref.sum())} blocked "
        f"in all, identical: {same}, occluded0 kept: {kept}, -FLT_MAX lanes clear: {clear}")
    if not (same and kept and clear):
        raise AssertionError(f"{kname} disagrees with its plain version ({label})")
    return float((got != ref).any())  # |a - b| of booleans


def time_shadow(kname, mesh, kernel, plain, table_bytes, shadow, also=None):
    """An any-hit kernel and its plain version on both shadow sets: median
    times, the plain walk's tests and the bound from them.  `also` is a
    (name, kernel) timed on the same rays.  Returns the first set's (ms,
    plain ms, bound), which the kernels line reports."""
    first = None
    for label in SHADOW_SETS:
        so, sd, mt, o0 = shadow[label]
        n = so.shape[0]
        ms = median_ms(lambda: kernel(so, sd, mt, o0))
        plain_ms = median_ms(lambda: plain(so, sd, mt, o0))
        c = {"box": 0, "tri": 0}
        plain(so, sd, mt, o0, counts=c)
        b = bound(table_bytes + nbytes(so, sd, mt, o0) + n, c)
        other = f"; {also[0]} on the same rays and mesh {median_ms(lambda: also[1](so, sd, mt, o0)):.4f} ms" if also else ""
        log(f"{kname} time at {n} shadow rays of {mesh}, set {label!r}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (median of 5); walk {c['box']} box + {c['tri']} triangle tests, "
            f"bound {b[0]:.4f} ms ({b[1]}){other}")
        first = first or (ms, plain_ms, b)
    return first


def time_closest(k, closest, mesh) -> dict:
    """K5, K3 and K1 on the camera and the continuation rays: CUDA-event
    medians of 5, printed with the ratios; returns {"K5 camera": ms, ...}."""
    ms = {}
    for label in CLOSEST_SETS:
        ro, rd, t0 = closest[label]
        for name in ("K5", "K3", "K1"):
            ms[f"{name} {label}"] = median_ms(lambda name=name: k[name](ro, rd, t0))
        log(f"{mesh} closest hit at {ro.shape[0]} {label} rays (median of 5): "
            + ", ".join(f"{name} {ms[f'{name} {label}']:.4f} ms" for name in ("K5", "K3", "K1"))
            + f"; K5/K3 {ms[f'K5 {label}'] / ms[f'K3 {label}']:.3f}, "
            f"K5/K1 {ms[f'K5 {label}'] / ms[f'K1 {label}']:.3f}, "
            f"K3/K1 {ms[f'K3 {label}'] / ms[f'K1 {label}']:.3f}")
    return ms


def check_k5_k3(label, k5, k3):
    """K5 against K3 on the same rays: t bitwise equal on every lane; tri,
    u, v may differ only on exact-t ties (the block of lower index wins in
    K5, K3's depth-first order may pick another).  Returns the tie lanes."""
    import torch

    torch.cuda.synchronize()
    t_same = torch.equal(k5[0], k3[0])
    ties = int(((k5[1] != k3[1]) | (k5[2] != k3[2]) | (k5[3] != k3[3])).sum())
    log(f"K5 vs K3 {label}: t bitwise equal: {t_same}, tri/u/v differ on {ties} lanes "
        f"(each an exact-t tie, as t is equal)")
    if not t_same:
        raise AssertionError(f"K5 and K3 disagree on t ({label})")
    return ties


def stream_calls(flat, static):
    """Closures over the stream tables: K3, K4, K5 and their plain versions,
    and K1/K2 on the same mesh's wide tables."""
    from pathtracer_tpu_torch.ops import traverse_cuda as tc
    from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts

    sizes = dict(sub_nodes=static.stream_sub_nodes, sub_tris=static.stream_sub_tris)
    k3_tables = (flat.str_topf, flat.str_topl, flat.str_topp, flat.str_subf, flat.str_subi,
                 flat.str_subp, flat.str_subt, flat.str_base)
    k4_tables = (flat.str_topf, flat.str_topl, flat.str_subf, flat.str_subi, flat.str_subt,
                 flat.str_base)
    k5_tables = (flat.str_roots, flat.str_subf, flat.str_subi, flat.str_subp, flat.str_subt,
                 flat.str_base)
    k5_derived = dict(subt12=flat.str_subt12, blocks=flat.str_blocks, roots8=flat.str_roots8,
                      groups=flat.str_groups)
    k1_tables = (flat.bvh_wf, flat.bvh_wi, flat.bvh_wp, flat.tri_pk)
    k2_tables = (flat.bvh_wf, flat.bvh_wi, flat.tri_pk)
    depths = dict(top_depth=static.stream_top_depth, sub_depth=static.stream_sub_depth)
    wide = dict(wide_depth=static.wide_depth)
    return dict(
        tables=dict(K3=k3_tables, K4=k4_tables, K5=k5_tables, K1=k1_tables, K2=k2_tables),
        K3=lambda ro, rd, t0: ts.closest_hit_stream(
            *k3_tables, ro, rd, t0, **sizes, **depths, subt12=flat.str_subt12,
            blocks=flat.str_blocks),
        K3_plain=lambda ro, rd, t0, **kw: ts.closest_hit_stream_plain(*k3_tables, ro, rd, t0, **sizes, **kw),
        K4=lambda so, sd, mt, o0: ts.occlusion_stream(
            *k4_tables, so, sd, mt, o0, **sizes, **depths, subt12=flat.str_subt12,
            blocks=flat.str_blocks),
        K4_plain=lambda so, sd, mt, o0, **kw: ts.occlusion_stream_plain(*k4_tables, so, sd, mt, o0, **sizes, **kw),
        K5=lambda ro, rd, t0: ts.closest_hit_blockmajor(
            *k5_tables, ro, rd, t0, **sizes, sub_depth=static.stream_sub_depth, **k5_derived),
        # with the kernel's group cull, so that its counts are the kernel's tests
        K5_plain=lambda ro, rd, t0, **kw: ts.closest_hit_blockmajor_plain(
            *k5_tables, ro, rd, t0, **sizes, groups=flat.str_groups, **kw),
        K1=lambda ro, rd, t0: tc.closest_hit_wbvh(*k1_tables, ro, rd, t0, **wide),
        K2=lambda so, sd, mt, o0: tc.occlusion_wbvh(*k2_tables, so, sd, mt, o0, **wide),
    )


def describe_stream(label, flat, static):
    log(f"{label}: {static.num_tris} triangles, {static.wide_nodes} wide nodes "
        f"(depth {static.wide_depth}), {static.stream_top} top nodes, {static.stream_subs} blocks of "
        f"{static.stream_sub_nodes} nodes / {static.stream_sub_tris} triangles, walk depths "
        f"top {static.stream_top_depth} block {static.stream_sub_depth}; stream tables "
        f"{nbytes(flat.str_topf, flat.str_topl, flat.str_topp, flat.str_subf, flat.str_subi, flat.str_subp, flat.str_subt, flat.str_base)} "
        f"bytes, K3's to K5's derived tables {nbytes(flat.str_subt12, flat.str_blocks)} bytes, K5's "
        f"cull tables {nbytes(flat.str_roots8, flat.str_groups)} bytes, wide tables "
        f"{nbytes(flat.bvh_wf, flat.bvh_wi, flat.bvh_wp, flat.tri_pk)} bytes")
    if static.stream_subs == 0:
        raise AssertionError(f"{label} did not take the streaming tables")
    assert_aligned(flat, ("str_topf", "str_topl", "str_subf", "str_subi", "str_subt12",
                          "str_blocks", "str_roots8", "str_groups", "bvh_wf", "bvh_wi", "tri_pk"))


def assert_aligned(flat, names) -> None:
    """The tables K1-K5 read in 16-byte loads start on 16-byte bounds."""
    for name in names:
        if getattr(flat, name).data_ptr() % 16:
            raise AssertionError(f"{name} is not 16-byte aligned")


def resident_calls(r):
    """Closures over renderer `r`'s wide tables: K1, its plain version, K2,
    its plain version."""
    from pathtracer_tpu_torch.ops import traverse_cuda as tc

    flat, static = r.flat, r.static
    k1_tables = (flat.bvh_wf, flat.bvh_wi, flat.bvh_wp, flat.tri_pk)
    k2_tables = (flat.bvh_wf, flat.bvh_wi, flat.tri_pk)
    return (
        lambda ro, rd, t0: tc.closest_hit_wbvh(*k1_tables, ro, rd, t0, wide_depth=static.wide_depth),
        lambda ro, rd, t0, **kw: tc.closest_hit_wbvh_plain(*k1_tables, ro, rd, t0, **kw),
        lambda so, sd, mt, o0: tc.occlusion_wbvh(*k2_tables, so, sd, mt, o0,
                                                 wide_depth=static.wide_depth),
        lambda so, sd, mt, o0, **kw: tc.occlusion_wbvh_plain(*k2_tables, so, sd, mt, o0, **kw),
    )


def phase_resident_kernels(r):
    """K1/K2 against their plain versions at the glasstorus main path's shapes."""
    closest, shadow = ray_cases(r)
    flat = r.flat
    assert_aligned(flat, ("bvh_wf", "bvh_wi", "tri_pk"))
    tables = (flat.bvh_wf, flat.bvh_wi, flat.bvh_wp, flat.tri_pk)
    k2_tables = (flat.bvh_wf, flat.bvh_wi, flat.tri_pk)
    k1, k1_plain, k2, k2_plain = resident_calls(r)
    k1_err = 0.0
    for label, (ro, rd, t0) in closest.items():
        k1_err = max(k1_err, check_closest(label, "K1", k1(ro, rd, t0), k1_plain(ro, rd, t0),
                                           ro.shape[0]))
    k2_err = 0.0
    for label, (so, sd, mt, o0) in shadow.items():
        k2_err = max(k2_err, check_shadow(label, "K2", k2(so, sd, mt, o0), k2_plain(so, sd, mt, o0),
                                          mt, o0, so.shape[0]))
    ro, rd, t0 = closest["continuation"]
    n = ro.shape[0]
    k1_ms = median_ms(lambda: k1(ro, rd, t0))
    k1_plain_ms = median_ms(lambda: k1_plain(ro, rd, t0))
    c1 = {"box": 0, "tri": 0}
    k1_plain(ro, rd, t0, counts=c1)
    b1 = bound(nbytes(*tables, ro, rd, t0) + 16 * n, c1)
    log(f"K1 time at {n} continuation rays: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms "
        f"(median of 5); walk {c1['box']} box + {c1['tri']} triangle tests, bound {b1[0]:.4f} ms ({b1[1]})")
    k2_ms, k2_plain_ms, b2 = time_shadow("K2", "glasstorus", k2, k2_plain, nbytes(*k2_tables), shadow)
    return {
        "K1": ("closest_hit_wbvh", SRC_RESIDENT, "pathtracer_tpu/ops/traverse_pallas.py:418",
               k1_err, k1_ms, k1_plain_ms, b1),
        "K2": ("occlusion_wbvh", SRC_RESIDENT, "pathtracer_tpu/ops/traverse_pallas.py:1529",
               k2_err, k2_ms, k2_plain_ms, b2),
    }


def phase_stream_kernels(r):
    """K3/K4 against their plain versions, and against K1/K2 on the same
    mesh; K5 against its plain version and against K3; at the
    glasstorus160k main path's shapes."""
    import torch

    closest, shadow = ray_cases(r)
    flat, static = r.flat, r.static
    describe_stream("glasstorus160k", flat, static)
    k = stream_calls(flat, static)

    k3_err = k5_err = 0.0
    c5 = {"box": 0, "tri": 0, "group": 0, "root": 0}
    for label, (ro, rd, t0) in closest.items():
        got = k["K3"](ro, rd, t0)
        k3_err = max(k3_err, check_closest(label, "K3", got, k["K3_plain"](ro, rd, t0), ro.shape[0]))
        # the same rays through K1 on the same mesh's wide tables
        k1 = k["K1"](ro, rd, t0)
        torch.cuda.synchronize()
        t_same = torch.equal(got[0], k1[0])
        tri_diff = int((got[1] != k1[1]).sum())
        log(f"K3 vs K1 {label}: t bitwise equal: {t_same}, tri differs on {tri_diff} lanes "
            f"(each an exact-t tie, as t is equal)")
        if not t_same:
            raise AssertionError(f"K3 and K1 disagree on t ({label})")
        k5 = k["K5"](ro, rd, t0)
        # the continuation rays' plain walk also counts the bound's tests
        kw = dict(counts=c5) if label == "continuation" else {}
        k5_err = max(k5_err, check_closest(label, "K5", k5, k["K5_plain"](ro, rd, t0, **kw), ro.shape[0]))
        check_k5_k3(label, k5, got)
    k4_err = 0.0
    for label, (so, sd, mt, o0) in shadow.items():
        got = k["K4"](so, sd, mt, o0)
        k4_err = max(k4_err, check_shadow(label, "K4", got, k["K4_plain"](so, sd, mt, o0), mt, o0, so.shape[0]))
        k2 = k["K2"](so, sd, mt, o0)
        torch.cuda.synchronize()
        same = torch.equal(got, k2)
        log(f"K4 vs K2 {label}: identical: {same}")
        if not same:
            raise AssertionError(f"K4 and K2 disagree ({label})")

    ms = time_closest(k, closest, "glasstorus160k")
    ro, rd, t0 = closest["continuation"]
    n = ro.shape[0]
    k3_ms, k5_ms = ms["K3 continuation"], ms["K5 continuation"]
    k3_plain_ms = median_ms(lambda: k["K3_plain"](ro, rd, t0))
    # the plain K5 walks block after block (seconds a call): one timed run,
    # warm from the checks above
    k5_plain_ms = median_ms(lambda: k["K5_plain"](ro, rd, t0), runs=1, warmup=False)
    c3 = {"box": 0, "tri": 0}
    k["K3_plain"](ro, rd, t0, counts=c3)
    tables = k["tables"]
    b3 = bound(nbytes(*tables["K3"], ro, rd, t0) + 16 * n, c3)
    # K5 computes K3's function, the closest hit: its bound is K5's bytes and
    # the tests K3's walk needs on these rays.  K5's own walk (c5: a group
    # test per live lane and group, a root test per block of a passing group,
    # blocks K3's upper boxes reject, caps that shrink later) is the cost of
    # its schedule, printed beside the bound.
    b5 = bound(nbytes(*tables["K5"], ro, rd, t0) + 16 * n, c3)
    live = max(int((t0 >= 0).sum()), 1)
    nodes5 = c5["box"] - c5["group"] - c5["root"]
    log(f"K3 at {n} continuation rays of glasstorus160k: plain {k3_plain_ms:.4f} ms (median of 5); "
        f"walk {c3['box']} box + {c3['tri']} triangle tests, bound {b3[0]:.4f} ms ({b3[1]})")
    # K4's bytes: the stream tables it computes on, as K3's (not the padded copy)
    k4_ms, k4_plain_ms, b4 = time_shadow("K4", "glasstorus160k", k["K4"], k["K4_plain"],
                                         nbytes(*tables["K4"]), shadow, also=("K2", k["K2"]))
    log(f"K5 at {n} continuation rays of glasstorus160k: plain {k5_plain_ms:.4f} ms (one run); "
        f"bound {b5[0]:.4f} ms ({b5[1]}; K5's bytes, K3's walk); K5's own walk, the cost of its "
        f"schedule: {c5['group']} group + {c5['root']} root + {nodes5} node box tests "
        f"+ {c5['tri']} triangle tests; per live lane ({live}) {c5['group'] / live:.2f} group + "
        f"{c5['root'] / live:.2f} root (against {static.stream_subs} blocks) + "
        f"{nodes5 / live:.1f} node = {c5['box'] / live:.1f} box tests, K3's {c3['box'] / live:.1f}")
    return {
        "K3": ("closest_hit_stream", SRC_STREAM, "pathtracer_tpu/ops/traverse_pallas.py:871",
               k3_err, k3_ms, k3_plain_ms, b3),
        "K4": ("occlusion_stream", SRC_STREAM, "pathtracer_tpu/ops/traverse_pallas.py:1448",
               k4_err, k4_ms, k4_plain_ms, b4),
        "K5": ("closest_hit_blockmajor", SRC_STREAM, "pathtracer_tpu/ops/traverse_pallas.py:1120",
               k5_err, k5_ms, k5_plain_ms, b5),
    }


def phase_640k_kernels(r):
    """K5 against K3 and K4 against K2 on glasstorus640k's rays (its stream
    tables are past the 50 MB L2), and the times of K5, K3, K1, K4 and K2
    there."""
    import torch

    closest, shadow = ray_cases(r)
    flat, static = r.flat, r.static
    describe_stream("glasstorus640k", flat, static)
    k = stream_calls(flat, static)
    for label, (ro, rd, t0) in closest.items():
        check_k5_k3(label, k["K5"](ro, rd, t0), k["K3"](ro, rd, t0))
    for label, (so, sd, mt, o0) in shadow.items():
        same = torch.equal(k["K4"](so, sd, mt, o0), k["K2"](so, sd, mt, o0))
        log(f"K4 vs K2 {label}: identical: {same}")
        if not same:
            raise AssertionError(f"K4 and K2 disagree on glasstorus640k ({label})")
    time_closest(k, closest, "glasstorus640k")
    ms = {}
    for label in SHADOW_SETS:
        so, sd, mt, o0 = shadow[label]
        ms.update({f"{name} {label!r}": median_ms(lambda name=name: k[name](so, sd, mt, o0))
                   for name in ("K4", "K2")})
    log(f"glasstorus640k shadow times at {so.shape[0]} rays (median of 5): "
        + ", ".join(f"{name} {v:.4f} ms" for name, v in ms.items()) + "; "
        + ", ".join(f"K4/K2 {label!r} {ms[f'K4 {label!r}'] / ms[f'K2 {label!r}']:.3f}"
                    for label in SHADOW_SETS))


def scheduled_ray_cases(r):
    """The rays the scheduler hands the kernels on renderer `r`'s main path:
    lap 1's continuation pool as the per-bounce sort orders it (camera pool
    sorted, one bounce, sorted again), its first shrink-ladder prefix and a
    prefix of ODD_PREFIX lanes, each a view of the sorted columns, and the
    same rays put back in lane order; and the NEE shadow rays toward the
    lamp from that pool's hits, ordered as occlusion_test's shadow sort
    orders them, their ODD_PREFIX prefix, and the same rays in the pool's
    order.
    Also returns unsorted shadow rays for occlusion_test: the hit points,
    the directions toward the lamp, destinations halfway there and the
    lanes that take NEE."""
    import torch

    from pathtracer_tpu_torch.integrator.wavefront import (
        bounce, camera_rays, in_lane_order, new_pool, schedule, sort_pool)
    from pathtracer_tpu_torch.ops import sweep_cuda as sw
    from pathtracer_tpu_torch.ops import traverse as tv
    from pathtracer_tpu_torch.utils.config import SampleMode

    flat, static = r.flat, r.static
    o, d = camera_rays(r._cam_arrays(), RES, RES, r.key, 1, pixel_xy=r.pixel_xy)
    pool, _ = bounce(flat, static, SampleMode.MIS, r.key, 1, 0,
                     sort_pool(flat, static, new_pool(o, d)))
    pool = sort_pool(flat, static, pool)
    o2, d2 = pool.o, pool.d
    t_geo, *_ = sw.geoms_closest(flat, static, o2, d2)
    t2 = tv._root_box_cull(flat, o2, d2, torch.where(pool.alive, t_geo, tv.DEAD_T))
    nxt = schedule(static, r.opts, RES * RES).shrink[0][0]
    lane_order = in_lane_order(pool._replace(contrib=t2), ("o", "d", "contrib"))

    def prefix(rays, k):
        cut = tuple(a[:k] for a in rays)
        if not all(c.data_ptr() == a.data_ptr() and c.is_contiguous() for c, a in zip(cut, rays)):
            raise AssertionError("a pool prefix is not a view of the pool's columns")
        return cut

    rays2 = (o2, d2, t2)
    closest = {"sorted continuation pool": rays2,
               f"its ladder prefix of {nxt} lanes (a view)": prefix(rays2, nxt),
               f"its prefix of {ODD_PREFIX} lanes (a view)": prefix(rays2, ODD_PREFIX),
               "the same pool in lane order": (lane_order.o, lane_order.d, lane_order.contrib)}

    hit = tv.closest_hit(flat, static, o2, d2, alive=pool.alive)
    live = pool.alive & (hit.geom >= 0)
    lamp = flat.geom_transform[static.analytic_lights[0][1]][:3, 3]
    to_l = lamp[None, :] - hit.point
    min_t = torch.sqrt((to_l * to_l).sum(1))
    sd = to_l / min_t[:, None]
    so = hit.point + 1e-5 * sd
    mt = tv._root_box_cull(flat, so, sd, torch.where(live, min_t, tv.DEAD_T))
    key = torch.where(mt <= tv.DEAD_T, tv.DEAD_KEY, tv.octant_cell_key(flat, so, sd))
    perm = torch.sort(key, stable=True).indices
    srt = tuple(a.index_select(0, perm) for a in (so, sd, mt)) + (
        torch.zeros(mt.shape[0], dtype=torch.bool, device=DEVICE),)
    shadow = {"shadow-sorted NEE set": srt,
              f"its prefix of {ODD_PREFIX} lanes (a view)": prefix(srt, ODD_PREFIX),
              "the NEE set in the pool's order": (so, sd, mt, srt[3])}
    torch.cuda.synchronize()
    # halfway to the lamp, so that the lamp's own sphere does not block them
    return closest, shadow, (hit.point, sd, hit.point + 0.5 * to_l, live)


def phase_scheduled_kernels(r, names, closest_fn, closest_plain, shadow_fn, shadow_plain):
    """The closest-hit and any-hit kernels `names` of renderer `r`'s mesh
    against their plain versions on scheduled_ray_cases, and occlusion_test
    with the shadow sort (which launches the any-hit kernel) equal to it
    without."""
    import torch

    from pathtracer_tpu_torch.ops import traverse as tv

    closest, shadow, (p, sd, des, live) = scheduled_ray_cases(r)
    for label, (ro, rd, t0) in closest.items():
        check_closest(label, names[0], closest_fn(ro, rd, t0), closest_plain(ro, rd, t0), ro.shape[0])
    for label, (so, sd_, mt, o0) in shadow.items():
        check_shadow(label, names[1], shadow_fn(so, sd_, mt, o0), shadow_plain(so, sd_, mt, o0),
                     mt, o0, so.shape[0])
    # the same rays in two orders: what the sort does to the kernels
    (a, ra), (b, rb) = [(k, closest[k]) for k in ("sorted continuation pool",
                                                  "the same pool in lane order")]
    (c, sa), (e, sb) = [(k, shadow[k]) for k in ("shadow-sorted NEE set",
                                                 "the NEE set in the pool's order")]
    times = {a: median_ms(lambda: closest_fn(*ra)), b: median_ms(lambda: closest_fn(*rb)),
             c: median_ms(lambda: shadow_fn(*sa)), e: median_ms(lambda: shadow_fn(*sb))}
    log(f"{names[0]} on {a}: {times[a]:.4f} ms, on {b}: {times[b]:.4f} ms "
        f"({times[b] / times[a]:.3f}x); {names[1]} on {c}: {times[c]:.4f} ms, on {e}: "
        f"{times[e]:.4f} ms ({times[e] / times[c]:.3f}x) (CUDA-event medians of 5)")
    so = p + 1e-5 * sd
    unsorted = tv.occlusion_test(r.flat, r.static, so, sd, des, enabled=live)
    srt = tv.occlusion_test(r.flat, r.static, so, sd, des, enabled=live, shadow_sort=True)
    torch.cuda.synchronize()
    same = torch.equal(unsorted, srt)
    log(f"occlusion_test through {names[1]} with the shadow sort vs without: {int(live.sum())} "
        f"lanes enabled, {int(unsorted.sum())} blocked, identical: {same}")
    if not same:
        raise AssertionError("the shadow sort changed occlusion_test's result")


def sweep_ray_cases(r):
    """The rays of renderer `r`'s main path at RES x RES for the analytic
    sweep: for S1 the camera rays, one bounce's continuation pool (every
    lane, ended paths included) and the camera origins with directions
    along the axes (two zero components: the cube's slabs meet +-inf, and
    0/0 on a face plane); for S2 the shadow rays toward the lamp from the
    camera rays' hits and from the continuation rays' hits, each with
    occlusion_test's min_t to the point halfway to the lamp's center."""
    import torch

    from pathtracer_tpu_torch.integrator.wavefront import bounce, camera_rays, new_pool
    from pathtracer_tpu_torch.ops import traverse as tv
    from pathtracer_tpu_torch.utils.config import SampleMode

    flat, static = r.flat, r.static
    o, d = camera_rays(r._cam_arrays(), RES, RES, r.key, 1, pixel_xy=r.pixel_xy)
    pool, _ = bounce(flat, static, SampleMode.MIS, r.key, 1, 0, new_pool(o, d))
    lane = torch.arange(o.shape[0], device=DEVICE)
    axis = torch.nn.functional.one_hot(lane % 3, 3).float()
    closest = {"camera": (o, d), "continuation": (pool.o, pool.d),
               "camera origins, axis directions": (o, torch.where(lane % 6 < 3, 1.0, -1.0)[:, None]
                                                   * axis)}
    lamp = flat.geom_transform[static.analytic_lights[0][1]][:3, 3]
    shadow = {}
    for label in CLOSEST_SETS:
        ro, rd = closest[label]
        point = tv.closest_hit(flat, static, ro, rd).point
        to_l = lamp[None, :] - point
        sd = to_l / torch.sqrt((to_l * to_l).sum(1))[:, None]
        so = point + 1e-5 * sd
        e = (point + 0.5 * to_l) - so  # halfway: the lamp's own sphere does not block
        min_t = torch.sqrt(torch.clamp(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2],
                                       min=0.0))
        shadow[f"NEE from the {label} hits"] = (so, sd, min_t)
    torch.cuda.synchronize()
    return closest, shadow


def sweep_bound(flat, static, kname: str, rays: tuple) -> tuple[float, str, float]:
    """(ms, what bounds it, operations a lane) of S1 or S2 on `rays`: the
    larger of the bytes once (each lane's ray, min_t and outputs, the geom
    tables) over the memory rate and SWEEP_OPS over SWEEP_OP_RATE, counted
    over the geoms each lane tests: every one in S1 (plus the normal on a
    hit), in S2 those up to its first blocker."""
    import torch

    from pathtracer_tpu_torch.ops import sweep_cuda as sw

    n = rays[0].shape[0]
    geoms = sw.analytic_geoms(static)
    # a type word a geom; 3 rows of 16 bytes of inv and transform a geom swept
    # (and of invt in S1)
    tables = nbytes(flat.geom_type) + len(geoms) * 48 * (3 if kname == "S1" else 2)
    ops = SWEEP_OPS[kname]
    if kname == "S1":
        hits = int((sw.geoms_closest(flat, static, *rays)[1] >= 0).sum())
        total = n * sum(ops[gt] for _, gt in geoms) + hits * SWEEP_NORMAL_OPS
        nb = tables + n * (24 + 32)
    else:
        o, d, min_t = rays
        ox, oy, oz, dx, dy, dz = (*o.unbind(1), *d.unbind(1))
        tested = torch.zeros((), dtype=torch.int64, device=DEVICE)
        blocked = torch.zeros(n, dtype=torch.bool, device=DEVICE)
        for gi, gt in geoms:  # the kernel leaves a lane's loop at its first blocker
            tested = tested + ops[gt] * (~blocked).sum()
            valid, t, *_ = sw._geom_t_soa(flat, gi, gt, ox, oy, oz, dx, dy, dz)
            blocked = blocked | (valid & (t > 0.0) & (min_t - 1e-5 > t)
                                 & (torch.abs(t - min_t) > 1e-2))
        total = int(tested)
        nb = tables + n * (24 + 4 + 1)
    bytes_ms, ops_ms = nb / PEAK_BYTES * 1e3, total / SWEEP_OP_RATE * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, total / n


def phase_sweep_kernels(r, scene: str) -> dict:
    """S1 and S2 (csrc/analytic_sweep.cu) against their plain versions on
    renderer `r`'s main path rays (sweep_ray_cases), bit for bit on every
    output and lane; each kernel's and plain version's median time beside
    its bound.  Returns the kernels line's rows (S1 on the camera rays, S2
    on the NEE rays from the camera hits)."""
    import torch

    from pathtracer_tpu_torch.ops import sweep_cuda as sw

    flat, static = r.flat, r.static
    closest, shadow = sweep_ray_cases(r)
    kinds = "".join("sc"[gt] for _, gt in sw.analytic_geoms(static))
    log(f"sweep: {scene}, {len(kinds)} analytic geoms of {static.num_geoms} (spheres "
        f"{kinds.count('s')}, cubes {kinds.count('c')})")
    rows = {}
    for kname, cases, kernel, plain in (
            ("S1", closest, sw.geoms_closest, sw.geoms_closest_plain),
            ("S2", shadow, sw.geoms_occluded, sw.geoms_occluded_plain)):
        for k, (label, rays) in enumerate(cases.items()):
            n0 = _build.launches[kname]
            got = kernel(flat, static, *rays)
            want = plain(flat, static, *rays)
            torch.cuda.synchronize()
            if _build.launches[kname] != n0 + 1:
                raise AssertionError(f"{kname} {label}: the wrapper did not launch once")
            if kname == "S1":
                same = {k: torch.equal(a, b) for k, a, b in zip(("t", "geom", "point", "normal"),
                                                                 got, want)}
                what = f"{int((want[1] >= 0).sum())} hits"
            else:
                same = {"occluded": torch.equal(got, want)}
                what = f"{int(want.sum())} blocked"
            log(f"{kname} {scene} {label}: {rays[0].shape[0]} lanes, {what}; bitwise equal to the "
                f"plain version: {same}")
            if not all(same.values()):
                raise AssertionError(f"{kname} differs from its plain version ({scene}, {label})")
            if k > 1:  # the axis-aligned set is checked, not timed
                continue
            ms = median_ms(lambda: kernel(flat, static, *rays))
            plain_ms = median_ms(lambda: plain(flat, static, *rays))
            b_ms, by, ops = sweep_bound(flat, static, kname, rays)
            log(f"{kname} time at {rays[0].shape[0]} {label} rays of {scene}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms (median of 5); {ops:.1f} operations a lane, bound "
                f"{b_ms:.4f} ms ({by}), kernel / bound {ms / b_ms:.2f}")
            if k == 0:
                rows[kname] = (0.0, ms, plain_ms, (b_ms, by))
    return {
        "S1": ("geoms_closest", SRC_SWEEP, "none (plain jnp: pathtracer_tpu/ops/traverse.py:129 "
               "_geoms_closest)", *rows["S1"]),
        "S2": ("geoms_occluded", SRC_SWEEP, "none (plain jnp: the analytic loop of "
               "pathtracer_tpu/ops/traverse.py:467 occlusion_test)", *rows["S2"]),
    }


def shade_lane_cases(r):
    """The shading inputs of renderer `r`'s main path at RES x RES, as
    `bounce` hands them to M1 and M2 (its trace): the camera rays' lap
    (iteration 1, depth 0) and the continuation pool's (depth 1, every lane,
    ended and missed paths included), each with its light direction (the NEE
    sample's, or the reflected ray's where the scene has no NEE); then the
    camera lap's lanes with edge values spliced in: grazing rays,
    roughness at its clamps, metallic 0 and 1, ior 1, and NaN normals,
    rays, roughness and light directions."""
    import torch

    from pathtracer_tpu_torch.integrator.wavefront import bounce, camera_rays, new_pool
    from pathtracer_tpu_torch.ops import math as m
    from pathtracer_tpu_torch.utils.config import SampleMode

    flat, static = r.flat, r.static
    o, d = camera_rays(r._cam_arrays(), RES, RES, r.key, 1, pixel_xy=r.pixel_xy)
    pool = new_pool(o, d)
    cases = {}
    for depth, label in enumerate(("camera", "continuation")):
        trace = {}
        nxt, _ = bounce(flat, static, SampleMode.MIS, r.key, 1, depth, pool, trace=trace)
        hit, nrm = trace["hit"], trace["nrm"]
        wi = (m.normalize(trace["lrec"].pos - hit.point) if "lrec" in trace
              else m.reflect(pool.d, nrm))
        cases[label] = (trace["params"], nrm, pool.d, wi, 1, depth, pool.lane)
        pool = nxt
    p, nrm, wo, wi, it, depth, lane = cases["camera"]
    n = lane.shape[0]
    k = n // 16
    g = torch.Generator(device=DEVICE).manual_seed(23)
    tangent = m.normalize(m.cross(nrm, torch.randn((n, 3), device=DEVICE, generator=g)))
    rough, metal, ior = p.roughness.clone(), p.metallic.clone(), p.ior.clone()
    nrm, wo, wi = nrm.clone(), wo.clone(), wi.clone()
    wo[:k] = m.normalize(tangent[:k] + 1e-4 * nrm[:k])  # grazing
    wo[k:2 * k] = tangent[k:2 * k]  # perpendicular to the normal
    rough[2 * k:3 * k], rough[3 * k:4 * k] = 1e-3, 1.0
    metal[4 * k:5 * k], metal[5 * k:6 * k] = 0.0, 1.0
    ior[6 * k:7 * k] = 1.0
    nan = float("nan")
    nrm[7 * k:7 * k + 64], wo[7 * k + 64:7 * k + 128] = nan, nan
    rough[7 * k + 128:7 * k + 192], wi[7 * k + 192:7 * k + 256] = nan, nan
    cases["camera, edge values"] = (p._replace(roughness=rough, metallic=metal, ior=ior), nrm,
                                    wo, wi, torch.full((n,), 5, dtype=torch.int32, device=DEVICE),
                                    torch.full((), 3, dtype=torch.int32, device=DEVICE), lane)
    torch.cuda.synchronize()
    return cases


def same_bits(a, b) -> bool:
    """Equal bit for bit where neither is NaN, and NaN at the same places."""
    import torch

    if a.dtype != torch.float32:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a).view(torch.int32),
                                               torch.where(nb, 0.0, b).view(torch.int32))


def shade_bound(kname: str, types) -> tuple[float, str, float]:
    """(ms, what bounds it, operations a lane) of M1 or M2 over lanes of
    material `types`: the larger of SHADE_BYTES a lane over the memory rate
    and SHADE_OPS over SWEEP_OP_RATE (one operation a lane a clock)."""
    n = types.shape[0]
    ops = sum(c * int((types == t).sum()) for t, c in SHADE_OPS[kname].items())
    # a type outside 0-4 takes the Light default, as 4
    ops += SHADE_OPS[kname][4] * int(((types < 0) | (types > 4)).sum())
    bytes_ms, ops_ms = n * SHADE_BYTES[kname] / PEAK_BYTES * 1e3, ops / SWEEP_OP_RATE * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, ops / n


def phase_shade_kernels(r, scene: str) -> dict:
    """M1 and M2 (csrc/shade.cu) against their plain versions on renderer
    `r`'s shading inputs (shade_lane_cases), bit for bit on every output and
    lane, NaN where NaN: M1 against pixel_uniforms + scatter_sample, its draw
    alone against pixel_uniforms word for word, M2 against bsdf_eval +
    pdf_eval, the plain versions over every lobe (present None); each wrapper
    launches once a call.  Median times of kernel and plain version beside
    the bound (shade_bound).  Returns the kernels line's rows (the camera
    lap)."""
    import torch

    from pathtracer_tpu_torch.ops import shade_cuda as sh

    cases = shade_lane_cases(r)
    rows = {}
    for k, (label, (p, nrm, wo, wi, it, depth, lane)) in enumerate(cases.items()):
        key = r.key
        calls = {
            "M1": (lambda: sh.scatter_lobes(p, nrm, wo, key, it, depth, lane),
                   lambda: sh.scatter_lobes_plain(p, nrm, wo, key, it, depth, lane)),
            "M2": (lambda: sh.eval_lobes(p, nrm, wo, wi), lambda: sh.eval_lobes_plain(p, nrm, wo, wi)),
        }
        types = {t: int((p.type == t).sum()) for t in range(5)}
        for kname, (kernel, plain) in calls.items():
            n0 = _build.launches[kname]
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if _build.launches[kname] != n0 + 1:
                raise AssertionError(f"{kname} {label}: the wrapper did not launch once")
            if kname == "M1":
                names, got, want = ("bsdf", "pdf", "dir"), (got.bsdf, got.pdf, got.dir), \
                    (want.bsdf, want.pdf, want.dir)
            else:
                names = ("bsdf", "pdf")
            same = {nm: same_bits(a, b) for nm, a, b in zip(names, got, want)}
            err = max(_max_err(torch.nan_to_num(a), torch.nan_to_num(b)) for a, b in zip(got, want))
            log(f"{kname} {scene} {label}: {lane.shape[0]} lanes, types {types}; bitwise equal to "
                f"the plain version: {same}, max_abs_err {err}")
            if not all(same.values()):
                raise AssertionError(f"{kname} differs from its plain version ({scene}, {label})")
        draw = sh.scatter_draw(key, it, depth, lane)
        draw_plain = sh.scatter_draw_plain(key, it, depth, lane)
        if not torch.equal(draw.view(torch.int32), draw_plain.view(torch.int32)):
            raise AssertionError(f"M1's draw differs from pixel_uniforms ({scene}, {label})")
        log(f"M1 draw {scene} {label}: equal to utils/rng.py pixel_uniforms word for word")
        if k:  # the camera lap is timed; the other sets are checked
            continue
        for kname, (kernel, plain) in calls.items():
            ms = median_ms(kernel)
            plain_ms = median_ms(plain)
            b_ms, by, ops = shade_bound(kname, p.type)
            log(f"{kname} time at {lane.shape[0]} {label} lanes of {scene}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms (median of 5); {ops:.1f} operations a lane, bound "
                f"{b_ms:.4f} ms ({by}), kernel / bound {ms / b_ms:.2f}")
            rows[kname] = (0.0, ms, plain_ms, (b_ms, by))
    return {
        "M1": ("scatter_lobes", SRC_SHADE, "none (plain jnp: pathtracer_tpu/utils/rng.py "
               "pixel_uniforms and pathtracer_tpu/ops/materials.py scatter_sample)", *rows["M1"]),
        "M2": ("eval_lobes", SRC_SHADE, "none (plain jnp: pathtracer_tpu/ops/materials.py "
               "bsdf_eval and pdf_eval)", *rows["M2"]),
    }


def light_lane_cases(r):
    """The light side's inputs on renderer `r`'s main path at RES x RES, as
    `bounce` hands them to L1 and L2 (its trace): the camera rays' lap
    (iteration 1, depth 0) and the continuation pool's (depth 1, every lane,
    ended and missed paths included), each with the MIS lap's NEE mask; then
    the camera lap with per-lane counters, a first pixel past the film and
    NaN view points and origins spliced in."""
    import torch

    from pathtracer_tpu_torch.integrator.wavefront import bounce, camera_rays, new_pool
    from pathtracer_tpu_torch.scene.parser import DIELECTRIC, LIGHT
    from pathtracer_tpu_torch.utils.config import SampleMode

    flat, static = r.flat, r.static
    o, d = camera_rays(r._cam_arrays(), RES, RES, r.key, 1, pixel_xy=r.pixel_xy)
    pool = new_pool(o, d)
    cases = {}
    for depth, label in enumerate(("camera", "continuation")):
        trace = {}
        nxt, _ = bounce(flat, static, SampleMode.MIS, r.key, 1, depth, pool, trace=trace)
        hit, p, srec = trace["hit"], trace["params"], trace["srec"]
        nee = (pool.alive & (hit.geom >= 0) & (srec.pdf != 0.0) & (p.type != LIGHT)
               & (p.type != DIELECTRIC))
        cases[label] = (hit.point, pool.lane, 1, depth, 0, nee,
                        (pool.o, hit.point, trace["nrm"], hit.tri, hit.geom))
        pool = nxt
    view, lane, _, _, _, nee, (o, point, nrm, tri, geom) = cases["camera"]
    n = lane.shape[0]
    g = torch.Generator(device=DEVICE).manual_seed(24)
    it = torch.randint(0, 2**20, (n,), device=DEVICE, generator=g, dtype=torch.int32)
    depth = torch.randint(0, 256, (n,), device=DEVICE, generator=g, dtype=torch.int32)
    view, o = view.clone(), o.clone()
    view[:64], o[64:128] = float("nan"), float("nan")
    cases["camera, per-lane counters, NaN points"] = (view, lane, it, depth, n, nee,
                                                      (o, point, nrm, tri, geom))
    torch.cuda.synchronize()
    return cases


def light_bound(kname: str, kinds: dict) -> tuple[float, str, float]:
    """(ms, what bounds it, operations a lane) of L1 or L2 over lanes of the
    branches `kinds` (branch -> lanes): the larger of LIGHT_BYTES a lane over
    the memory rate and LIGHT_OPS over SWEEP_OP_RATE."""
    n = sum(kinds.values())
    ops = sum(LIGHT_OPS[kname][k] * c for k, c in kinds.items())
    bytes_ms, ops_ms = n * LIGHT_BYTES[kname] / PEAK_BYTES * 1e3, ops / SWEEP_OP_RATE * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, ops / n


def light_kinds(flat, static, view, lane, key, it, depth, pixel0, hits) -> tuple[dict, dict]:
    """The lanes of each branch that L1 (the picked light's type) and L2
    (the hit's) run."""
    import torch

    from pathtracer_tpu_torch.ops import lights_cuda as lc
    from pathtracer_tpu_torch.scene.parser import SPHERE

    rands = lc.light_draw_plain(key, it, depth, lane, pixel0)
    lid = torch.clamp(rands[:, 0] * static.num_lights, max=static.num_lights - 1.0).long()
    tri = flat.light_tri[lid] >= 0
    sphere = ~tri & (flat.geom_type[flat.light_geom[lid].long()] == SPHERE)
    l1 = {"triangle": int(tri.sum()), "sphere": int(sphere.sum())}
    _, _, _, tri_id, geom = hits
    hit_sphere = (geom >= 0) & (flat.geom_type[geom.clamp(min=0).long()] == SPHERE)
    l2 = {"sphere": int(hit_sphere.sum()), "triangle": int((~hit_sphere & (tri_id >= 0)).sum())}
    n = lane.shape[0]
    return ({**l1, "other": n - sum(l1.values())}, {**l2, "other": n - sum(l2.values())})


def phase_light_kernels(r, scene: str) -> dict:
    """L1 and L2 (csrc/lights.cu) against their plain versions on renderer
    `r`'s NEE inputs (light_lane_cases), bit for bit on every output and
    lane, NaN where NaN: L1 against pixel_uniforms (STAGE_LIGHT) +
    light_samples with and without the NEE mask, L2 against light_pdf; each
    wrapper launches once a call.  Median times of kernel and plain version
    beside the bound (light_bound).  Returns the kernels line's rows (the
    camera lap)."""
    import torch

    from pathtracer_tpu_torch.ops import lights_cuda as lc

    flat, static, key = r.flat, r.static, r.key
    rows = {}
    for k, (label, (view, lane, it, depth, pixel0, nee, hits)) in enumerate(
            light_lane_cases(r).items()):
        calls = {
            "L1": (lambda: lc.sample_lights(flat, static, view, key, it, depth, lane, pixel0, nee),
                   lambda: lc.sample_lights_plain(flat, static, view, key, it, depth, lane, pixel0,
                                                  nee)),
            "L2": (lambda: lc.eval_light_pdf(flat, static, *hits),
                   lambda: lc.eval_light_pdf_plain(flat, static, *hits)),
        }
        checks = dict(calls, **{"L1, no mask": (
            lambda: lc.sample_lights(flat, static, view, key, it, depth, lane, pixel0),
            lambda: lc.sample_lights_plain(flat, static, view, key, it, depth, lane, pixel0))})
        for name, (kernel, plain) in checks.items():
            tag = name[:2]
            n0 = _build.launches[tag]
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if _build.launches[tag] != n0 + 1:
                raise AssertionError(f"{name} {label}: the wrapper did not launch once")
            names = want._fields if tag == "L1" else ("pdf",)
            got, want = (tuple(got), tuple(want)) if tag == "L1" else ((got,), (want,))
            same = {nm: same_bits(a, b) for nm, a, b in zip(names, got, want)}
            err = max(_max_err(torch.nan_to_num(a.float()), torch.nan_to_num(b.float()))
                      for a, b in zip(got, want))
            log(f"{name} {scene} {label}: {lane.shape[0]} lanes; bitwise equal to the plain "
                f"version: {same}, max_abs_err {err}")
            if not all(same.values()):
                raise AssertionError(f"{name} differs from its plain version ({scene}, {label})")
        if k:  # the camera lap is timed; the other sets are checked
            continue
        kinds = dict(zip(("L1", "L2"),
                         light_kinds(flat, static, view, lane, key, it, depth, pixel0, hits)))
        for kname, (kernel, plain) in calls.items():
            ms = median_ms(kernel)
            plain_ms = median_ms(plain)
            b_ms, by, ops = light_bound(kname, kinds[kname])
            log(f"{kname} time at {lane.shape[0]} {label} lanes of {scene} (branches "
                f"{kinds[kname]}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 5); "
                f"{ops:.1f} operations a lane, bound {b_ms:.4f} ms ({by}), kernel / bound "
                f"{ms / b_ms:.2f}")
            rows[kname] = (0.0, ms, plain_ms, (b_ms, by))
    return {
        "L1": ("sample_lights", SRC_LIGHTS, "none (plain jnp: pathtracer_tpu/utils/rng.py "
               "pixel_uniforms and pathtracer_tpu/ops/lights.py light_sample)", *rows["L1"]),
        "L2": ("eval_light_pdf", SRC_LIGHTS, "none (plain jnp: pathtracer_tpu/ops/lights.py "
               "light_pdf)", *rows["L2"]),
    }


def launches_since(k0: dict) -> dict:
    """The kernel launches by tag since `k0`, a copy of the launch table
    (ops/_build.py launches)."""
    return {tag: n - k0[tag] for tag, n in _build.launches.items()}


@contextlib.contextmanager
def blockmajor(on: bool):
    """STREAM_BLOCKMAJOR set to `on` inside the block, restored after."""
    from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts

    was, ts.STREAM_BLOCKMAJOR = ts.STREAM_BLOCKMAJOR, on
    try:
        yield
    finally:
        ts.STREAM_BLOCKMAJOR = was


def phase_main_path(built, used: tuple, unused: tuple, card: str, label: str = ""):
    """The port's main path on a Renderer built by `build_renderer`, as a
    user calls it: `step(SPP)` from a fresh accumulation, its rate printed
    beside `card` (nvidia-smi's name and power limit).  The kernels in
    `used` must launch and those in `unused` must not.  Returns the launch
    counts and the image (the accumulated HDR sum)."""
    import numpy as np

    from pathtracer_tpu_torch.integrator.render import RenderStats

    r, parse_s, tables_s = built
    r.reset()
    r.stats = RenderStats()
    k0 = dict(_build.launches)
    stats = r.step(SPP)
    launches = launches_since(k0)
    img = r.hdr_sum()
    out = ROOT / "pathtracer_tpu_torch" / "_build" / f"{r.static.image_name}{label}_mis_{RES}.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    r.save_png(out)
    log(f"main path: {r.static.image_name}{label} MIS {RES}x{RES} depth {DEPTH} {SPP} spp: "
        f"{stats.mrays_per_sec:.3f} Mrays/s, {stats.rays_traced} rays in "
        f"{stats.wall_seconds:.3f} s wall over {stats.iterations_done - 1} timed iterations on {card} "
        f"({statistics.mean(stats.per_iter_seconds):.4f} s/iteration; warm-up "
        f"{stats.compile_seconds:.3f} s); host set-up: parse {parse_s:.3f} s, tables (BVH, "
        f"wide collapse, stream split, upload) {tables_s:.3f} s; launches {launches}, "
        f"image mean {float(img.mean()) / r.iteration:.5f}, saved {out.relative_to(ROOT)}")
    if not all(launches[k] > 0 for k in used) or any(launches[k] for k in unused):
        raise AssertionError(f"main path on {r.static.image_name}{label} launched {launches}; "
                             f"needs {used} and none of {unused}")
    if not (np.isfinite(img).all() and img.mean() > 0 and stats.rays_traced > 0):
        raise AssertionError("main path image is not finite and positive")
    if not (r.graph_route and r.graphs is not None and r.graphs.num_graphs):
        raise AssertionError(f"main path on {r.static.image_name}{label} did not replay graphs")
    log(f"main path: {r.static.image_name}{label}: {r.graphs.num_graphs} graphs captured in "
        f"{r.graphs.capture_seconds:.3f} s, {r.graphs.replays} replays")
    return launches, img


def phase_schedules(built, card: str, used: tuple, unused: tuple, label: str = ""):
    """The scheduler and ray regeneration on a main path, on the Renderer
    (and tables) that `build_renderer` built: step(1 + REGEN_K) from a fresh
    accumulation with each of SCHEDULES and with ray_regen=REGEN_K.  The
    schedules' HDR sums must be bitwise equal and their rays equal; the
    regeneration batch within the image tolerance of them, rays equal.
    Prints, per path, the seconds and K1-K5, S1 and S2 launches per
    iteration, the laps per sample and the pool's length at each lap, then
    the kernel launches and device-busy ms per sample under the profiler
    over one more iteration (a batch of REGEN_K under regeneration).  Each
    path must
    launch the kernels in `used` and none in `unused`."""
    import dataclasses

    import numpy as np

    from pathtracer_tpu_torch.integrator.render import RenderStats
    from tools.profile_torch_port import pool_runs, profile_step

    r = built[0]
    base = r.opts
    name = f"{r.static.image_name}{label}"
    results = {}
    try:
        for path, options in SCHEDULES + ((f"ray_regen={REGEN_K}", {"ray_regen": REGEN_K}),):
            r.opts = dataclasses.replace(base, **options)
            r.reset()
            r.stats = RenderStats()
            k0 = dict(_build.launches)
            stats = r.step(1 + REGEN_K)
            launches = launches_since(k0)
            img, pools = r.hdr_sum(), list(r.lap_pools)
            stats = dataclasses.replace(stats, per_iter_seconds=list(stats.per_iter_seconds))
            samples = 1 + REGEN_K
            prof = profile_step(r, REGEN_K if r.regen_k else 1)
            per = REGEN_K if r.regen_k else 1
            traversal = {k: launches[k] / samples for k in ("K1", "K2", "K3", "K4", "K5")}
            sweep = {k: launches[k] / samples for k in ("S1", "S2")}
            log(f"schedule: {name} MIS {RES}x{RES} depth {DEPTH}, {path}: "
                f"{statistics.mean(stats.per_iter_seconds):.4f} s/iteration over {REGEN_K} timed "
                f"samples on {card} ({stats.mrays_per_sec:.3f} Mrays/s, {stats.rays_traced} rays); "
                f"launches per iteration K1-K5 {traversal} (K1-K5 {sum(traversal.values()):.3f}), "
                f"S1-S2 {sweep}, "
                f"device ops {prof['launches'] / per:.1f}, host-issued launches "
                f"{prof['host_launches'] / per:.1f}, device busy "
                f"{prof['busy_us'] / per / 1e3:.3f} ms, busy share "
                f"{prof['busy_us'] / 1e6 / prof['wall']:.4f} (profiler, {per} sample(s)); laps per "
                f"sample {stats.laps / REGEN_K:.3f}; pool length at each lap of the last "
                f"{'batch' if r.regen_k else 'iteration'}: {pool_runs(pools)}")
            if not all(launches[k] > 0 for k in used) or any(launches[k] for k in unused):
                raise AssertionError(f"{name} {path} launched {launches}; needs {used} and none "
                                     f"of {unused}")
            if not (np.isfinite(img).all() and img.mean() > 0):
                raise AssertionError(f"{name} {path}: the image is not finite and positive")
            results[path] = (img, stats.rays_traced)
    finally:
        r.opts = base
    (ref_path, (ref, ref_rays)), *rest = results.items()
    for path, (img, rays) in rest:
        same = np.array_equal(img, ref)
        log(f"schedule: {name} {path} against {ref_path}: HDR sum bitwise equal: {same}, "
            f"rays {rays} against {ref_rays}")
        if rays != ref_rays:
            raise AssertionError(f"{name}: {path} counted other rays than {ref_path}")
        if path.startswith("ray_regen"):
            compare_images(f"schedule: {name} {path} against {ref_path}", img, ref)
        elif not same:
            raise AssertionError(f"{name}: {path} changed the image")


def compare_images(what, a, b) -> float:
    """Share of pixels of a within the slice tolerance of b; raises below
    IMG_MIN_FRAC."""
    import numpy as np

    ok = np.isclose(a, b, rtol=IMG_RTOL, atol=IMG_ATOL).all(-1)
    same = int((a == b).all(-1).sum())
    log(f"{what}: {ok.mean():.5f} of pixels within rtol {IMG_RTOL} atol {IMG_ATOL} "
        f"({int((~ok).sum())} outliers; need >= {IMG_MIN_FRAC}); {same} of {ok.size} pixels "
        f"bitwise equal")
    if ok.mean() < IMG_MIN_FRAC:
        raise AssertionError(f"{what}: the images disagree")
    return float(ok.mean())


def phase_card_vs_cpu(scene_path, k5: bool = False, **options):
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    imgs = {}
    with blockmajor(k5):
        for dev in (DEVICE, "cpu"):
            r = Renderer(scene_path, RenderOptions(sample_mode=SampleMode.MIS, **options),
                         resolution=(64, 64), trace_depth=DEPTH, device=dev)
            r.step(2)
            imgs[dev] = r.hdr_sum()
    what = "".join([" (STREAM_BLOCKMAJOR)" if k5 else ""] + [f" ({k})" for k in options])
    compare_images(f"card vs cpu: {scene_path.name}{what} MIS 64x64 depth {DEPTH} 2 spp",
                   imgs[DEVICE], imgs["cpu"])


def phase_rgbe_scale():
    """The RGBE texel scale 2^(e - 136), built from its bits, on the card
    against the CPU for every exponent byte."""
    import torch

    from pathtracer_tpu_torch.ops.texture import _rgbe_scale

    e = torch.arange(256, dtype=torch.int32)
    got, want = _rgbe_scale(e.to(DEVICE)).cpu(), _rgbe_scale(e)
    log(f"RGBE scale: card equal to CPU for all 256 exponents: {torch.equal(got, want)}")
    if not torch.equal(got, want):
        raise AssertionError("the RGBE scale differs between the card and the CPU")


def timed_step(r, n: int) -> float:
    """Seconds per iteration of `r.step(n)` after a warm-up iteration when
    the renderer is fresh (host clock; the step ends in a synchronize)."""
    if r.iteration == 0:
        r.step(1)
    r.stats.per_iter_seconds.clear()
    r.step(n)
    return statistics.mean(r.stats.per_iter_seconds)


def phase_checkpoint(scene_path, card: str):
    """Checkpoint/resume on the main path: 3 spp, save_checkpoint, 2 more; a
    new Renderer loads the file and renders 2: the HDR sums bitwise equal
    and the rays of the last 2 spp equal.  Then the same with ray_regen=8
    (resumed against interrupted bitwise; both against an uninterrupted
    5 spp within the image tolerance, as the batches move).  K1 and K2
    must launch."""
    import numpy as np

    out = ROOT / "pathtracer_tpu_torch" / "_build" / "smoke_checkpoint.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    k0 = dict(_build.launches)
    for options in ({}, {"ray_regen": REGEN_K}):
        label = "".join(f", {k}={v}" for k, v in options.items())
        a = build_renderer(scene_path, **options)[0]
        a.step(3)
        a.save_checkpoint(out)
        before = a.stats.rays_traced
        a.step(2)
        rays_a = a.stats.rays_traced - before
        b = build_renderer(scene_path, **options)[0]
        b.load_checkpoint(out)
        if b.iteration != 3:
            raise AssertionError(f"the checkpoint resumed at iteration {b.iteration}, not 3")
        b.step(2)
        img_a, img_b = a.hdr_sum(), b.hdr_sum()
        same = np.array_equal(img_a, img_b)
        log(f"checkpoint: {r_name(a)} MIS {RES}x{RES} depth {DEPTH}{label}: 3 spp, saved "
            f"({out.stat().st_size} bytes), 2 more against a new Renderer resumed from the file "
            f"for 2: HDR sum bitwise equal: {same}, rays {rays_a} against {b.stats.rays_traced}")
        if not same or rays_a != b.stats.rays_traced:
            raise AssertionError(f"the resumed render differs from the interrupted one{label}")
        if options:
            c = build_renderer(scene_path, **options)[0]
            c.step(5)
            compare_images(f"checkpoint: resumed{label} against uninterrupted 5 spp", img_b,
                           c.hdr_sum())
        del a, b
    launches = launches_since(k0)
    log(f"checkpoint phase: {time.perf_counter() - t0:.1f} s on {card}; launches {launches}")
    if not (launches["K1"] and launches["K2"]):
        raise AssertionError(f"the checkpoint phase launched {launches}; needs K1 and K2")


def r_name(r) -> str:
    return r.static.image_name


def phase_preview(scene_path, card: str):
    """The preview server on the card, driven over HTTP on port 0: the page,
    /frame.png (decoded by the port's PNG reader), /stats.json rising,
    /orbit, /zoom and /pan each raising accum_resets and restarting the
    iteration count, /mode?m=0 (a new renderer on the card in BSDF mode; the
    old one freed), /save.  K1 and K2 must launch."""
    import gc
    import os
    import urllib.request
    import weakref

    import torch

    from pathtracer_tpu_torch.preview.server import start_preview_thread
    from pathtracer_tpu_torch.utils.config import SampleMode
    from pathtracer_tpu_torch.utils.image_io import _decode_png

    workdir = ROOT / "pathtracer_tpu_torch" / "_build"
    here = Path.cwd()
    os.chdir(workdir)  # /save writes <image name>.preview.png where it runs
    t0 = time.perf_counter()
    k0 = dict(_build.launches)
    state, server, loop = start_preview_thread(build_renderer(scene_path)[0], port=0, chunk=1)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as f:
            return f.read()

    def stats():
        return json.loads(get("/stats.json") or b"{}")

    def wait_for(pred, what, timeout=60.0):
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if pred():
                return
            time.sleep(0.02)
        raise AssertionError(f"preview: timed out waiting for {what}")

    try:
        if b"pathtracer_tpu" not in get("/"):
            raise AssertionError("preview: the page is not served")
        wait_for(lambda: stats().get("iteration", 0) >= 2, "two iterations")
        frame = _decode_png(get("/frame.png"))
        if frame is None or frame.shape != (RES, RES, 3):
            raise AssertionError(f"preview: /frame.png is not a {RES}x{RES} PNG")
        it0, t_it0 = stats()["iteration"], time.perf_counter()
        wait_for(lambda: stats()["iteration"] >= it0 + 3, "the iteration count to rise")
        fps = (stats()["iteration"] - it0) / (time.perf_counter() - t_it0)
        events = []
        for path in ("/orbit?dtheta=10&dphi=-15", "/zoom?dy=0.2", "/pan?dx=40&dy=-20"):
            wait_for(lambda: state.renderer.iteration >= 3, "three iterations")
            resets, before = state.accum_resets, state.renderer.iteration
            get(path)
            wait_for(lambda: state.accum_resets > resets, f"{path} to reset")
            after = state.renderer.iteration
            events.append(f"{path.split('?')[0]}: iteration {before} -> {after}")
            if after >= before:
                raise AssertionError(f"preview: {path} did not restart the iteration count")
        old = weakref.ref(state.renderer)
        get("/mode?m=0")
        wait_for(lambda: stats().get("mode") == "BSDF", "the mode switch")
        r = state.renderer
        if r.device.type != torch.device(DEVICE).type or r.opts.sample_mode != SampleMode.BSDF or (
                r.width, r.height, r.static.trace_depth) != (RES, RES, DEPTH):
            raise AssertionError("preview: the mode switch left the card, the size or the depth")
        del r
        gc.collect()
        freed = old() is None
        saved = workdir / f"{state.renderer.static.image_name}.preview.png"
        saved.unlink(missing_ok=True)
        get("/save")
        wait_for(lambda: saved.exists() and saved.stat().st_size > 0, "/save")
        time.sleep(0.5)  # the loop thread finishes writing
        png = _decode_png(saved.read_bytes())
        if png is None or png.shape != (RES, RES, 3):
            raise AssertionError("preview: /save did not write the frame")
    finally:
        state.running = False
        server.shutdown()
        loop.join(timeout=120)
        os.chdir(here)
    launches = launches_since(k0)
    log(f"preview: {RES}x{RES} depth {DEPTH} MIS, 1 spp a frame, {fps:.3f} frames/s on {card}; "
        f"{'; '.join(events)}; mode switch to BSDF on {state.renderer.device}, old renderer "
        f"freed: {freed}, {torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated after; "
        f"saved {saved.name}; {time.perf_counter() - t0:.1f} s; launches {launches}")
    if not freed:
        raise AssertionError("preview: the mode switch kept the old renderer's tables")
    if not (launches["K1"] and launches["K2"]):
        raise AssertionError(f"preview launched {launches}; needs K1 and K2")
    del state


def phase_bench(scene_path, card: str):
    """`cli bench` as a user calls it: its JSON line, printed beside the card."""
    import io

    from pathtracer_tpu_torch import cli

    buf = io.StringIO()
    k0 = dict(_build.launches)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", str(scene_path), "--mode", "mis", "--res", f"{RES}x{RES}",
                       "--spp", str(SPP)])
    line = buf.getvalue().strip().splitlines()[-1]
    result = json.loads(line)
    launches = launches_since(k0)
    log(f"bench on {card}: {json.dumps(result)}; launches {launches}")
    if rc != 0 or result["rays_traced"] <= 0 or result["spp"] != SPP:
        raise AssertionError(f"bench failed: rc {rc}, {line}")
    if not (launches["K1"] and launches["K2"]):
        raise AssertionError(f"bench launched {launches}; needs K1 and K2")


def compare_walk(label, got, ref):
    """A walk's (t, tri, u, v) against a kernel's on the same rays: lanes
    whose triangle differs, of which those with t bitwise equal are exact
    ties; any other difference fails."""
    import torch

    torch.cuda.synchronize()
    differ = got[1] != ref[1]
    ties = differ & (got[0] == ref[0])
    hit = ref[1] >= 0
    t_err = _max_err(got[0][hit], ref[0][hit])
    same_t = float((got[0][hit] == ref[0][hit]).float().mean()) if bool(hit.any()) else 1.0
    log(f"{label}: {got[1].shape[0]} lanes, {int(hit.sum())} hits, triangle ids differ on "
        f"{int(differ.sum())} lanes ({int(ties.sum())} exact-t ties), t max abs err {t_err:.3g}, "
        f"t bitwise equal on {same_t:.6f} of the hits")
    if int((differ & ~ties).sum()):
        raise AssertionError(f"{label}: the walk found other triangles")
    return int(differ.sum())


def walk_rays(r):
    """Camera rays and one bounce's continuation pool of renderer `r` at RES x
    RES, with their analytic t (the walks' budget) and the pool's live lanes."""
    from pathtracer_tpu_torch.integrator.wavefront import bounce, camera_rays, new_pool
    from pathtracer_tpu_torch.ops import sweep_cuda as sw
    from pathtracer_tpu_torch.ops import traverse as tv
    from pathtracer_tpu_torch.utils.config import SampleMode

    flat, static = r.flat, r.static
    o, d = camera_rays(r._cam_arrays(), RES, RES, r.key, 1, pixel_xy=r.pixel_xy)
    pool, _ = bounce(flat, static, SampleMode.MIS, r.key, 1, 0, new_pool(o, d))
    cases = {}
    for label, (ro, rd, live) in (("camera", (o, d, None)),
                                  ("continuation", (pool.o, pool.d, pool.alive))):
        t_geo, *_ = sw.geoms_closest(flat, static, ro, rd)
        cases[label] = (ro, rd, t_geo, live)
    return cases


def check_mtbvh(r, kname: str) -> None:
    """The MTBVH walk against the kernel `kname` that renderer `r`'s main
    path runs, on walk_rays, timed on the host clock."""
    import torch

    from pathtracer_tpu_torch.ops import traverse as tv

    flat, static = r.flat, r.static
    for label, (ro, rd, t_geo, live) in walk_rays(r).items():
        t0 = time.perf_counter()
        got = tv.mtbvh_closest(flat, static, ro, rd, t_geo, live=live)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ref = tv._kernel_closest(flat, static, tv.walk_route(static).kind, ro, rd, t_geo, live)
        compare_walk(f"MTBVH walk ({static.num_bvh_trees} tree(s) of {static.num_bvh_nodes} "
                     f"nodes, {secs:.3f} s) vs {kname}, {r_name(r)} {label} rays", got, ref)


def phase_walks(resident, stream, card: str):
    """The MTBVH walk (pallas_traversal=False) against K1 on glasstorus and
    K3 on glasstorus160k (six trees each), on the camera rays and one
    bounce's continuation pool at RES x RES lanes; the sweep (use_bvh=False)
    against K1 on a few thousand of glasstorus's lanes; then 128x128 MIS
    renders of glasstorus with each option against the default render,
    with their seconds per iteration."""
    import torch

    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.ops import traverse as tv
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    t_phase = time.perf_counter()
    check_mtbvh(resident, "K1")
    check_mtbvh(stream, "K3")
    flat, static = resident.flat, resident.static
    cases = walk_rays(resident)
    for label, (ro, rd, t_geo, live) in cases.items():
        pick = torch.arange(0, ro.shape[0], 157, device=DEVICE)  # 4,077 lanes
        sub = (ro[pick], rd[pick], t_geo[pick], None if live is None else live[pick])
        t0 = time.perf_counter()
        got = tv.sweep_closest(flat, static, *sub[:3], live=sub[3])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        compare_walk(f"sweep ({static.num_tris} triangles, {secs:.3f} s) vs K1, {r_name(resident)} "
                     f"{label} rays", got,
                     tv._kernel_closest(flat, static, "resident", *sub[:3], sub[3]))
    imgs, secs = {}, {}
    for name, options in (("default", {}), ("pallas_traversal=False", {"pallas_traversal": False}),
                          ("use_bvh=False", {"use_bvh": False})):
        k0 = dict(_build.launches)
        r = Renderer(SCENE, RenderOptions(sample_mode=SampleMode.MIS, **options),
                     resolution=(128, 128), trace_depth=DEPTH, device=DEVICE)
        secs[name] = timed_step(r, 1)
        imgs[name] = r.hdr_sum()
        launches = launches_since(k0)
        log(f"walks: glasstorus MIS 128x128 depth {DEPTH}, {name}: {secs[name]:.4f} s/iteration "
            f"on {card}; launches {launches}")
        if name != "default" and any(launches[k] for k in WALK_TAGS):
            raise AssertionError(f"the {name} render launched a walk kernel: {launches}")
    for name in ("pallas_traversal=False", "use_bvh=False"):
        compare_images(f"walks: {name} against the default render (128x128, 2 spp)",
                       imgs[name], imgs["default"])
    log(f"walks phase: {time.perf_counter() - t_phase:.1f} s")


def shard_mesh() -> list:
    """The mesh of phases 16 and 20: the first min(4, count) distinct cards,
    or with one card that card twice (the shards then share it, and no
    concurrency is measured)."""
    import torch

    count = torch.cuda.device_count()
    if count >= 2:
        return [torch.device("cuda", i) for i in range(min(SHARD_CARDS, count))]
    log("sharding: one card visible: two shards share cuda:0, no concurrency measured")
    return [torch.device("cuda", 0)] * 2


@contextlib.contextmanager
def mesh_of(mesh: list):
    """Renderer(devices=len(mesh)) takes `mesh` inside the block, which may
    repeat the one card (make_mesh takes distinct visible cards)."""
    from pathtracer_tpu_torch.parallel import sharding as sh

    was = sh.make_mesh
    sh.make_mesh = lambda n_devices=None, devices=None: list(mesh)
    try:
        yield
    finally:
        sh.make_mesh = was


def sync_all(mesh: list) -> None:
    import torch

    for dev in dict.fromkeys(mesh):
        torch.cuda.synchronize(dev)


def shard_launches(r) -> list:
    """The K1-K5 launches each shard's replays added (StaticIteration.launches)."""
    return [tuple(it.launches[t] for t in WALK_TAGS) for it in r.shard_step.shards.iterations]


def eager_sharded_seconds(r, mesh: list, iterations: int):
    """The eager sharded route, the shards one after another through
    make_render_iteration on the eager loop, over iterations 1 ..
    `iterations` (the graph route has loaded every kernel on every card):
    (image, seconds per iteration)."""
    from pathtracer_tpu_torch.integrator.wavefront import CameraArrays, make_render_iteration
    from pathtracer_tpu_torch.parallel import sharding as sh
    from tools.profile_torch_port import eager_route

    ph = sh.padded_height(r.height, len(mesh))
    local = ph // len(mesh)
    step = make_render_iteration(r.static, r.opts, r.width, r.height, local_rows=local)
    tables = r.shard_step.shards.tables
    flats = [tables.flat(r.flat, dev) for dev in mesh]
    cams = [CameraArrays(*(t.to(dev) for t in r._cam_arrays())) for dev in mesh]
    img, secs = sh.zeros_image(r.width, r.height, mesh), []
    with eager_route():
        for it in range(1, iterations + 1):
            t0 = time.perf_counter()
            img = [step(flats[d], cams[d], img[d], it, r.key, d * local * r.width)[0]
                   for d in range(len(mesh))]
            sync_all(mesh)
            secs.append(time.perf_counter() - t0)
    return sh.fetch_image(img, r.width, r.height), secs


def profile_shards(r, name: str, card: str) -> bool:
    """One iteration of sharded renderer `r` under the profiler, logged:
    each card's device-busy ms and K1-K5 runs.  True when each card's runs
    equal the launch counts its shards' replays added, their sum the launch
    counters', and every card of the mesh was busy."""
    from tools.profile_torch_port import profile_step

    tags = ("K1", "K2", "K3", "K4", "K5")
    k0 = dict(_build.launches)
    before = shard_launches(r)
    prof = profile_step(r, 1)
    counted = [launches_since(k0)[t] for t in tags]
    by_card = {}
    for dev, now, was in zip(r.mesh, shard_launches(r), before):
        tally = by_card.setdefault(dev.index, [0] * len(tags))
        by_card[dev.index] = [t + a - b for t, a, b in zip(tally, now, was)]
    runs = {k: [v[t] for t in tags] for k, v in prof["traversal_by_card"].items()}
    log(f"sharding: {name}, one iteration under the profiler: device busy ms by card "
        + ", ".join(f"cuda:{k} {v / 1e3:.3f}" for k, v in sorted(prof["busy_by_card"].items()))
        + f", wall {prof['wall'] * 1e3:.3f} ms; {prof['launches']} device ops, "
        f"{prof['host_launches']} host-issued launches ({prof['graph_launches']} graph "
        f"launches); host ms in " + ", ".join(
            f"{k} {prof['host_us'].get(k, 0.0) / 1e3:.3f} ({prof['host_calls'].get(k, 0)} calls)"
            for k in ("cudaGraphLaunch", "cudaStreamSynchronize", "cudaMemcpyAsync"))
        + f"; K1-K5 runs on the device by card {runs}, counted {counted}, the shards' by "
        f"card {by_card} on {card}")
    return (runs == {k: v for k, v in by_card.items() if any(v)}
            and counted == [sum(c) for c in zip(*by_card.values())]
            and set(prof["busy_by_card"]) == {dev.index for dev in r.mesh})


def one_device_seconds(r, iterations: int):
    """The one-device graph route on sharded renderer `r`'s tables (on its
    first card): make_render_iteration's step of the whole film, iterations
    1 .. `iterations` + 1, the first its warm-up (the capture).  Returns
    (the step, the HDR sum as (H, W, 3), the rays of the timed iterations,
    their seconds, the warm-up's seconds)."""
    import torch

    from pathtracer_tpu_torch.integrator.wavefront import make_render_iteration

    step = make_render_iteration(r.static, r.opts, r.width, r.height)
    cam, dev = r.camera.as_arrays(), r.flat.device
    img, rays, secs = torch.zeros((r.width * r.height, 3), device=dev), 0, []
    for it in range(1, iterations + 2):
        t0 = time.perf_counter()
        img, n, _ = step(r.flat, cam, img, it, r.key)
        n = int(n)
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
        rays += n if it > 1 else 0
    return step, img.cpu().numpy().reshape(r.height, r.width, 3), rays, secs[1:], secs[0]


def phase_sharding(card: str):
    """Phase 16: Renderer(devices=N) over shard_mesh() on the graph route,
    each shard's iteration replayed as CUDA graphs on its own card in
    lockstep, against the one-device graph route (make_render_iteration's
    step on the renderer's tables, swizzle off): the HDR sums bitwise and
    the rays equal (more with padding rows) on SHARD_CASES; s/iteration
    (medians of SHARD_ITERS) of both and, on glasstorus, of the eager route
    (the shards in turn on the eager loop, its image bitwise too); each
    shard's graphs and capture seconds, each card's memory reserved at most
    and, for one more iteration under the profiler, each card's device-busy
    ms and K1-K5 runs, held to the shards' launch counters (after every
    case's timing); on glasstorus one sample_parallel_step against the
    sequential one-device iterations, bitwise.  Held under SHARD_PHASE_S."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.parallel import sharding as sh
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    t_phase = time.perf_counter()
    mesh = shard_mesh()
    cards = list(dict.fromkeys(mesh))
    for dev in cards:
        torch.cuda.reset_peak_memory_stats(dev)
    n = len(mesh)
    log(f"sharding: {n} shards on {len(cards)} distinct card(s): {', '.join(map(str, mesh))}")
    secs, traced = {}, []
    for name, scene_path, res, used, profiled in SHARD_CASES:
        t_case = time.perf_counter()
        opts = RenderOptions(sample_mode=SampleMode.MIS, swizzle=False)
        with mesh_of(mesh) if len(cards) < n else contextlib.nullcontext():
            r = Renderer(scene_path, opts, resolution=res, trace_depth=DEPTH, devices=n,
                         device=DEVICE)
        if not r.graph_route or r.mesh != mesh:
            raise AssertionError(f"sharding: {name}: not on the graph route over {mesh}")
        one, want, rays_one, one_s, one_warm = one_device_seconds(r, SHARD_ITERS)
        r.step(1)
        its = r.shard_step.shards.iterations
        if len(its) != n or not all(it.graphs and it.num_graphs for it in its):
            raise AssertionError(f"sharding: {name}: the shards did not capture graphs")
        k0 = dict(_build.launches)
        before = shard_launches(r)
        for _ in range(SHARD_ITERS):
            r.step(1)
            if r.iteration == SHARD_ITERS:
                got_eager_span = r.hdr_sum()  # iterations 1 .. SHARD_ITERS
        counted = {k: v for k, v in launches_since(k0).items() if k[0] == "K"}
        per_shard = [tuple(a - b for a, b in zip(x, y)) for x, y in zip(shard_launches(r), before)]
        got, rays = r.hdr_sum(), r.stats.rays_traced
        shard_s = list(r.stats.per_iter_seconds)
        same = np.array_equal(got, want)
        padded = r.shard_step.shards.local_rows * n != res[1]
        summed = dict(zip(("K1", "K2", "K3", "K4", "K5"), map(sum, zip(*per_shard))))
        log(f"sharding: {name} MIS {res[0]}x{res[1]} depth {DEPTH}, {n} shards on {len(cards)} "
            f"card(s) (rows padded: {padded}): HDR sum bitwise the one-device graph route's: "
            f"{same}; rays {rays} (one device {rays_one}); {r.traced_depth} laps at most; "
            f"s/iteration medians of {SHARD_ITERS}: sharded graphs "
            f"{statistics.median(shard_s):.4f} ({', '.join(f'{x:.4f}' for x in shard_s)}), one "
            f"device graphs {statistics.median(one_s):.4f} "
            f"({', '.join(f'{x:.4f}' for x in one_s)}); K1-K5 launches counted {counted}, the "
            f"shards' {summed}; graphs per shard {[it.num_graphs for it in its]}, capture s "
            f"{[round(it.capture_seconds, 3) for it in its]} (one device's warm-up with its "
            f"capture {one_warm:.3f} s); memory reserved at most "
            + ", ".join(f"{dev} {torch.cuda.max_memory_reserved(dev) / 2**20:.1f} MiB"
                        for dev in cards) + f" on {card}")
        secs[name] = {"sharded graphs": statistics.median(shard_s),
                      "one-device graphs": statistics.median(one_s)}
        if not same or (rays != rays_one) != padded or (padded and rays < rays_one):
            raise AssertionError(f"sharding: the sharded render of {name} differs")
        if counted != summed or not all(counted[k] > 0 for k in used) or any(
                v for k, v in counted.items() if k not in used):
            raise AssertionError(f"sharding: {name}: K1-K5 counted {counted}, the shards' "
                                 f"{summed}; must be equal, only {used} launched")
        if profiled:
            traced.append((name, r))
        if name == "glasstorus":
            eager_img, eager_s = eager_sharded_seconds(r, mesh, SHARD_ITERS)
            secs[name]["sharded eager"] = statistics.median(eager_s)
            same = np.array_equal(eager_img, got_eager_span)
            log(f"sharding: {name}: the eager shards (make_render_iteration on the eager loop, "
                f"shards in turn) {statistics.median(eager_s):.4f} s/iteration (median of "
                f"{len(eager_s)}: {', '.join(f'{x:.4f}' for x in eager_s)}); its image after "
                f"{SHARD_ITERS} iterations bitwise the sharded graph route's: {same}")
            if not same:
                raise AssertionError("sharding: the eager shards differ from the graph route")
            # sample space: device d renders iteration d + 1 of the whole film
            sstep, combine = sh.sample_parallel_step(r.static, r.opts, r.width, r.height, mesh)
            cam = r.camera.as_arrays()
            img, srays = sstep(r.flat, cam, [torch.zeros((r.width * r.height, 3), device=d)
                                             for d in mesh], 1, r.key)
            sample = combine(img).cpu().numpy()
            seq, seq_rays = torch.zeros((r.width * r.height, 3), device=r.flat.device), 0
            for it in range(1, n + 1):
                seq, r_it, _ = one(r.flat, cam, seq, it, r.key)
                seq_rays += int(r_it)
            same = np.array_equal(sample, seq.cpu().numpy())
            on_graphs = all(it.graphs for it in sstep.shards.iterations)
            log(f"sharding: sample_parallel_step over {mesh} (iterations 1-{n}) on {name} "
                f"{r.width}x{r.height}: bitwise the sequential one-device iterations: {same}; "
                f"rays {int(srays)} against {seq_rays}; the shards on the graph route: "
                f"{on_graphs}")
            if not same or int(srays) != seq_rays or not on_graphs:
                raise AssertionError("sharding: sample_parallel_step differs from the "
                                     "sequential iterations")
            del sstep, img
        log(f"sharding: {name}: {time.perf_counter() - t_case:.1f} s for the case")
        del r, one
    # traced last: once torch.profiler has run, the process's graph launches stay slower
    # (four cards: 0.061 s an iteration of glasstorus before a trace, 0.088 after)
    for name, r in traced:
        if not profile_shards(r, name, card):
            # a trace may miss events (one of 16 K2 runs, and a whole lap graph's 2,451
            # events, while the graphs replayed are fixed): the next iteration's must agree
            log(f"sharding: {name}: the trace disagrees with the counters; one more iteration")
            if not profile_shards(r, name, card):
                raise AssertionError(f"sharding: {name}: the device's K1-K5 runs differ from "
                                     f"the shards' counters in two traced iterations")
    del traced
    log("sharding: s/iteration (medians): " + "; ".join(
        f"{k}: " + ", ".join(f"{route} {v:.4f}" for route, v in d.items())
        for k, d in secs.items()))
    phase_s = time.perf_counter() - t_phase
    log(f"sharding phase: {phase_s:.1f} s on {card}, {n} shards on {len(cards)} card(s)")
    if phase_s > SHARD_PHASE_S:
        raise AssertionError(f"the sharding phase took {phase_s:.1f} s, over {SHARD_PHASE_S} s")


def bracket_check(trace_file: Path) -> dict:
    """Each host `replay` span of the program in a device_trace with tracing
    on, its graph launch (the cudaGraphLaunch inside it) and that launch's
    device ops (by correlation), against the replay's device span: the
    edges in us (first op's start - span's start, last op's end - span's
    end; the first and last ops are the step's own stamp kernels, so where
    the clocks agree the first edge lies in [-t, 0] and the last in [0, t],
    t a stamp kernel's time), the shift between the two clocks (the edges'
    mean, the median over the replays), and how far the step's other ops
    lie outside its span once the shift is taken out."""
    from pathtracer_tpu_torch.utils.profiling import DEVICE_CATEGORIES, TRACE_PID

    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("pid") == TRACE_PID and e.get("ph") == "X"]
    dev = {e["args"]["parent"]: e for e in ours if e["name"] == "device.replay"}
    replays = [e for e in ours if e["name"] == "replay" and e["args"]["id"] in dev]
    launches = sorted((e for e in events if e.get("name", "").startswith("cudaGraphLaunch")),
                      key=lambda e: e["ts"])
    ops = {}
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES and "correlation" in e.get("args", {}):
            ops.setdefault(e["args"]["correlation"], []).append(e)
    runs = []
    for rep in replays:
        inside = [e for e in launches if rep["ts"] <= e["ts"] <= rep["ts"] + rep["dur"]]
        if len(inside) == 1:
            run = sorted(ops.get(inside[0]["args"].get("correlation"), []), key=lambda e: e["ts"])
            if run:
                span = dev[rep["args"]["id"]]
                runs.append((span["ts"], span["ts"] + span["dur"], run))
    if not runs:
        return {"replays": len(replays), "matched": 0}
    first = [run[0]["ts"] - s0 for s0, _, run in runs]
    last = [run[-1]["ts"] + run[-1]["dur"] - s1 for _, s1, run in runs]
    shift = statistics.median((a + b) / 2 for a, b in zip(first, last))
    outside = 0.0
    for s0, s1, run in runs:
        body = [e for e in run if "stamp_kernel" not in e["name"]]
        if body:
            outside = max(outside, s0 + shift - min(e["ts"] for e in body),
                          max(e["ts"] + e["dur"] for e in body) - s1 - shift)

    def spread(v):
        return [round(min(v), 3), round(statistics.median(v), 3), round(max(v), 3)]

    return {"replays": len(replays), "matched": len(runs), "first_us": spread(first),
            "last_us": spread(last), "shift_us": round(shift, 3),
            "outside_us_max": round(outside, 3)}


def phase_profiling(r, card: str):
    """The program's spans (utils/profiling.py) over renderer r's graph
    route: a traced step bitwise the untraced one from the same state and
    the untraced graphs unchanged; three traced steps' device ms by step
    key and by stage and the idle gaps by host span (Tracer.summary);
    %globaltimer's resolution; a traced step under device_trace whose
    replays' device spans must bracket their graph launches' kernels; the
    trace's top 10 device ops (top_ops_from_trace)."""
    import torch

    from pathtracer_tpu_torch.utils import profiling
    from pathtracer_tpu_torch.utils.profiling import device_trace, top_ops_from_trace, tracing

    t_phase = time.perf_counter()
    r.step(1)
    nodes = dict(r.graphs.nodes)
    img0, it0 = r.img.clone(), r.iteration
    r.step(1)
    untraced = r.img.clone()
    r.img, r.iteration = img0, it0
    t0 = time.perf_counter()
    with tracing() as tr:
        r.step(1)  # captures the traced graphs
    capture_s = time.perf_counter() - t0
    if not torch.equal(r.img, untraced):
        raise AssertionError("profiling: the traced step's image differs from the untraced one's")
    if r.graphs.nodes != nodes:
        raise AssertionError("profiling: the traced capture changed the untraced graphs' nodes")
    extra = {profiling.key_name(k): r.graphs.traced_nodes[k] - n for k, n in nodes.items()}
    if min(extra.values()) < 2:
        raise AssertionError(f"profiling: a traced graph lacks its step's stamps: {extra}")
    log(f"profiling: traced step bitwise the untraced one; traced captures and step "
        f"{capture_s:.2f} s; the traced graphs' nodes besides the untraced ones' (the stamps): "
        f"{json.dumps(extra)}")
    with tracing() as tr:
        r.step(3)
        summ = tr.summary()
    for c, sm in summ["cards"].items():
        log(f"profiling: spans of 3 traced steps of {r_name(r)} on card {c} ({card}), ms a step: "
            f"replays {sm['replay_total_ms']:.3f} (laps {sm['lap_ms']:.3f}), stages "
            f"{json.dumps({k: round(v, 3) for k, v in sm['stage_ms'].items()})}, laps outside "
            f"their stages {sm['lap_unstaged_ms']:.3f}, coverage {sm['coverage']:.5f}, gaps "
            f"{sm['gap_total_ms']:.3f} {json.dumps({k: round(v, 4) for k, v in sm['gap_ms'].items()})}, "
            f"anchor +-{sm['anchor_us']} us; by step key "
            f"{json.dumps({k: round(v, 3) for k, v in sm['replay_ms'].items()})}")
        if not 0.99 <= sm["coverage"] <= 1.0:
            raise AssertionError(f"profiling: the stages and other steps cover {sm['coverage']} "
                                 f"of the replays' device time")
    res = profiling.globaltimer_resolution(r.device)
    trace_dir = ROOT / "pathtracer_tpu_torch" / "_build" / "trace"
    with tracing():
        with device_trace(str(trace_dir)):
            res_traced = profiling.globaltimer_resolution(r.device)
            r.step(1)
            torch.cuda.synchronize()
    br = bracket_check(trace_dir / "trace.json")
    log(f"profiling: %globaltimer {json.dumps(res)}, under the profiler {json.dumps(res_traced)}; "
        f"stamps against the profiler's kernels: {json.dumps(br)}")
    if (not br["matched"] or br["matched"] != br["replays"] or br["outside_us_max"] > 5.0
            or abs(br["shift_us"]) > 100.0):
        raise AssertionError(f"profiling: the replays' device spans do not bracket their kernels: "
                             f"{br}")
    t0 = time.perf_counter()
    top = top_ops_from_trace(str(trace_dir), top=10)
    log(f"profiling: top 10 device ops of one iteration (top_ops_from_trace, "
        f"{time.perf_counter() - t0:.1f} s to read):\n"
        + "\n".join(f"{ms:10.3f} ms  {name[:100]}" for ms, name in top))
    if not top or not any("kernel" in name for _, name in top):
        raise AssertionError("profiling: the trace holds no device kernels")
    log(f"profiling phase: {time.perf_counter() - t_phase:.1f} s")


@contextlib.contextmanager
def no_kernel_table():
    """Both budgets of the port's table build at 0 inside the block, restored
    after: a mesh then fits neither the resident tables nor the streaming
    split, as one of several million triangles does."""
    from pathtracer_tpu_torch.scene import flatscene as tfs

    was = tfs.RESIDENT_SMEM_BUDGET, tfs.STREAM_SMEM_BUDGET
    tfs.RESIDENT_SMEM_BUDGET = tfs.STREAM_SMEM_BUDGET = 0
    try:
        yield
    finally:
        tfs.RESIDENT_SMEM_BUDGET, tfs.STREAM_SMEM_BUDGET = was


def phase_no_table(resident, card: str):
    """The route of a mesh that fits neither kernel table, on glasstorus with
    both budgets at 0: no split, its walk_route the MTBVH walk off the
    kernels and ray_regen ignored; closest_hit's triangle ids on RES x RES
    camera rays against K1's on the normal build (`resident`); a 128x128
    MIS render that launches none of K1-K5, held to the normal build's
    render, with its seconds per iteration."""
    import torch

    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.integrator.wavefront import camera_rays
    from pathtracer_tpu_torch.ops import traverse as tv
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    t_phase = time.perf_counter()
    with no_kernel_table():
        r = Renderer(SCENE, RenderOptions(sample_mode=SampleMode.MIS, ray_regen=REGEN_K),
                     resolution=(128, 128), trace_depth=DEPTH, device=DEVICE)
    static = r.static
    route = tv.walk_route(static, r.opts)
    log(f"no kernel table: {r_name(r)} ({static.num_tris} triangles, {static.num_bvh_trees} "
        f"MTBVH tree(s)): stream blocks {static.stream_subs}, route {route}, graph route "
        f"{r.graph_route}, regen_k {r.regen_k} with ray_regen={REGEN_K}")
    if (static.stream_subs or route != tv.Walk("mtbvh", True) or r.graph_route
            or r.regen_k):
        raise AssertionError("a mesh that fits no kernel table did not take the MTBVH route")
    o, d = camera_rays(resident._cam_arrays(), RES, RES, resident.key, 1,
                       pixel_xy=resident.pixel_xy)
    k0 = dict(_build.launches)
    t0 = time.perf_counter()
    got = tv.closest_hit(r.flat, static, o, d)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launches_since(k0)
    ref = tv.closest_hit(resident.flat, resident.static, o, d)
    compare_walk(f"no kernel table: closest_hit ({secs:.3f} s, launches {launches}) vs K1, "
                 f"{r_name(r)} camera rays", (got.t, got.tri), (ref.t, ref.tri))
    if any(launches[k] for k in WALK_TAGS):
        raise AssertionError(f"closest_hit launched a walk kernel on the MTBVH route: {launches}")
    k0 = dict(_build.launches)
    route_s = timed_step(r, 1)
    launches = launches_since(k0)
    img = r.hdr_sum()
    normal = Renderer(SCENE, RenderOptions(sample_mode=SampleMode.MIS),
                      resolution=(128, 128), trace_depth=DEPTH, device=DEVICE)
    normal_s = timed_step(normal, 1)
    log(f"no kernel table: {r_name(r)} MIS 128x128 depth {DEPTH} {r.iteration} spp: "
        f"{route_s:.4f} s/iteration on the MTBVH route, {normal_s:.4f} on K1/K2, on {card}; "
        f"launches {launches}")
    if any(launches[k] for k in WALK_TAGS) or r.iteration != 2:
        raise AssertionError(f"the render on the MTBVH route launched {launches} in "
                             f"{r.iteration} iterations")
    compare_images("no kernel table: the MTBVH route's render against K1/K2's (128x128, 2 spp)",
                   img, normal.hdr_sum())
    log(f"no-kernel-table phase: {time.perf_counter() - t_phase:.1f} s")


def phase_oracle(card: str):
    """The port's images on the card against the independent numpy oracle
    (tools/oracle.py, on the host's CPU), through tools/oracle_compare_torch.py:
    cornell_spheres MIS at 64 spp and envtorus MIS with env importance on the
    port's side at 32 spp, 32x32, seeds 0 and 1.  Each row's cross RMSE
    after the display transform must stay within the quadrature of the two
    implementations' seed-to-seed floors."""
    from tools.oracle_compare_torch import compare

    t_phase = time.perf_counter()
    for scene_path, spp, env_is in ((SCENE_CORNELL, 64, False), (SCENE_ENVTORUS, 32, True)):
        out = compare(scene_path, "mis", res=32, spp=spp, env_is=env_is, device=DEVICE)
        ratio = out["rmse_ldr"] / out["floor_quad_ldr"]
        log(f"oracle: {json.dumps(out)}")
        log(f"oracle: {scene_path.name} rmse_ldr / floor_quad_ldr {ratio:.4f} (1/sqrt(2) = "
            f"0.7071 for matched physics; must be <= 1) on {card}")
        if out["rmse_ldr"] > out["floor_quad_ldr"]:
            raise AssertionError(f"oracle: {scene_path.name} is off the noise floor: {out}")
    log(f"oracle phase: {time.perf_counter() - t_phase:.1f} s")


def phase_entry(card: str):
    """entry()'s step against a Renderer's first iteration, bitwise, with no
    kernel launched; dryrun_multichip over shard_mesh() (distinct cards, or
    the one card twice) in full mode, which holds each pass bitwise to the
    one-device steps itself; K1 and K2 launched in it, K3-K5 not.  Its only
    triangles are the mesh pass's, so the dry run's counts are that
    pass's."""
    import torch

    from pathtracer_tpu_torch import entry
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    t_phase = time.perf_counter()
    k0 = dict(_build.launches)
    fn, args = entry.entry(device=DEVICE)
    img, rays, depth = fn(*args)
    torch.cuda.synchronize()
    launches = launches_since(k0)
    r = Renderer(entry.SCENE, RenderOptions(sample_mode=SampleMode.MIS), resolution=(64, 64),
                 trace_depth=4, device=DEVICE)
    r.step(1)
    same = torch.equal(img, r.img)
    log(f"entry: step on {img.device}: img {tuple(img.shape)}, rays {int(rays)}, depth {depth}, "
        f"bitwise the Renderer's first iteration: {same}; launches {launches}")
    if (tuple(img.shape) != (64 * 64, 3) or int(rays) <= 0 or depth < 1 or not same
            or any(launches[k] for k in ("K1", "K2", "K3", "K4", "K5"))):
        raise AssertionError("entry()'s step is not the Renderer's first iteration")
    mesh = shard_mesh()
    k0 = dict(_build.launches)
    entry.dryrun_multichip(len(mesh), devices=mesh)
    sync_all(mesh)
    launches = launches_since(k0)
    log(f"entry: dryrun_multichip({len(mesh)}) over {mesh}: launches {launches}")
    if not (launches["K1"] and launches["K2"]) or any(launches[k] for k in ("K3", "K4", "K5")):
        raise AssertionError(f"the dry run launched {launches}; needs K1 and K2, none of K3-K5")
    phase_s = time.perf_counter() - t_phase
    log(f"entry phase: {phase_s:.1f} s on {card}")
    if phase_s > ENTRY_PHASE_S:
        raise AssertionError(f"the entry phase took {phase_s:.1f} s, over {ENTRY_PHASE_S} s")


@contextlib.contextmanager
def graphs_only():
    """Inside the block the Renderer's graph route may not run the eager
    loop: a call to render_iteration from it raises."""
    from pathtracer_tpu_torch.integrator import render

    was = render.render_iteration

    def refuse(*args, **kwargs):
        raise AssertionError("the graph route ran the eager loop")

    render.render_iteration = refuse
    try:
        yield
    finally:
        render.render_iteration = was


def graph_vs_eager(name: str, r, used: tuple, steps: tuple, card: str,
                   profile: tuple = (), then=None) -> dict:
    """Renderer `r` (MIS, depth DEPTH) on its eager loop, then, from a fresh
    accumulation, on its graph route: a warm-up iteration, then r.step(n)
    for each n of `steps`.  The graph route's HDR sum, booked rays, laps and
    pool lengths must equal the eager loop's, its K1-K5 launches too, those
    in `used` launched; prints both paths' seconds per iteration, the
    graphs, their replays, the memory reserved and the case's seconds.  One
    more iteration of each route in `profile` runs under the profiler: its
    K1-K5 runs on the device must equal the launch counters over it (on the
    graph route they add what each capture counted) and the eager loop's
    launches an iteration.  `then(r)`, run on each route after the timed
    steps, returns images that must be bitwise equal between the routes."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.integrator.render import RenderStats
    from tools.profile_torch_port import eager_route, profile_step

    t_case = time.perf_counter()
    res = r.width
    r.graphs = None  # the graphs of an earlier case on this renderer go first
    if not r.graph_route:
        raise AssertionError(f"graphs: {name} does not take the graph route")
    samples = sum(steps)
    out, profs = {}, {}
    for path in ("eager", "graphs"):
        r.reset()
        r.stats = RenderStats()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved()
        with eager_route() if path == "eager" else graphs_only():
            r.step(1)
            torch.cuda.empty_cache()  # what stays reserved is the graphs' pool and buffers
            mem = torch.cuda.memory_reserved() - mem0
            replays0 = r.graphs.replays if path == "graphs" else 0
            k0 = dict(_build.launches)
            for n in steps:
                r.step(n)
            launches = {k: v / samples for k, v in launches_since(k0).items() if k[0] == "K"}
            out[path] = dict(img=r.hdr_sum(), rays=r.stats.rays_traced, pools=list(r.lap_pools),
                             depth=r.traced_depth, secs=list(r.stats.per_iter_seconds),
                             launches=launches, mem=mem)
            if path == "graphs":
                if r.graphs is None or not r.graphs.num_graphs:
                    raise AssertionError(f"graphs: {name} captured no graph")
                out[path]["replays"] = (r.graphs.replays - replays0) / (len(steps) if r.regen_k
                                                                        else samples)
                out[path]["captured"] = (r.graphs.num_graphs, r.graphs.capture_seconds)
            if then is not None:
                out[path]["then"] = then(r)
            if path in profile:
                k0 = dict(_build.launches)
                profs[path] = profile_step(r, 1)
                profs[path]["counted"] = {k: v for k, v in launches_since(k0).items()
                                          if k[0] == "K"}
    e, g = out["eager"], out["graphs"]
    same = np.array_equal(g["img"], e["img"])
    per = "batch" if r.regen_k else "iteration"
    log(f"graphs: {name} MIS {res}x{res} depth {DEPTH}, {samples} timed samples on {card}: HDR "
        f"sum bitwise the eager loop's: {same}; rays {g['rays']} against {e['rays']}; laps "
        f"{g['depth']} against {e['depth']}, pools equal: {g['pools'] == e['pools']}; K1-K5 "
        f"launches per sample {g['launches']} against {e['launches']}; {g['captured'][0]} "
        f"graphs captured in {g['captured'][1]:.3f} s, {g['replays']:.1f} replays per "
        f"{per}, memory held after the warm-up (empty_cache) {g['mem'] / 2**20:.1f} MiB (eager "
        f"{e['mem'] / 2**20:.1f}), {torch.cuda.max_memory_reserved() / 2**20:.1f} MiB reserved at "
        f"most; s/{'sample' if r.regen_k else 'iteration'} graphs "
        f"{statistics.median(g['secs']):.4f} (median of "
        f"{len(g['secs'])}: {', '.join(f'{x:.4f}' for x in g['secs'])}), eager "
        f"{statistics.median(e['secs']):.4f} ({', '.join(f'{x:.4f}' for x in e['secs'])}); "
        f"{time.perf_counter() - t_case:.1f} s for the case")
    for path, prof in profs.items():
        log(f"graphs: {name} {res}x{res}, one iteration on the {path} route under the profiler: "
            f"{prof['host_launches']} host-issued launches ({prof['graph_launches']} graph "
            f"launches), {prof['launches']} device ops, device busy {prof['busy_us'] / 1e3:.3f} "
            f"ms, wall {prof['wall'] * 1e3:.3f} ms, busy share "
            f"{prof['busy_us'] / 1e6 / prof['wall']:.4f}; K1-K5 runs on the device "
            f"{prof['traversal']}, counted {prof['counted']}; host CUDA calls: "
            + ", ".join(f"{k} {v}" for k, v in sorted(prof["host_calls"].items(),
                                                      key=lambda kv: -kv[1])[:8]))
    for path, prof in profs.items():  # the counters against what the device ran
        if not (prof["traversal"] == prof["counted"] == e["launches"]
                and all(prof["traversal"][k] > 0 for k in used)):
            raise AssertionError(f"graphs: {name}: on the {path} route the device ran K1-K5 "
                                 f"{prof['traversal']} times, counted {prof['counted']}, the "
                                 f"eager loop an iteration {e['launches']}; must be equal, those "
                                 f"of {used} above 0")
    if not (same and g["rays"] == e["rays"] and g["pools"] == e["pools"]
            and g["depth"] == e["depth"] and g["launches"] == e["launches"]):
        raise AssertionError(f"graphs: {name}'s graph route differs from its eager loop")
    if not all(g["launches"][k] > 0 for k in used) or any(
            v for k, v in g["launches"].items() if k not in used):
        raise AssertionError(f"graphs: {name} launched {g['launches']}; needs only {used}")
    if not (np.isfinite(g["img"]).all() and g["img"].mean() > 0):
        raise AssertionError(f"graphs: {name}: the image is not finite and positive")
    if then is not None and not all(np.array_equal(a, b) for a, b in zip(g["then"], e["then"])):
        raise AssertionError(f"graphs: {name}: the routes differ after {then.__doc__}")
    return {"graphs": statistics.median(g["secs"]), "eager": statistics.median(e["secs"])}


def phase_graphs(card: str):
    """Phase 21: the graph route against the eager loop on GRAPH_CASES, at
    128x128 on glasstorus, and across a set_seed and a set_orbit."""
    from pathtracer_tpu_torch.integrator.render import Renderer
    from pathtracer_tpu_torch.utils.config import RenderOptions, SampleMode

    t_phase = time.perf_counter()
    built = {}

    def renderer(scene_path, options: dict, res: int):
        """A Renderer of the scene at res x res, built once for the cases
        that follow one another; the options swapped in, as phase_schedules
        swaps them (the tables do not depend on the options the cases
        set)."""
        if (scene_path, res) not in built:
            built.clear()  # the last scene's renderer and its graphs go first
            built[scene_path, res] = Renderer(
                scene_path, RenderOptions(sample_mode=SampleMode.MIS, **options),
                resolution=(res, res), trace_depth=DEPTH, device=DEVICE)
        r = built[scene_path, res]
        r.opts = RenderOptions(sample_mode=SampleMode.MIS, **options)
        return r

    secs = {}
    for name, scene_path, options, used, steps in GRAPH_CASES:
        secs[name] = graph_vs_eager(name, renderer(scene_path, options, RES), used, steps, card,
                                    profile=GRAPH_PROFILED.get(name, ()))
    recaptured = []

    def seed_then_orbit(r):
        """a set_seed(7) and then a set_orbit(0.3, -0.2), one step after each"""
        before, seed, cam = r.graphs, r.seed, r.camera
        r.set_seed(7)
        r.step(1)
        recaptured.append(r.graphs is not before)
        seeded = r.hdr_sum()
        r.set_orbit(0.3, -0.2)
        r.step(1)
        images = seeded, r.hdr_sum()
        r.set_seed(seed)  # the next route starts where this one did
        r.camera = cam
        return images

    secs["glasstorus 128x128"] = graph_vs_eager("glasstorus", renderer(SCENE, {}, 128),
                                                ("K1", "K2"), (1,) * 5, card, then=seed_then_orbit)
    log("graphs: s/iteration (medians), graphs / eager: " + "; ".join(
        f"{k} {v['graphs']:.4f} / {v['eager']:.4f} ({v['eager'] / v['graphs']:.2f}x)"
        for k, v in secs.items()))
    log(f"graphs: glasstorus 128x128 after its timed steps, {seed_then_orbit.__doc__}: images "
        f"bitwise the eager loop's; graphs recaptured for the seed: {recaptured[1]}")
    if recaptured != [False, True]:
        raise AssertionError(f"graphs: recaptured for the seed on the (eager, graph) routes: "
                             f"{recaptured}")
    built.clear()
    phase_s = time.perf_counter() - t_phase
    log(f"graphs phase: {phase_s:.1f} s on {card}")
    if phase_s > GRAPH_PHASE_S:
        raise AssertionError(f"the graphs phase took {phase_s:.1f} s, over {GRAPH_PHASE_S} s")


def phase_probes():
    """P1 and P2 against their plain versions, bit for bit (every P2 variant
    from the probe's start, and from a small one past the wrap of its node
    index); their times at the TPU probes' sizes beside their bound on one SM
    (probe_bound) at the SM clock sampled while they ran, each held to time
    >= bound / PROBE_SLACK; the kernels line's rows (P2's at P2_ROW_F pops of
    P2_ROW)."""
    import torch

    from pathtracer_tpu_torch.ops import probes
    from tools.cuda_timing import describe_clock, sm_clock

    def same(kname, label, got, want):
        torch.cuda.synchronize()
        err = _max_err(got, want)
        equal = torch.equal(got, want)
        log(f"{kname} {label}: bitwise equal: {equal}, max abs err {err:.3g}")
        if not equal:
            raise AssertionError(f"{kname} {label} differs from its plain version")
        return err

    def held(label, ms, laps, b):
        per_lap = ms / laps * 1e6
        terms = ", ".join(f"{k} {v:.2f}" for k, v in b["clocks"].items())
        log(f"{label}: {ms:.4f} ms, {per_lap:.3f} ns, {per_lap * mhz / 1e3:.1f} cycles a lap; "
            f"bound on one SM {b['clocks_per_lap']:.2f} cycles a lap ({b['by']}; {terms}), "
            f"{b['ms']:.6f} ms for {laps} laps; bound / time {b['ms'] / ms:.3f}")
        if ms < b["ms"] / PROBE_SLACK:
            raise AssertionError(f"{label} ran in {ms:.6f} ms, under its bound {b['ms']:.6f} ms "
                                 f"/ {PROBE_SLACK}: the bound is wrong")

    def timed_plain(fn):
        """One call of a plain version (seconds of host work): its result
        and its time."""
        out = []
        ms = median_ms(lambda: out.append(fn()), runs=1, warmup=False)
        return out[0], ms

    t_phase = time.perf_counter()
    tab, rays = probes.rowprim_inputs(DEVICE)
    p1_want, p1_plain_ms = timed_plain(lambda: probes.rowprim_plain(tab, rays))
    p1_err = same("P1", f"{probes.ROWPRIM_LAPS} laps", probes.rowprim(tab, rays), p1_want)
    for laps in (1, 3, 5):  # fewer laps than the ring's stages, and not a multiple of them
        same("P1", f"{laps} laps", probes.rowprim(tab, rays, laps), probes.rowprim_plain(tab, rays, laps))
    args = probes.pop_inputs(DEVICE)
    p2_want, p2_plain_ms = timed_plain(lambda: probes.pop_plain(P2_ROW, *args, F=P2_ROW_F))
    p2_err = same("P2", f"{P2_ROW} F={P2_ROW_F}", probes.pop(P2_ROW, *args, F=P2_ROW_F), p2_want)
    for v in probes.P2_VARIANTS:
        small = 50.0 if v == "leaf_mt" else 0.0
        for acc0, F in ((probes.POP_ACC0, P2_CHECK_F), (small, P2_WRAP_F)):
            kw = dict(F=F, acc0=acc0)
            p2_err = max(p2_err, same("P2", f"{v} F={F} start {acc0:g}",
                                      probes.pop(v, *args, **kw), probes.pop_plain(v, *args, **kw)))
    with sm_clock() as samples:
        p1_ms = median_ms(lambda: probes.rowprim(tab, rays))
        p2_ms = {v: median_ms(lambda v=v: probes.pop(v, *args)) for v in probes.P2_VARIANTS}
        p2_row_ms = median_ms(lambda: probes.pop(P2_ROW, *args, F=P2_ROW_F))
    if not samples:
        raise AssertionError("the SM clock was not sampled while the probes ran")
    mhz = statistics.median(samples)
    log(f"probes: {describe_clock(samples)}")
    b1 = probe_bound("P1", probes.ROWPRIM_LAPS, mhz)
    held(f"P1 {probes.ROWPRIM_LAPS} laps", p1_ms, probes.ROWPRIM_LAPS, b1)
    for v, ms in p2_ms.items():
        held(f"P2 {v} {probes.POP_F} pops", ms, probes.POP_F, probe_bound(v, probes.POP_F, mhz))
    b2 = probe_bound(P2_ROW, P2_ROW_F, mhz)
    held(f"P2 {P2_ROW} {P2_ROW_F} pops", p2_row_ms, P2_ROW_F, b2)
    log(f"plain versions (one run each): P1 {p1_plain_ms:.4f} ms, P2 {P2_ROW} at {P2_ROW_F} pops "
        f"{p2_plain_ms:.4f} ms")
    log(f"probes phase: {time.perf_counter() - t_phase:.1f} s")
    return {
        "P1": ("rowprim", SRC_PROBES, "tools/rowprim_probe.py:55", p1_err, p1_ms, p1_plain_ms,
               (b1["ms"], f"{b1['by']}, one SM")),
        "P2": ("pop", SRC_PROBES, "tools/kernel_microbench.py:228", p2_err, p2_row_ms, p2_plain_ms,
               (b2["ms"], f"{b2['by']}, one SM")),
    }


def main() -> int:
    t_start = time.perf_counter()
    name, smi = phase_device()
    import torch

    from tools.make_texture_assets import ensure_texture_assets
    from tools.make_torus_obj import ensure_torus_obj

    phase_build()
    for obj in (TORUS_160K, TORUS_640K):
        t0 = time.perf_counter()
        ensure_torus_obj(*obj)
        log(f"{obj[0].relative_to(ROOT)}: ready in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    assets = ensure_texture_assets()
    log(f"texture assets ({', '.join(p.name for p in assets)}): ready in "
        f"{time.perf_counter() - t0:.2f} s")
    cornell = build_renderer(SCENE_CORNELL)
    kernels = phase_sweep_kernels(cornell[0], "cornell_spheres")
    kernels.update(phase_shade_kernels(cornell[0], "cornell_spheres"))
    kernels.update(phase_light_kernels(cornell[0], "cornell_spheres"))
    phase_main_path(cornell, used=("S1", "S2", "M1", "M2", "L1", "L2"),
                    unused=("K1", "K2", "K3", "K4", "K5"), card=smi)
    if cornell[0].static.num_tris or len(cornell[0].static.material_types) != 5:
        raise AssertionError("cornell_spheres must be triangle-free with all five materials")
    phase_schedules(cornell, card=smi, used=(), unused=("K1", "K2", "K3", "K4", "K5"))
    del cornell
    resident = build_renderer(SCENE)
    phase_sweep_kernels(resident[0], "glasstorus")
    phase_shade_kernels(resident[0], "glasstorus")
    phase_light_kernels(resident[0], "glasstorus")
    kernels.update(phase_resident_kernels(resident[0]))
    stream = build_renderer(SCENE_160K)
    kernels.update(phase_stream_kernels(stream[0]))
    big = build_renderer(SCENE_640K)
    phase_640k_kernels(big[0])
    phase_scheduled_kernels(resident[0], ("K1", "K2"), *resident_calls(resident[0]))
    k = stream_calls(stream[0].flat, stream[0].static)
    phase_scheduled_kernels(stream[0], ("K3", "K4"), k["K3"], k["K3_plain"], k["K4"], k["K4_plain"])
    del k
    launches, _ = phase_main_path(resident,
                                  used=("K1", "K2", "S1", "S2", "M1", "M2", "L1", "L2"),
                                  unused=("K3", "K4", "K5"), card=smi)
    stream_launches, _ = phase_main_path(stream, used=("K3", "K4"), unused=("K1", "K2", "K5"),
                                         card=smi)
    launches.update(K3=stream_launches["K3"], K4=stream_launches["K4"])
    phase_schedules(resident, card=smi, used=("K1", "K2"), unused=("K3", "K4", "K5"))
    phase_schedules(stream, card=smi, used=("K3", "K4"), unused=("K1", "K2", "K5"))
    _, img_k3 = phase_main_path(big, used=("K3", "K4"), unused=("K1", "K2", "K5"), card=smi)
    with blockmajor(True):
        bm_launches, img_k5 = phase_main_path(big, used=("K5", "K4"), unused=("K1", "K2", "K3"),
                                              card=smi, label="_blockmajor")
    launches.update(K5=bm_launches["K5"], P1=bm_launches["P1"], P2=bm_launches["P2"])
    compare_images(f"glasstorus640k STREAM_BLOCKMAJOR on (K5) vs off (K3), MIS {RES}x{RES} "
                   f"depth {DEPTH} {SPP} spp", img_k5, img_k3)
    check_mtbvh(big[0], "K3")  # one tree: the mesh is past the MTBVH budget
    del big, img_k3, img_k5
    phase_rgbe_scale()
    for scene_path, options in ((SCENE_TEXCUBE, {}), (SCENE_ENVTORUS, {"env_importance": True})):
        textured = build_renderer(scene_path, **options)
        label = "".join(f"_{k}" for k in options)
        phase_main_path(textured, used=("K1", "K2"), unused=("K3", "K4", "K5"), card=smi,
                        label=label)
        phase_schedules(textured, card=smi, used=("K1", "K2"), unused=("K3", "K4", "K5"),
                        label=label)
        del textured
    phase_card_vs_cpu(SCENE_CORNELL)
    phase_card_vs_cpu(SCENE)
    phase_card_vs_cpu(SCENE_160K)
    phase_card_vs_cpu(SCENE_160K, k5=True)
    for scene_path in (SCENE_TEXCUBE, SCENE_NORMALCUBE, SCENE_ENVTORUS):
        phase_card_vs_cpu(scene_path)
    phase_card_vs_cpu(SCENE_ENVTORUS, env_importance=True)
    t_new = time.perf_counter()
    phase_checkpoint(SCENE, card=smi)
    phase_preview(SCENE, card=smi)
    phase_bench(SCENE, card=smi)
    phase_walks(resident[0], stream[0], card=smi)
    phase_sharding(card=smi)
    phase_profiling(resident[0], card=smi)
    log(f"phases 12-17 (checkpoint, preview, bench, walks, sharding, profiling): "
        f"{time.perf_counter() - t_new:.1f} s")
    phase_no_table(resident[0], card=smi)
    phase_oracle(card=smi)
    phase_entry(card=smi)
    phase_graphs(card=smi)
    kernels.update(phase_probes())
    rows = [
        {"name": name_, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[key], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        for key, (name_, source, replaces, err, ms, plain_ms, (bound_ms, bound_by))
        in kernels.items()
    ]
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
