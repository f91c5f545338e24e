#!/usr/bin/env python3
"""Smoke run of the torch port (``pstl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line of numbers; the first failure exits non-zero
and no result line is printed:

1. device: needs CUDA (there is no CPU path); TF32 off; the card's name and
   power limit from nvidia-smi.
2. build: compiles the five kernel libraries from ``pstl_tpu_torch/csrc``
   (one nvcc per source, all at once) and prints, per kernel, ptxas's
   registers, spills and stack frame, and each library's launch geometry
   (the macros of its source).
3. kernel: the fused guidance kernel against its plain PyTorch version on
   identical inputs at the closed-loop shapes (16 scenes, T=20, R=192, K=8,
   S=15, nL=4, 3 Adam iterations), for coarse pair on/off, bf16 cumsum
   on/off and the offset quirk on/off; maximum error and times: the
   kernel's own as a CUDA graph replays it (``time_kernel``), one eager call
   of its wrapper and the plain version (medians over CUDA events).
4. superstep kernel: the whole-denoise-step kernel against its plain
   version on identical inputs at the main shapes (16 scenes, R=192, hidden
   256, bf16, e7_round5 weights), guided and unguided, for the same flag
   combinations at t=60 and t=5; maximum error and times; for context, the
   unguided kernel beside the eager ``make_cm_eps_fn`` forward (library
   gemms) at the same shapes.
5. reference: one small reverse pass on the card against the same pass on
   the CPU (the plain versions, which the CPU tests hold to the JAX
   package) with pinned noise, on the default path and under superstep.
6. closed loop: the heavy ``bench.py`` contract with the e7_round5 weights,
   16 synthetic scenes: ``guidance_adam_cm`` on the card against the plain
   version, then 64 replanning steps; every step must launch the guidance
   kernel once per denoise step (99 x 64 in all) and every metric must be
   finite.
7. fold2: the same under ``guidance_pallas_fold2`` (BENCH_GPALLAS=3), 8
   closed-loop steps, which must launch the guidance kernel 99 x 8 times.
8. superstep closed loop: the heavy contract under
   ``guidance_pallas_superstep`` (BENCH_GPALLAS=4), 16 scenes x 64 steps:
   99 x 64 superstep launches, all guided, none of the guidance kernel.
9. superstep, mixed schedule: the ``parity`` contract (guidance on the last
   10 denoise steps, one Adam iteration) under superstep, 8 steps: 99 x 8
   superstep launches, of which 10 x 8 guided.
10. frozen kernel: the frozen-payload guidance kernel against its plain
   version at the main shapes, on the same ``freeze_cm`` payloads (frozen
   once on the card), for coarse pair on/off, bf16 cumsum on/off, the
   quirk on/off at t=60 and t=5, and bf16 geometry payloads.
11. frozen reference: the reverse pass card vs CPU on the frozen-payload
   route (``BENCH_GPALLAS=1``), without and with the selection carry
   (``guidance_sel_every=2``).
12. frozen-payload and folded closed loops: ``"1"`` 64 steps (99 x 64
   frozen-kernel launches), ``"1f"`` and ``"2f"`` (each route's call on the
   card against the plain version first) and ``"1"`` with
   ``guidance_sel_every=2``, 8 steps each, and ``"0"`` (the XLA guidance
   loop), 8 steps with no kernel launch.
13. clearance kernels: the forward and backward min-clearance kernels
   against their plain versions at n = 8192 rows, K = 8, T = 20, nL = 4, in
   both layouts: on the ``e2_vae_mono`` step's own inputs (128 scenes'
   neighbors, 64 rows a scene) and on random ones with a neighbor set per
   row (about 30 % invalid neighbors, clearances on both sides of the clip
   bound), with a N(0, 1) cotangent; errors, the share beyond tolerance and
   median times.  Their bound counts the function's own operands (the ego
   states, the per-scene neighbors, the cotangent and the outputs, each
   once) and ``clearance_ops``; the bytes' and the operations' times are
   both printed.  The 67 TFLOP/s peak counts fused multiply-adds, which
   these kernels, rounding product by product, cannot use.
14. card vs CPU for one mono train step: ``e2_vae_mono`` in fp32 with
   stl_weight 1 (the backward kernel carries a nonzero cotangent), 16
   scenes x 64, the same draws: loss, metrics, every gradient and the
   backward kernel's own output; then the gradients' error with that
   output zeroed, printed.
15. mono training at full width: one epoch of ``train.train`` on
   ``e2_vae_mono`` (1,500 synthetic scenes: 8 train and 3 val batches of
   128 scenes x 64), which must launch the forward kernel once per batch
   and the backward once per train batch; 8 train steps with stl_weight 1;
   4 train steps of ``e4_ddpm_mono`` (the 99-step sampler), forward only.
   Every loss and metric must be finite.
16. card vs CPU for one dense train step: ``e5_ddpm`` (random weights) and
   ``e7_ours`` with stl_weight 1 (warm-started from the committed
   e5b_round5 base, a fresh RefineNet head), fp32, 8 scenes x 64 x 3 rows,
   full layer widths, the same seeded draws; every metric and gradient.
   The dense step reaches no kernel, and none may launch.
17. dense training at full width (128 scenes x 64 x 3 = 24,576 rows, phase
   15's scenes with the GT controls in seed 0): 4 ``e5_ddpm`` train steps
   from a seed, then ``e7_ours`` warm-started from e5b_round5, 4 train
   steps and an eval step.  Finite metrics; e7 moves the RefineNet head
   only, every other parameter bit for bit as loaded; median step times
   beside the card's name and power limit.
18. a checkpoint on the card: two e7 steps, ``train.save_checkpoint``, a
   fresh net and Adam loaded by ``train.load_checkpoint`` (parameters,
   moments and step count bit for bit), one more step from each.
19. card vs CPU for trajopt: one ``trajopt_loss`` gradient and 20 Adam
   steps of ``trajopt.optimize`` (``e1_trajopt``, 8 scenes x 64 x 3 rows,
   K = 4, fp32, the GT controls in seed 0), the same draws; no kernel.
20. the augmentation at full width: ``trajopt.augment_dataset`` over phase
   15's 1,500 scenes (batches of 1,024 scenes x 64 x 3 = 196,608 rows, the
   second padded), 200 of the preset's 2,000 iterations: median iteration,
   launches and device time of an iteration, peak memory, the oracle's
   satisfaction against the random seeds'; the store saved and loaded, and
   4 ``e5_ddpm`` steps on it (the share of rows ``stl_bc_mask`` keeps).
21. card vs CPU for the open-loop evaluation: the oracle row, the timed
   region and the metric tail on 8 val scenes of that store, fp32, guided
   (``ours_guidance`` + ``guidance_pallas_fuse_freeze``), pinned noise.
22. Table I at full width: ``eval_openloop.run`` on the store's val split
   with the e7_round5 weights, guided (kernel 1 once per guided denoise
   step of every batch and of the warm-up) and unguided (e7, no kernel);
   kernel 1 against its plain version on the first guided step's inputs
   (bs 128, one Adam iteration, the hinge threshold ``stl_nn_thres``).

23. card vs CPU for the Table-II step: 5 held-out scenes (2 with
   ``closed_loop_eval.py``'s unsafe fixture) x 16 seeds, fp32, route "2"
   with the backup controller (its solve cut to 50 Adam steps) and the
   convex refinement, 3 pinned-noise steps, each started on both devices
   from the CPU's carry (gates: ``table2_reference_phase``); then the
   full-length backup solve and refinement on the first step's inputs,
   their differences printed.
24. Table II at full width (``closed_loop_eval.py``'s protocol: seed 777,
   the first 25 scenes that pass the pre-check, scene_len 38,
   ``run_closed_loop_host(record=True)``, e7_round5 weights, the heavy
   contract's width and route "2"): the guided row and the
   ``ref_parity(open_loop=False)`` row (36 steps), the backup row on the
   unsafe fixture, the refinement + lite_refine and raw_refinement rows (8
   steps), the ``--test_aggressive`` presets on the first scene (36 steps);
   kernel 1 against its plain version on the ref_parity row's first guided
   step (bs 25, one Adam iteration, lr 0.04, the offset quirk on).

25. card vs CPU for one dense baseline train step: ``e3_vae`` (the init
   hint), ``e6_trafficsim`` (stl_weight 1, collision loss 1) and BC
   (``e3_vae`` with ``vae=False, bc=True, use_init_hint=False``: the JAX
   package has no BC preset), fp32, 8 scenes x 64 x 3 rows, full widths,
   the same seeded draws: phase 16's tolerances, no kernel launch.
26. the baselines' training at full width on phase 20's store (128 scenes
   x 64 x 3 = 24,576 rows, bf16): 4 train steps and an eval step each of
   e3, e6 and BC, the median step and peak device memory (e6's collision
   loss materializes the geometry route's pair tensors), and an e6
   checkpoint saved and loaded bit for bit as in phase 18.
27. Table I's baseline rows with phase 22's protocol: vae_mono (phase 15's
   e2 net with ``gt_data_training`` off), vae_aug, trafficsim and BC
   (phase 26's nets: 4 steps of training make a wiring check, not a Table
   result) and ctg (e5b_round5, guided on all 99 denoise steps with 3 Adam
   iterations under ``guidance_pallas_fuse_freeze``: kernel 1 once per
   denoise step of every batch and of the warm-up), kernel 1 against its
   plain version on the ctg row's first guided step.
28. Table II's baseline rows with phase 24's protocol: vae_aug and
   trafficsim (phase 26's nets) and ctg (kernel 1 99 x 36 times), 36
   steps each: the six columns, the median step, launches a step, and the
   indices of the scenes that collide.

29. card vs CPU for the rest of the sampler: small reverse passes with
   pinned draws through ``diffusion.sample`` (DDIM at eta 0 and 0.5,
   DPM++, the m-major guided DDPM chain on route "2"; route "0" with bf16
   robustness), and one fp32 ``ours_guidance`` train step (the guided
   training sampler) at phase 16's tolerances.
30. the heavy contract at full width under the new samplers: DDIM with 20
   steps on "2" (64 steps: kernel 1 20 x 64 times), DPM++ (19 x 8), DDIM
   on "1" (kernel 2 20 x 8), the m-major DDPM chain (kernel 1 99 x 8), the
   parity schedule under DDIM with ``fast_guided_focus=0.5`` (20 x 8) and
   "0" with bf16 robustness (no launch), 8 steps each but the first; kernel
   1 against its plain version on the DDIM row's first guided step.
31. ``ours_guidance`` warm-started from e5b_round5 at full width (24,576
   rows, bf16): 4 train steps and an eval step, only the RefineNet head
   moving.
32. the shard store: phase 20's store written as a native shard store, its
   shuffled train batches against ``batch_iterator``'s bit for bit, and 4
   ``e5_ddpm`` steps through ``train.train(use_shard_store=True,
   time_profile=True)`` with the timer's sections.
33. the command line on the card (``pstl_tpu_torch.cli.main`` in this
   process, the card by default): ``data`` (256 synthetic scenes),
   ``check``, ``trajopt`` (20 iterations), ``train --preset e2_vae_mono``
   (kernels 6 / 7), ``eval`` of the guided Table-I row and ``sim`` of 16
   scenes x 4 steps under bench.py's heavy contract given as ``--set``
   (kernel 1 on every guided denoise step), with the e7_round5 weights;
   every tensor on the card, the printed JSON finite, each command's
   launches what its path needs; ``train -e`` draws its viz where
   matplotlib is installed.
34. the parallel layer (``pstl_tpu_torch.parallel``): ``cli train --mesh
   --preset e2_vae_mono`` at world 1 (NCCL) against the same command
   without ``--mesh`` (kernels 6 / 7); then two gloo ranks of this script
   on the one card (``--parallel-rank``): phase 16's fp32 e7_ours step
   under a data mesh against the one-process step, one scene of the heavy
   contract candidate-sharded (96 of 192 columns a rank; kernel 1 once a
   denoise step on each rank, held to its plain version on the rank's
   columns; the plan against the unsharded plan) and 4 scene-sharded
   closed-loop steps of 16 scenes; the wall a step, sharded and not.
35. the NuScenes extraction on this jax-free host: ``extract_dataset``
   through the fake devkit of ``tests/torch_devkit_shim.py`` against the
   committed golden capsule, and ``cli data --real`` writing a cache that
   ``SceneDataset`` loads.
36. the formula tree, the constant-velocity neighbors and training through
   the sampler: (a) ``specs.build_formulas`` against the ``ClauseBank`` on
   phase 20's layout (1,024 scenes x 64 x 3 = 196,608 rows), scores soft and
   hard and the trajopt hinge's gradient, then 20 ``trajopt.optimize``
   iterations with each (ms an iteration, device launches, peak memory);
   (b) phase 14's card-vs-CPU step under ``gt_nei=False`` on scenes whose
   neighbor leaves the ego's track while its constant-velocity prediction
   stays on it, then ``cli train --preset e2_vae_mono --set gt_nei=false``
   for 8 steps on phase 33's store, kernels 6 / 7 once a step, each held
   against its plain version on the first step's inputs and timed there;
   (c) phase 16's card-vs-CPU step on ``e5_ddpm`` with ``grad_rollout`` and
   stl_weight 1, then ``cli train --preset e5_ddpm --set grad_rollout=true
   stl_weight=1.0`` for 4 steps of 24,576 rows (median step, device
   launches, peak memory).
37. ConditionalUnet1D's activation pass (``ops/unet1d_norm``, the fifth
   library): the 25 calls of one full-width forward at the planner's 3,072
   rows (seeded weights, bf16), recorded as the forward makes them, each
   held against its plain version and timed beside it and beside
   PyTorch's ``F.group_norm`` + ``F.mish`` on the same values (timed only),
   summed over the pass; then a profiled forward, which must show no cuDNN
   layout transpose and no PyTorch GroupNorm kernel.  ``python3
   chip_smoke.py --phase 37`` runs the build and this phase alone.

The line before the last is the card's ``name, power.limit``; before it a
JSON line with each kernel's (kernel 1 on the closed loop's path, the
ninth entry on the evaluation's, the tenth on the ref_parity Table-II
row's, the eleventh on the ctg Table-I row's, the twelfth on the DDIM
closed loop's, the thirteenth on the candidate-sharded plan's, per
rank, and the fourteenth and fifteenth kernels 6 / 7 on the
constant-velocity neighbors of phase 36, and the sixteenth the U-Net's
activation pass of phase 37, summed over a forward's 25 launches, with
``library_ms`` PyTorch's GroupNorm + Mish on the same values) launches,
error, times
(``ms`` one eager call of its wrapper, ``graph_ms`` the kernel alone in a
graph replay, see ``kernel_ms``; ``plain_ms`` the plain version) and its
bound: the larger of its bytes (each input read once, each output written
once) over the card's 3.35 TB/s and its arithmetic over the peak of its
operands' type, 989 TFLOP/s for bf16 and 67 TFLOP/s for float32 (counted
from the shapes; see ``*_ops``); the last line is
``{"ok": true, "device": {...}}``.
"""

import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 64
FOLD2_STEPS = 8
MIXED_STEPS = 8
ROUTE_STEPS = 8
SCENES = 16
LIBS = ("guidance_fused", "guidance_frozen", "superstep", "min_clearance",
        "unet1d_norm")
#: e2_vae_mono's ego box
EGO_L, EGO_W = 4.084, 1.730
#: scenes of the full-width mono phases, and their training set
TRAIN_SCENES = 1500
E2_EXTRA_STEPS = 8
E4_STEPS = 4
#: scenes of the dense card-vs-CPU step, and the dense presets' train steps
DENSE_REF_SCENES = 8
E5_STEPS = 4
E7_STEPS = 4
#: the trajopt card-vs-CPU phase's scenes and iterations, and the e1
#: phase's iterations (the preset runs traj_opt_iters = 2000)
TRAJOPT_REF_SCENES = 8
TRAJOPT_REF_ITERS = 20
E1_ITERS = 200
#: scenes of the evaluation's card-vs-CPU phase
EVAL_REF_SCENES = 8
#: the closed-loop Table-II protocol of scripts/closed_loop_eval.py: the
#: held-out synthetic seed, the scenes kept after the pre-check, the steps
#: of its rows and of the short rows (backup, refinement)
TABLE2_SEED = 777
TABLE2_SCENES = 25
TABLE2_STEPS = 36
TABLE2_SHORT_STEPS = 8
#: the Table-II card-vs-CPU phase: scenes (an odd batch for kernel 1's G = 2
#: packing), the unsafe ones among them, seeds a scene, steps, and the Adam
#: steps its closed loop cuts the backup solve to (at the full 500 the
#: solve circles its optimum within ~lr = 1e-2, which an Euler step of
#: 0.5 s carries to 5e-3 in the ego state, beyond TABLE2_REF_TOL)
TABLE2_REF_SCENES = 5
TABLE2_REF_UNSAFE = 2
TABLE2_REF_M = 16
TABLE2_REF_STEPS = 3
TABLE2_REF_BACKUP_ITERS = 50
#: the baselines (phases 25-28): (name, preset, overrides).  The JAX package
#: has no BC preset, nor does the port: BC is e3_vae's recipe with the BC
#: head in place of the VAE and no init hint
BC_KW = {"vae": False, "bc": True, "use_init_hint": False}
BASELINES = (("e3", "e3_vae", {}), ("e6", "e6_trafficsim", {}),
             ("bc", "e3_vae", BC_KW))
#: the baselines' train steps at full width (phase 26)
BASELINE_STEPS = 4
#: kernels of a trajopt iteration's device-time breakdown
TOP_KERNELS = 8
#: the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): HBM,
#: and operations per second by operand type (bf16 / fp16 on the tensor
#: cores, float32 outside them)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

# kernel vs plain tolerance (see kernel_phase): controls are normalized
# (|mu| ~ 1); rtol/atol of the JAX package's own kernel-vs-XLA tests
RTOL, ATOL = 2e-4, 2e-5
# share of elements allowed outside RTOL/ATOL, and their bound: a freeze
# argmin can flip on a near-tie between fp32 sums taken in another order
# (FMA contraction on the card), which moves that column's Adam path; the
# move stays inside the trust region |delta| <= beta on either side
MAX_OFF_SHARE = 1e-3
# clearance kernels vs plain: the JAX package's kernel-vs-XLA tolerances
# (tests/test_pallas_kernels.py), for every forward element (the minimum
# is continuous: a near-tie flip moves it by an ulp).  A backward element
# may lie beyond them only where the plain version decides the routing by
# less than CLEAR_TIE_M metres (two neighbors' clearances, the minimal
# neighbor's two closest disc pairs, or its clearance and a clip bound):
# there a 1-ulp difference of cos / sin / sqrt sends that element's
# cotangent elsewhere; at most CLEAR_MAX_OFF_SHARE of the elements
CLEAR_FWD_RTOL, CLEAR_BWD_RTOL, CLEAR_ATOL = 1e-4, 1e-3, 1e-4
CLEAR_TIE_M = 3e-5        # a few ulp of an 80 m coordinate
CLEAR_MAX_OFF_SHARE = 1e-3
# card vs CPU for one fp32 mono train step (phase 14): the card's matmuls
# and reductions sum in another order; metrics rtol, and each gradient
# tensor (the backward kernel's own output too) to this share of its
# largest entry.  The backward kernel's inputs differ between card and CPU
# by the rollouts' rounding, which must stay below a tenth of MONO_TIE_M,
# the near-tie margin of its elements there.  The phase's scenes put one
# neighbor on the ego's own track, so about a tenth of the elements sit at
# a near-tie, and inputs that differ by that rounding flip more of them
# than identical inputs do: up to MONO_MAX_OFF_SHARE of the elements, all
# at near-ties, may route their cotangent elsewhere
MONO_RTOL, MONO_GRAD_TOL = 1e-4, 1e-3
MONO_TIE_M, MONO_MAX_OFF_SHARE = 1e-3, 1e-2
# card vs CPU for one fp32 dense train step (phase 16): the mono step's
# tolerances.  The card sums its matmuls and reductions in another order,
# and the e7 step carries that through 99 denoise steps, the argmax over
# the last 5 decodings, the RefineNet's violation gate and the hinge of the
# tau = 100 soft-mins; on the CPU a one-ulp perturbation of every weight
# moves the metrics by 2.8e-7 and the gradients by 1.3e-5 of their
# tensors' largest entries.  After a checkpoint (phase 18) the next step of
# the saved and of the loaded state must agree to DENSE_RESUME_TOL
DENSE_RTOL, DENSE_GRAD_TOL = MONO_RTOL, MONO_GRAD_TOL
DENSE_RESUME_TOL = 1e-6
# card vs CPU for trajopt (phase 19): controls within TJ_PARAM_ATOL after
# 20 Adam steps and final scores within TJ_SCORE_ATOL (tests/
# test_torch_trajopt.py's bounds against JAX), on all but TJ_MAX_OFF_SHARE of
# the elements / rows: a near-tie of a lane-segment or disc-pair argmin
# sends a row's gradient elsewhere, and Adam then moves it apart by up to
# its step size
TJ_PARAM_ATOL, TJ_SCORE_ATOL, TJ_MAX_OFF_SHARE = 1e-4, 1e-3, 1e-2
# card vs CPU for the evaluation (phase 21): the reverse pass agrees to 1e-3
# in the controls (phase 5); a 2 s rollout and the tau = 100 clauses carry
# that to about 1e-2 in a score.  The multi-cands argmax, the RefineNet's
# violation gate and the guidance's in-kernel argmins are discrete, so a
# row at a near-tie may go another way: at most EVAL_MAX_OFF_SHARE of them
EVAL_SCORE_ATOL, EVAL_MAX_OFF_SHARE = 1e-2, 1e-2
# unguided superstep vs plain, elementwise on x_next: the MLP sums in fp32
# in another order than the library matmul, so a bf16 activation can round
# one step (2^-8 relative) the other way; that moves eps by about that step
# times an output weight (~1e-4 per flip at the e7 weights) and x_next by
# c1/c2 of it (0.019 at t=60, 0.013 at t=5)
SS_RTOL, SS_ATOL = 1e-4, 1e-4
# card vs CPU for the Table-II step (phase 23): phase 5's reverse-pass
# tolerance on the chosen plan's first states and on the ego state after
# the step (an Euler step of 0.5 s moves it by dt times the first control's
# difference)
TABLE2_REF_TOL = 1e-3
# ... and the share of candidate rows whose score may differ by more than
# EVAL_SCORE_ATOL: phase 21's near-tie argument, on a path with guidance on
# every denoise step (3 Adam iterations, the hinge always active) and the
# refinement's violation gate, which each decide more rows at a near tie:
# up to 12 of 240 rows a step measured on an H100 80GB HBM3 at 700 W,
# bounded at twice that share
TABLE2_MAX_OFF_SHARE = 0.1
# the U-Net's activation pass (phase 37): rows a pass (16 scenes x 192
# candidates, the ctg-unet1d-cl16 cell's), and the kernel against its plain
# version (tests/test_torch_unet1d.py's tolerances): every element within
# one bfloat16 step (2^-7 of its size, plus UNET_ATOL; the two sum the groups
# in other orders and the card contracts to FMAs, which can flip the last
# rounding), at most UNET_MAX_FLIP_SHARE of them not equal to the bit; the
# float32 residual stream within UNET_F32_RTOL of its size, plus UNET_ATOL
UNET_ROWS = 3072
UNET_BF16_RTOL, UNET_F32_RTOL, UNET_ATOL = 2.0 ** -7, 1e-5, 1e-5
UNET_MAX_FLIP_SHARE = 1e-2


def log(msg):
    print(msg, flush=True)


def gpu_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


#: a launch-geometry macro of a kernel source: warps and candidate columns a
#: block, blocks an SM (the register cap), output tiles a warp; for the
#: clearance kernels candidate rows and most threads a block, and the nL
#: whose disc-pair loop is a template instance
GEOMETRY_MACRO = (r"^#define (\w+_(?:WARPS|COLS|MINB|NTW|ROWS|THREADS|NLT)) "
                  r"+(\d+)")


def geometry(name):
    """The launch geometry ``csrc/<name>.cu`` is built with: macro -> value."""
    import re
    path = os.path.join(HERE, "pstl_tpu_torch", "csrc", f"{name}.cu")
    with open(path) as f:
        return dict(re.findall(GEOMETRY_MACRO, f.read(), re.M))


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def time_cuda(fn, n=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return median(ts)


def time_kernel(fn, reps=20, rounds=7):
    """Device time of one call of ``fn`` in ms: ``reps`` calls are captured
    into a CUDA graph, and the median over ``rounds`` replays of the graph's
    time over ``reps`` is returned.  A replay has no host work between the
    launches, so this is the kernel's own time even where it is shorter than
    its wrapper's host time (which ``time_cuda`` would then measure).  The
    operands stay in L2 between the launches, as they mostly do for the
    caller in a denoise loop."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / reps)
    return median(ts)


def kernel_ms(fn):
    """Both times of one wrapper call, as the record's keys: ``ms``, the
    median of single eager calls between CUDA events (host time of the
    wrapper included where it outlasts the kernel, operands from wherever
    the call before left them), and ``graph_ms``, the kernel's own time as a
    CUDA graph replays it (``time_kernel``: operands in L2)."""
    return {"ms": time_cuda(fn), "graph_ms": time_kernel(fn)}


def nbytes(*xs):
    """Bytes of every tensor in ``xs`` (nested tuples / lists walked)."""
    import torch
    out = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            out += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            out += nbytes(*x)
    return out


def bound(n_bytes, ops):
    """(bound_ms, bound_by): the least time for these bytes and operations
    at the card's peaks.  ``ops`` maps an operand type to the operations on
    it (a number is float32); the pipes of two types can run at once, so
    the operations take the longest of their types' times."""
    if not isinstance(ops, dict):
        ops = {"float32": ops}
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def guidance_ops(p, bs, R, freeze):
    """The arithmetic of one guidance update, counted from the shapes, each
    fp32 add, multiply, compare or transcendental one operation: per
    candidate column and Adam iteration a forward pass (the rollout ~12 per
    t, the frozen lane segment's distance and heading ~30 per t, ~20 for
    the clause terms and their exps per t, the frozen disc pair's clearance
    ~15 per (k, t)), a backward of about twice that, and Adam ~12 per
    control; the in-kernel freeze adds the segment search over the S
    waypoints of 3 lanes (~10 per point) per t and the disc-pair search per
    (k, t) (nLe*nLn pairs, or nLe+nLn with the coarse pair, ~6 each)."""
    T, K = p.T, p.K
    fwd = T * (12 + 30 + 20) + K * T * 15
    ops = p.niters * (3 * fwd + 2 * T * 12)
    if freeze:
        pairs = (p.nLe + p.nLn) if p.coarse else p.nLe * p.nLn
        ops += T * 3 * p.S * 10 + K * T * pairs * 6
    return bs * R * ops


def superstep_ops(mlp, p, bs, R, guided):
    """By operand type: the split eps MLP's multiply-adds (2 operations
    each) over bs*R columns in the MLP's dtype, and in float32 the
    posterior and noise (~6 per control) and the guided update when
    ``guided``."""
    dims = [mlp.base.shape[1]] + [W.shape[0] for W, _ in mlp.mid]
    T = mlp.WnwT.shape[1]
    macs = dims[0] * 2 * T + sum(a * b for a, b in zip(dims, dims[1:])) \
        + dims[-1] * 2 * T
    fp32 = bs * R * 12 * T + (guidance_ops(p, bs, R, True) if guided else 0)
    mlp_ops = bs * R * 2 * macs
    dt = str(mlp.base.dtype).replace("torch.", "")
    if dt == "float32":
        return {"float32": fp32 + mlp_ops}
    return {dt: mlp_ops, "float32": fp32}


def clearance_ops(n, K, T, nL, backward, m=1):
    """What the function needs, whatever implements it.  Per (scene, k, t),
    with n / m scenes: the neighbor's discs (~8 per disc, cos, sin).  Per
    (row, t): the ego discs (~4 per disc, cos, sin) and per neighbor the
    nL*nL squared distances (~6 each, with the min), sqrt, radii, clip and
    mask (~10).  The VJP is that forward once, the pair ties of the minimal
    neighbor and the cotangent's routing (~8 per pair) and the heading term
    (~8 per disc)."""
    per_item = 4 * nL + 2 + K * (6 * nL * nL + 10)
    if backward:
        per_item += 8 * nL * nL + 8 * nL
    return n * T * per_item + (n // m) * K * T * (8 * nL + 2)


def scene_batch(cfg, dev, n_scenes=SCENES, scene_len=38):
    from pstl_tpu_torch import sim
    from pstl_tpu_torch.data import synthetic
    data = synthetic.generate_dataset(0, n_scenes, cfg, scene_len=scene_len)
    return sim.scenes_from_dataset(data, device=dev)


def plan_inputs(cfg, scenes, seed=0):
    """The first plan step's observation, dense batch and guidance loss of
    the scenes, and a posterior mean from a seeded draw."""
    import torch
    from pstl_tpu_torch import sim, specs
    dev = scenes.ego_full.device
    bs = scenes.ego_full.shape[0]
    obs = sim.observe(scenes, scenes.ego_full[:, 0],
                      torch.zeros(bs, dtype=torch.long, device=dev), cfg)
    n = bs * cfg.n_randoms * 3
    stlp = torch.as_tensor(sim.AGGRESSIVE_STLP, device=dev)
    dense = specs.densify_batch(obs, stlp.expand(bs, 6), cfg,
                                stlp.expand(n, 1, 6))
    fused = specs.make_guidance_loss(obs, dense, cfg,
                                     obs["ego_traj"][:, 0, :4],
                                     dense["valids_dense"].reshape(-1))
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    mu = torch.randn((bs, cfg.nt, 2, fused.R), generator=g, device=dev)
    return dense, fused, mu


def superstep_inputs(cfg, scenes, net, seed=0):
    """Superstep operands of the first plan step (the net's split MLP at
    its compute dtype, the guidance operands, the step tables) and a seeded
    x and z, all at the scenes' shapes."""
    import torch
    from pstl_tpu_torch import diffusion
    from pstl_tpu_torch.models import net as models
    from pstl_tpu_torch.ops import guidance_kernel as gk
    from pstl_tpu_torch.ops import superstep_kernel as sk
    dev = scenes.ego_full.device
    dense, fused, _ = plan_inputs(cfg, scenes, seed)
    with torch.no_grad():
        feature = torch.repeat_interleave(net.encode(dense),
                                          cfg.n_randoms * 3, 0)
        cm = models.make_cm_eps_fn(net, dense, dense["highlevel_dense"],
                                   feature, cfg)
    gops = gk.kernel_operands(fused, cfg)
    te_all, gvec_all = sk.step_tables(
        cfg, diffusion.get_coeffs(cfg, device=dev), cm.operands,
        gops.gscale, True)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    shape = (fused.bs, cfg.nt, 2, fused.R)
    x = torch.randn(shape, generator=g, device=dev)
    z = torch.randn(shape, generator=g, device=dev)
    return (x, z, te_all, gvec_all, sk.mlp_operands(cm.operands), gops,
            gk.kernel_params(cfg, fused))


def check_guided(got, ref, start, beta, what):
    """The guided tolerance (see MAX_OFF_SHARE); returns the max error."""
    import torch
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{what}: output is not finite")
    err = (got - ref).abs()
    share = float((err > ATOL + RTOL * ref.abs()).float().mean())
    max_err = float(err.max())
    limit = 2 * beta + 1e-6
    log(f"{what}: max_abs_err={max_err:.3e} off_share={share:.2e} "
        f"moved={float((got - start).abs().max()):.3e}")
    if share > MAX_OFF_SHARE or max_err > limit:
        raise RuntimeError(
            f"{what} disagrees with the plain version: {share:.2e} of "
            f"elements beyond rtol {RTOL} / atol {ATOL} (allowed "
            f"{MAX_OFF_SHARE}), max error {max_err:.3e} (bound {limit:.3e})")
    return max_err


def kernel_phase(dev):
    """Kernel vs plain at the main-path shapes for every flag combination
    the kernel branches on; returns the JSON record's numbers."""
    import torch
    from pstl_tpu_torch import diffusion
    from pstl_tpu_torch.config import bench_config
    from pstl_tpu_torch.ops import guidance_kernel as gk

    base = bench_config("heavy")
    scenes = scene_batch(base, dev)
    coeffs = diffusion.get_coeffs(base, device=dev)
    worst = 0.0
    heavy_ms = heavy_plain_ms = heavy_bound = None
    outs = {}
    for coarse in (True, False):
        for bf16 in (True, False):
            for quirk in (False, True):
                cfg = base.with_(clearance_coarse_pair=coarse,
                                 guidance_pallas_bf16_cumsum=bf16,
                                 guidance_positive_offset_quirk=quirk)
                _, fused, mu = plan_inputs(cfg, scenes)
                ops = gk.kernel_operands(fused, cfg)
                p = gk.kernel_params(cfg, fused)
                # a mid-chain beta_t, where the trust region rarely binds,
                # and a late one, where it does
                for t in (60, 5):
                    gvec = torch.stack([coeffs.beta[t],
                                        torch.tensor(100.0, device=dev),
                                        ops.gscale])
                    w = mu[:, :, 0].contiguous()
                    a = mu[:, :, 1].contiguous()
                    args = (w, a, *ops[:-1], gvec, p)
                    ow, oa = gk.guidance_fused(*args)
                    pw, pa = gk.guidance_fused_plain(*args)
                    torch.cuda.synchronize()
                    got = torch.stack([ow, oa])
                    ref = torch.stack([pw, pa])
                    if not torch.isfinite(got).all():
                        raise RuntimeError("kernel output is not finite")
                    err = (got - ref).abs()
                    off = err > ATOL + RTOL * ref.abs()
                    share = float(off.float().mean())
                    max_err = float(err.max())
                    limit = 2 * float(coeffs.beta[t]) + 1e-6
                    moved = float((got - torch.stack([w, a])).abs().max())
                    log(f"kernel coarse={int(coarse)} bf16={int(bf16)} "
                        f"quirk={int(quirk)} t={t}: max_abs_err="
                        f"{max_err:.3e} off_share={share:.2e} "
                        f"moved={moved:.3e}")
                    if share > MAX_OFF_SHARE or max_err > limit:
                        raise RuntimeError(
                            f"kernel disagrees with the plain version: "
                            f"{share:.2e} of elements beyond rtol {RTOL} / "
                            f"atol {ATOL} (allowed {MAX_OFF_SHARE}), max "
                            f"error {max_err:.3e} (bound {limit:.3e})")
                    if moved <= 0:
                        raise RuntimeError("the kernel did not move mu")
                    worst = max(worst, max_err)
                    outs[(coarse, bf16, quirk, t)] = got
                    if coarse and bf16 and not quirk and t == 60:
                        heavy_ms = kernel_ms(
                            lambda: gk.guidance_fused(*args))
                        heavy_plain_ms = time_cuda(
                            lambda: gk.guidance_fused_plain(*args))
                        heavy_bound = bound(
                            nbytes(args[:-1], ow, oa),
                            guidance_ops(p, SCENES, fused.R, True))
    # every flag must change the kernel's result on this problem
    for i, flag in enumerate(("coarse", "bf16", "quirk")):
        on = (True, True, False, 60)
        off = tuple((not v) if j == i else v for j, v in enumerate(on))
        d = float((outs[on] - outs[off]).abs().max())
        log(f"kernel flag {flag}: on vs off max diff {d:.3e}")
        if not d > 0:
            raise RuntimeError(f"flag {flag} does not change the kernel")
    log(f"kernel times (coarse+bf16, bs={SCENES}, R={3 * base.n_randoms}, "
        f"niters={base.guidance_niters}): kernel {heavy_ms['graph_ms']:.4f} "
        f"ms (graph replay), one eager call {heavy_ms['ms']:.4f} ms, plain "
        f"{heavy_plain_ms:.4f} ms (median of 20); bound "
        f"{heavy_bound[0]:.5f} ms ({heavy_bound[1]})")
    return worst, heavy_ms, heavy_plain_ms, heavy_bound


def superstep_phase(dev, net):
    """The superstep kernel vs its plain version at the main shapes, guided
    and unguided, for every flag combination the guided update branches on,
    at t=60 and t=5; returns the JSON record's numbers."""
    import torch
    from pstl_tpu_torch.config import bench_config
    from pstl_tpu_torch.ops import superstep_kernel as sk

    base = bench_config("heavy", gpallas="4")
    scenes = scene_batch(base, dev)
    T = base.diffusion_steps
    worst = 0.0
    times = {}
    for coarse in (True, False):
        for bf16 in (True, False):
            for quirk in (False, True):
                cfg = base.with_(clearance_coarse_pair=coarse,
                                 guidance_pallas_bf16_cumsum=bf16,
                                 guidance_positive_offset_quirk=quirk)
                x, z, te_all, gvec_all, mlp, gops, p = superstep_inputs(
                    cfg, scenes, net)
                for t in (60, 5):
                    j = T - 1 - t
                    outs = {}
                    for guided in (True, False):
                        args = (x, z, te_all[j], gvec_all[j], mlp, gops, p,
                                guided)
                        with torch.no_grad():
                            got = sk.superstep(*args)
                            ref = sk.superstep_plain(*args)
                        torch.cuda.synchronize()
                        what = (f"superstep coarse={int(coarse)} "
                                f"bf16={int(bf16)} quirk={int(quirk)} t={t} "
                                f"{'guided' if guided else 'unguided'}")
                        if guided:
                            err = check_guided(got, ref, x,
                                               float(gvec_all[j, 0]), what)
                        else:
                            if not torch.isfinite(got).all():
                                raise RuntimeError(f"{what}: not finite")
                            d = (got - ref).abs()
                            err = float(d.max())
                            bad = int((d > SS_ATOL + SS_RTOL
                                       * ref.abs()).sum())
                            tenth = int((d > 0.1 * (SS_ATOL + SS_RTOL
                                                    * ref.abs())).sum())
                            log(f"{what}: max_abs_err={err:.3e} "
                                f"beyond_tol={bad} (beyond a tenth of it, "
                                f"where a bf16 activation rounded the other "
                                f"way: {tenth} of {d.numel()})")
                            if bad:
                                raise RuntimeError(
                                    f"{what} disagrees with the plain "
                                    f"version beyond rtol {SS_RTOL} / atol "
                                    f"{SS_ATOL}: {err:.3e}")
                        worst = max(worst, err)
                        outs[guided] = got
                        if coarse and bf16 and not quirk and t == 60:
                            # each weight counts once: the packed copy
                            # holds the same values in fragment order
                            moved = nbytes(args[:4], gops, got,
                                           mlp._replace(packed=None))
                            with torch.no_grad():
                                times[guided] = (
                                    kernel_ms(lambda: sk.superstep(*args)),
                                    time_cuda(
                                        lambda: sk.superstep_plain(*args)),
                                    bound(moved, superstep_ops(
                                        mlp, p, SCENES, x.shape[-1],
                                        guided)))
                    if not float((outs[True] - outs[False]).abs().max()) > 0:
                        raise RuntimeError("the guided superstep did not "
                                           "change the step")
    for guided, (ms, plain_ms, bnd) in times.items():
        log(f"superstep times ({'guided' if guided else 'unguided'}, "
            f"coarse+bf16, bs={SCENES}, R={3 * base.n_randoms}, hidden "
            f"{base.hiddens}): kernel {ms['graph_ms']:.4f} ms (graph replay), "
            f"one eager call {ms['ms']:.4f} ms, plain {plain_ms:.4f} ms "
            f"(median of 20); bound {bnd[0]:.5f} ms ({bnd[1]})")
    eps_ms = eps_forward_ms(base, scenes, net)
    log(f"superstep unguided {times[False][0]['graph_ms']:.4f} ms beside the "
        f"eager "
        f"make_cm_eps_fn forward (library gemms, the MLP alone: no "
        f"posterior, no noise term) {eps_ms:.4f} ms (graph replay), same "
        f"shapes")
    return worst, times[True][0], times[True][1], times[True][2]


def eps_forward_ms(cfg, scenes, net):
    """Device time of the candidate-minor eps forward in PyTorch ops
    (``make_cm_eps_fn``: three library gemms and their elementwise ops) at
    the superstep's shapes.  Context for the kernel's MLP phase, not its
    ``library_ms``: it computes the MLP alone."""
    import torch
    from pstl_tpu_torch.models import net as models
    dense, fused, _ = plan_inputs(cfg, scenes)
    with torch.no_grad():
        feature = torch.repeat_interleave(net.encode(dense),
                                          cfg.n_randoms * 3, 0)
        cm = models.make_cm_eps_fn(net, dense, dense["highlevel_dense"],
                                   feature, cfg)
        x = torch.randn((fused.bs, cfg.nt, 2, fused.R),
                        device=scenes.ego_full.device)
        return time_kernel(lambda: cm(x, 60))


def reference_phase(dev, net_cpu, net_dev, routes=(("2", 1), ("4", 1))):
    """One small reverse pass on the card (kernels) against the CPU (plain
    versions) on pinned noise, for each (BENCH_GPALLAS, sel_every) route:
    by default the default path and superstep."""
    from pstl_tpu_torch.config import bench_config

    for gpallas, sel_every in routes:
        cfg = bench_config("heavy", gpallas=gpallas,
                           sel_every=sel_every).with_(
            n_randoms=4, diffusion_steps=12, compute_dtype="float32")
        reference_pass(dev, net_cpu, net_dev, cfg,
                       f"BENCH_GPALLAS={gpallas} sel_every={sel_every}")


def reference_pass(dev, net_cpu, net_dev, cfg, what):
    import torch
    from pstl_tpu_torch import diffusion
    from pstl_tpu_torch.models import net as models

    out = {}
    for d, net in (("cpu", net_cpu), (dev, net_dev)):
        dense, fused, _ = plan_inputs(cfg, scene_batch(cfg, d, n_scenes=2))
        g = torch.Generator()
        g.manual_seed(3)
        noise = torch.randn((cfg.diffusion_steps, 2, cfg.nt, 2, fused.R),
                            generator=g).to(d)
        with torch.no_grad():
            feature = torch.repeat_interleave(net.encode(dense),
                                              cfg.n_randoms * 3, 0)
            cm_fn = models.make_cm_eps_fn(net, dense,
                                          dense["highlevel_dense"], feature,
                                          cfg)
            ctrl, _ = diffusion.reverse_sample(
                cm_fn, fused, cfg, diffusion.get_coeffs(cfg, device=d),
                maximize=True, noise=noise)
        out[str(d)] = ctrl.cpu()
    err = float((out[str(dev)] - out["cpu"]).abs().max())
    tol = 1e-3
    log(f"reference: reverse pass card vs cpu ({what}), "
        f"max_abs_err={err:.3e} (tolerance {tol})")
    if not err <= tol:
        raise RuntimeError(f"card and cpu reverse passes disagree: {err}")


def reset_counts():
    """Every kernel's launch count to 0."""
    from pstl_tpu_torch.ops import clearance_kernel as ck
    from pstl_tpu_torch.ops import guidance_kernel as gk
    from pstl_tpu_torch.ops import superstep_kernel as sk
    gk.launches = gk.frozen_launches = sk.launches = sk.guided_launches = 0
    ck.fwd_launches = ck.bwd_launches = 0


def read_counts():
    from pstl_tpu_torch.ops import clearance_kernel as ck
    from pstl_tpu_torch.ops import guidance_kernel as gk
    from pstl_tpu_torch.ops import superstep_kernel as sk
    return {"guidance_fused": gk.launches,
            "guidance_frozen": gk.frozen_launches,
            "superstep": sk.launches,
            "superstep_guided": sk.guided_launches,
            "min_clearance_fwd": ck.fwd_launches,
            "min_clearance_bwd": ck.bwd_launches}


def run_loop(dev, net, cfg, steps, scenes=None, mesh=None):
    """``steps`` closed-loop steps of the scenes under ``cfg`` (SCENES
    synthetic ones unless given; this rank's share of them under ``mesh``,
    whose metrics are every rank's), with every kernel's launch count set
    to 0 just before and read just after; every metric must be finite.
    Returns (counts, metrics, step seconds, wall)."""
    import torch
    from pstl_tpu_torch import diffusion, sim

    if scenes is None:
        scenes = scene_batch(cfg, dev)
    coeffs = diffusion.get_coeffs(cfg, device=dev)
    init_carry, step = sim.make_closed_loop_step(scenes, cfg, net, coeffs,
                                                 mesh=mesh)
    c = init_carry(0)
    torch.cuda.synchronize()
    reset_counts()
    step_s = []
    t_all = time.time()
    for _ in range(steps):
        t0 = time.time()
        c = step(c)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
    wall = time.time() - t_all
    counts = read_counts()
    m = {k: v.cpu() for k, v in sim._carry_metrics(c, mesh).items()}
    for k, v in m.items():
        if not torch.isfinite(v.float()).all():
            raise RuntimeError(f"closed-loop metric {k} is not finite")
    return counts, m, step_s, wall


def check_counts(counts, want, what):
    """``want`` names the kernels the run must launch; every other count
    must be 0."""
    want = {k: want.get(k, 0) for k in counts}
    if counts != want:
        raise RuntimeError(f"{what}: kernel launches {counts}, expected "
                           f"{want}")


#: what -> (median step s, quality) of every closed loop ``report_loop``
#: printed, for the rows printed beside each other
LOOPS = {}


def report_loop(what, steps, counts, m, step_s, wall):
    sps = SCENES / median(step_s)
    LOOPS[what] = (median(step_s), {
        k: float(m[k].float().mean())
        for k in ("stl_acc", "collide", "out_of_lane", "progress")})
    log(f"{what}: {SCENES} scenes x {steps} steps, launches={counts}, "
        f"stl_compliance={float(m['stl_acc'].mean()):.4f} "
        f"collide_rate={float(m['collide'].mean()):.4f} "
        f"out_of_lane_rate={float(m['out_of_lane'].mean()):.4f} "
        f"mean_progress_m={float(m['progress'].mean()):.3f} "
        f"agent_steps_per_s={sps:.3f} (median step "
        f"{median(step_s) * 1e3:.1f} ms, first {step_s[0] * 1e3:.1f} ms, "
        f"wall {wall:.2f} s)")


def route_call(dev, cfg, what):
    """``guidance_adam_cm`` of ``cfg``'s route on the card against the plain
    version of its kernel on the same inputs (the same ``freeze_cm``
    payloads on the frozen route); returns (max error, ms, plain ms), the
    times of the whole call (operand packing included) and of the plain
    version."""
    import torch
    from pstl_tpu_torch import diffusion
    from pstl_tpu_torch.ops import guidance_kernel as gk

    coeffs = diffusion.get_coeffs(cfg, device=dev)
    _, fused, mu = plan_inputs(cfg, scene_batch(cfg, dev))
    beta = coeffs.beta[60]
    ff = cfg.guidance_pallas_fuse_freeze
    with torch.no_grad():
        frozen = None if ff else fused.freeze_cm(mu)

        def call():
            return gk.guidance_adam_cm(fused, frozen, mu, beta, 100.0, cfg,
                                       fuse_freeze=ff)

        got = call()
    ops = gk.kernel_operands(fused, cfg)
    gvec = torch.stack([beta, torch.tensor(100.0, device=dev), ops.gscale])
    w, a = mu[:, :, 0].contiguous(), mu[:, :, 1].contiguous()
    if ff:
        plain = gk.guidance_fused_plain
        args = (w, a, *ops[:-1], gvec, gk.kernel_params(cfg, fused))
    else:
        plain = gk.guidance_frozen_plain
        args = (w, a, *gk.frozen_operands(frozen), *gk.frozen_scene(ops),
                gvec, gk.kernel_params(cfg, fused))
    ref = torch.stack(plain(*args), dim=2)
    torch.cuda.synchronize()
    err = check_guided(got, ref, mu, float(beta), f"{what} guidance_adam_cm")
    with torch.no_grad():
        ms = kernel_ms(call)
    plain_ms = time_cuda(lambda: plain(*args))
    bnd = bound(nbytes(args[:-1], ref),
                guidance_ops(args[-1], fused.bs, fused.R, ff))
    log(f"{what} times: guidance_adam_cm {ms['ms']:.4f} ms one eager call, "
        f"{ms['graph_ms']:.4f} ms in a graph replay, plain {plain_ms:.4f} ms "
        f"(median of 20); kernel bound {bnd[0]:.5f} ms ({bnd[1]})")
    return err, ms, plain_ms, bnd


#: the kernel each BENCH_GPALLAS route launches once per guided denoise step
ROUTE_KERNEL = {"0": None, "1": "guidance_frozen", "1f": "guidance_frozen",
                "2f": "guidance_fused", "2": "guidance_fused",
                "3": "guidance_fused"}


def route_phase(dev, net, gpallas, steps, sel_every=1):
    """The configuration ``bench_config("heavy", gpallas, sel_every)``: its
    guidance call against the plain version (not for the XLA loop, which
    runs no kernel), then ``steps`` closed-loop steps, which must launch
    the route's kernel once per guided denoise step and nothing else.
    Returns (launches, max error, ms, plain ms, bound, median step s)."""
    from pstl_tpu_torch import diffusion
    from pstl_tpu_torch.config import bench_config

    t0 = time.time()
    cfg = bench_config("heavy", gpallas=gpallas, sel_every=sel_every)
    what = f"BENCH_GPALLAS={gpallas} sel_every={sel_every}"
    kernel = ROUTE_KERNEL[gpallas]
    err = ms = plain_ms = bnd = None
    if kernel is not None:
        err, ms, plain_ms, bnd = route_call(dev, cfg, what)
    counts, m, step_s, wall = run_loop(dev, net, cfg, steps)
    guided = int(diffusion._trigger_schedule(cfg).sum())
    check_counts(counts, {kernel: guided * steps} if kernel else {},
                 f"{what} closed loop")
    report_loop(f"{what} closed loop", steps, counts, m, step_s, wall)
    log(f"{what}: phase wall {time.time() - t0:.1f} s")
    return (counts.get(kernel, 0), err, ms, plain_ms, bnd, median(step_s))


def frozen_phase(dev):
    """The frozen-payload kernel against its plain version at the main
    shapes on the same payloads (``freeze_cm`` once on the card per
    configuration), for every flag the kernel branches on at t=60 and t=5,
    and bf16 geometry payloads; returns the JSON record's numbers."""
    import torch
    from pstl_tpu_torch import diffusion
    from pstl_tpu_torch.config import bench_config
    from pstl_tpu_torch.ops import guidance_kernel as gk

    t_start = time.time()
    base = bench_config("heavy", gpallas="1")
    scenes = scene_batch(base, dev)
    coeffs = diffusion.get_coeffs(base, device=dev)
    cases = [(c, b, q, "float32") for c in (True, False)
             for b in (True, False) for q in (False, True)]
    cases.append((True, True, False, "bfloat16"))
    worst = 0.0
    outs = {}
    times = None
    for coarse, bf16, quirk, geom in cases:
        cfg = base.with_(clearance_coarse_pair=coarse,
                         guidance_pallas_bf16_cumsum=bf16,
                         guidance_positive_offset_quirk=quirk,
                         geometry_dtype=geom)
        _, fused, mu = plan_inputs(cfg, scenes)
        with torch.no_grad():
            pay = gk.frozen_operands(fused.freeze_cm(mu))
        ops = gk.kernel_operands(fused, cfg)
        p = gk.kernel_params(cfg, fused)
        w, a = mu[:, :, 0].contiguous(), mu[:, :, 1].contiguous()
        for t in (60, 5):
            beta = coeffs.beta[t]
            gvec = torch.stack([beta, torch.tensor(100.0, device=dev),
                                ops.gscale])
            args = (w, a, *pay, *gk.frozen_scene(ops), gvec, p)
            got = torch.stack(gk.guidance_frozen(*args))
            ref = torch.stack(gk.guidance_frozen_plain(*args))
            torch.cuda.synchronize()
            err = check_guided(
                got, ref, torch.stack([w, a]), float(beta),
                f"frozen coarse={int(coarse)} bf16={int(bf16)} "
                f"quirk={int(quirk)} geometry={geom} t={t}")
            if not float((got - torch.stack([w, a])).abs().max()) > 0:
                raise RuntimeError("the frozen kernel did not move mu")
            worst = max(worst, err)
            outs[(coarse, bf16, quirk, geom, t)] = got
            if (coarse, bf16, quirk, geom, t) == (True, True, False,
                                                  "float32", 60):
                times = (kernel_ms(lambda: gk.guidance_frozen(*args)),
                         time_cuda(lambda: gk.guidance_frozen_plain(*args)),
                         bound(nbytes(args[:-1], got),
                               guidance_ops(p, SCENES, fused.R, False)))
    on = (True, True, False, "float32", 60)
    for i, flag in enumerate(("coarse", "bf16", "quirk", "geometry")):
        off = list(on)
        off[i] = "bfloat16" if flag == "geometry" else not on[i]
        d = float((outs[on] - outs[tuple(off)]).abs().max())
        log(f"frozen flag {flag}: on vs off max diff {d:.3e}")
        if not d > 0:
            raise RuntimeError(f"flag {flag} does not change the frozen "
                               "kernel")
    log(f"frozen kernel times (coarse+bf16, bs={SCENES}, "
        f"R={3 * base.n_randoms}, niters={base.guidance_niters}): kernel "
        f"{times[0]['graph_ms']:.4f} ms (graph replay), one eager call "
        f"{times[0]['ms']:.4f} ms, plain {times[1]:.4f} ms (median of 20); "
        f"bound "
        f"{times[2][0]:.5f} ms ({times[2][1]}); phase wall "
        f"{time.time() - t_start:.1f} s")
    return worst, times[0], times[1], times[2]


def superstep_loop_phase(dev, net):
    """The heavy contract and the mixed-schedule parity contract under the
    superstep configuration."""
    from pstl_tpu_torch import diffusion
    from pstl_tpu_torch.config import bench_config

    cfg = bench_config("heavy", gpallas="4")
    counts, m, step_s, wall = run_loop(dev, net, cfg, STEPS)
    n = (cfg.diffusion_steps - 1) * STEPS
    check_counts(counts, {"guidance_fused": 0, "superstep": n,
                          "superstep_guided": n}, "superstep closed loop")
    report_loop("superstep closed loop", STEPS, counts, m, step_s, wall)
    launches, step_med = counts["superstep"], median(step_s)

    cfg = bench_config("parity", gpallas="4")
    guided = int(diffusion._trigger_schedule(cfg).sum())
    counts, m, step_s, wall = run_loop(dev, net, cfg, MIXED_STEPS)
    check_counts(counts, {
        "guidance_fused": 0,
        "superstep": (cfg.diffusion_steps - 1) * MIXED_STEPS,
        "superstep_guided": guided * MIXED_STEPS},
        "superstep mixed schedule")
    report_loop(f"superstep mixed schedule ({guided} guided of "
                f"{cfg.diffusion_steps - 1} denoise steps)", MIXED_STEPS,
                counts, m, step_s, wall)
    return launches, step_med


# --------------------------------------------------------------------------
# the mono training step (phases 13-15)
# --------------------------------------------------------------------------

def straight_scenes(batch, cfg):
    """A numpy batch made into scenes where the safety clause binds for
    near-straight rollouts: the GT a constant-speed straight line from each
    scene's start, the lanes straight along it (3.5 m apart), neighbor 0
    driving on the GT path (the calibrated d_safe is 0 and the clearance
    about -1.7 m), every scene a lane keep."""
    import numpy as np
    b = {k: v.copy() for k, v in batch.items()}
    ego = b["ego_traj"]
    bs, T = ego.shape[:2]
    x0, y0, th0, v0 = (ego[:, 0, i][:, None] for i in range(4))
    s = v0 * cfg.dt * np.arange(T)
    c, sn = np.cos(th0), np.sin(th0)
    ego[..., 0], ego[..., 1], ego[..., 2], ego[..., 3] = (
        x0 + s * c, y0 + s * sn, th0, v0)
    sl = np.linspace(-10.0, 1.0, cfg.n_segs) * (v0 * cfg.dt * T + 10.0)
    sl = -sl[:, ::-1]
    for key, off in (("curr", 0.0), ("left", 3.5), ("right", -3.5)):
        b[f"{key}lane_wpts"] = np.stack(
            [x0 + sl * c - off * sn, y0 + sl * sn + off * c,
             np.broadcast_to(th0, sl.shape)], -1).astype(np.float32)
        b[f"{key}_id"] = np.ones((bs, 1), np.float32)
    nei = b["neighbors_traj"]
    nei[:, 0, :, 0] = 1.0
    nei[:, 0, :, 1:5] = ego[..., 0:4]
    nei[:, 0, :, 5], nei[:, 0, :, 6] = 4.0, 1.8
    b["neighbors"] = nei[:, :, 0].copy()
    b["gt_high_level"] = np.zeros((bs, 1), np.float32)
    return b


def swerving_neighbor(batch, cfg, drift=0.4):
    """``straight_scenes``' batch with neighbor 0's GT track sidestepping
    to the ego's left by ``drift`` metres a frame after frame 0 (heading
    and speed kept): its constant-velocity prediction from frame 0
    (``gt_nei=False``) stays on the ego's track, where the safety clause
    binds, while the GT track leaves it.  (The synthetic generator's
    neighbors drive at constant speed and heading, so there the prediction
    reproduces the GT tracks.)"""
    import numpy as np
    b = {k: v.copy() for k, v in batch.items()}
    nei = b["neighbors_traj"]
    th = nei[:, 0, :, 3]
    off = drift * np.arange(nei.shape[2], dtype=np.float32)
    nei[:, 0, :, 1] -= off * np.sin(th)
    nei[:, 0, :, 2] += off * np.cos(th)
    b["neighbors"] = nei[:, :, 0].copy()
    return b


def clearance_random_inputs(n, K, T, seed=0, clip_region=True):
    """tests/test_pallas_kernels.py-style clearance inputs as CPU tensors:
    about 30 % invalid neighbors; with ``clip_region`` the neighbors of
    three rows in four sit within 8 m of the ego (negative clearances) and
    the rest within 80 m (clearances clipped at 20)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    ego = np.stack([rng.uniform(-20, 20, (n, T)),
                    rng.uniform(-20, 20, (n, T)),
                    rng.uniform(-np.pi, np.pi, (n, T))], -1)
    nei = np.zeros((n, K, T, 7))
    nei[..., 0] = rng.rand(n, K, 1) > 0.3
    spread = (np.where(rng.rand(n, 1, 1) < 0.25, 80.0, 8.0) if clip_region
              else 25.0)
    for c in (0, 1):
        base = ego[:, None, :, c] if clip_region else 0.0
        nei[..., 1 + c] = base + spread * rng.uniform(-1, 1, (n, K, T))
    nei[..., 3] = rng.uniform(-np.pi, np.pi, (n, K, T))
    nei[..., 5] = rng.uniform(3.5, 5.5, (n, K, T))
    nei[..., 6] = rng.uniform(1.5, 2.2, (n, K, T))
    return (torch.as_tensor(ego, dtype=torch.float32),
            torch.as_tensor(nei, dtype=torch.float32))


def mono_net(cfg, dev, seed=0):
    """A flax-like initialised net of ``cfg`` on ``dev``."""
    import torch
    from pstl_tpu_torch.models.net import Net, init_flax_like
    net = Net(cfg)
    init_flax_like(net, torch.Generator().manual_seed(seed))
    return net.to(dev)


def e2_clearance_inputs(dev, cfg, batch):
    """The clearance kernels' operands in one ``e2_vae_mono`` step on
    ``batch``: one eval forward on the card, its forward-kernel call
    recorded: (ego, nei, rows_per_scene), the rollouts of the batch's VAE
    controls, its per-scene neighbors and n_randoms."""
    import torch
    from pstl_tpu_torch import diffusion, specs, train
    from pstl_tpu_torch.ops import clearance_kernel as ck
    net = mono_net(cfg, dev)
    eval_step = train.make_eval_step(cfg, net, specs.build_scorer(cfg),
                                     diffusion.get_coeffs(cfg, device=dev))
    seen = []
    real = ck.min_clearance_fwd

    def record(ego, nei, *a):
        seen.append((ego, nei, a[-1]))
        return real(ego, nei, *a)

    ck.min_clearance_fwd = record
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    try:
        eval_step(train.to_device(batch, dev), generator=gen)
    finally:
        ck.min_clearance_fwd = real
    return seen[0]


def clearance_near_ties(ego, nei, L, W, nL, margin, m=1):
    """(n, T) mask of the elements whose backward routing the plain version
    decides by at most ``margin`` metres: at a minimum inside the clip gate,
    the two smallest masked clearances over K, or, at a neighbor within
    ``margin`` of the minimum, its two closest disc pairs (in distance) or
    its clearance and a clip bound.  (Ties at the clip bound 20 or at the
    invalid value 100 route nothing.)  ``m``: ego rows a neighbor set."""
    import torch
    from pstl_tpu_torch.ops import clearance_kernel as ck
    masked, geo = ck._disc_geometry(ego, ck._per_row(ego, nei, m), L, W, nL)
    d2, per, valid = geo[4], geo[7], geo[8]
    srt = torch.sort(masked, dim=-1).values
    near = torch.zeros_like(srt[..., 0], dtype=torch.bool)
    if srt.shape[-1] > 1:
        near = ((srt[..., 1] - srt[..., 0] <= margin)
                & (srt[..., 0] < 20.0))
    dist = torch.sqrt(torch.sort(torch.stack(d2, -1).flatten(-2),
                                 dim=-1).values[..., :2] + 1e-12)
    pair = (dist[..., 1] - dist[..., 0] <= margin if dist.shape[-1] > 1
            else torch.zeros_like(per, dtype=torch.bool))
    clip = ((per + 5.0).abs() <= margin) | ((per - 20.0).abs() <= margin)
    at_min = (masked <= srt[..., :1] + margin) & (valid > 0)
    return near | ((pair | clip) & at_min).any(-1)


def clearance_check(what, got, ref, rtol, near=None, atol=CLEAR_ATOL,
                    max_share=CLEAR_MAX_OFF_SHARE):
    """Max error of ``got`` against ``ref`` (..., T[, 3]); every element
    within atol + rtol*|ref| except, where ``near`` (n, T) is given, at most
    ``max_share`` of them, all at near-ties; raises otherwise."""
    import torch
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{what}: output is not finite")
    err = (got - ref).abs()
    off = err > atol + rtol * ref.abs()
    if near is None:
        near = torch.zeros(off.shape[:2], dtype=torch.bool, device=off.device)
    at_tie = near.reshape(near.shape + (1,) * (off.ndim - near.ndim))
    bad = off & ~at_tie
    share = float(off.float().mean())
    max_err = float(err.max())
    far_err = float(torch.where(at_tie, 0.0, err).max())
    log(f"{what}: max_abs_err={max_err:.3e} ({far_err:.3e} away from "
        f"near-ties); beyond rtol {rtol} / atol {atol:.3e}: "
        f"{int(off.sum())} of {off.numel()} (share {share:.2e}, allowed "
        f"{max_share}), "
        f"{int(bad.sum())} of them away from the {int(near.sum())} "
        f"near-tie elements")
    if bad.any() or share > max_share:
        raise RuntimeError(f"{what} disagrees with the plain version beyond "
                           f"its tolerance (near-tie share allowed "
                           f"{max_share})")
    return max_err


def clearance_phase(dev):
    """Phase 13: both clearance kernels vs their plain versions at the main
    shapes on the e2 step's inputs (per-scene neighbors, 64 rows a scene)
    and on random ones (a neighbor set per row); returns per kernel (max
    error, ms, plain ms, bound) with the times on the e2 inputs."""
    import numpy as np
    import torch
    from pstl_tpu_torch.config import mono_config
    from pstl_tpu_torch.data.dataset import SceneDataset
    from pstl_tpu_torch.ops import clearance_kernel as ck

    t0 = time.time()
    cfg = mono_config("e2_vae_mono")
    ds = SceneDataset.from_synthetic(cfg, seed=0, n_scenes=cfg.batch_size)
    batch = ds.gather(np.arange(cfg.batch_size))
    L, W, nL = cfg.ego_L, cfg.ego_W, cfg.refined_nL
    n = cfg.batch_size * cfg.n_randoms
    sets = {"e2 step": e2_clearance_inputs(dev, cfg, batch),
            "random": tuple(x.to(dev) for x in clearance_random_inputs(
                n, cfg.n_neighbors, cfg.nt, seed=1)) + (1,)}
    g = torch.randn((n, cfg.nt),
                    generator=torch.Generator().manual_seed(2)).to(dev)
    worst = {"fwd": 0.0, "bwd": 0.0}
    res = {}
    for name, (ego, nei, m) in sets.items():
        want_m = cfg.n_randoms if name == "e2 step" else 1
        if (tuple(ego.shape) != (n, cfg.nt, 3) or m != want_m
                or tuple(nei.shape) != (n // m, 8, cfg.nt, 7)):
            raise RuntimeError(f"clearance inputs {name}: shapes "
                               f"{tuple(ego.shape)}, {tuple(nei.shape)}, "
                               f"{m} rows a scene")
        fwd = lambda: ck.min_clearance_fwd(ego, nei, L, W, nL, m)
        fwd_p = lambda: ck.min_clearance_fwd_plain(ego, nei, L, W, nL, m)
        bwd = lambda: ck.min_clearance_bwd(ego, nei, g, L, W, nL, m)
        bwd_p = lambda: ck.min_clearance_bwd_plain(ego, nei, g, L, W, nL, m)
        out, d = fwd(), bwd()
        ref, dref = fwd_p(), bwd_p()
        torch.cuda.synchronize()
        per = ref[ref < 100]
        log(f"clearance inputs {name}: n={n} ({n // m} neighbor sets x {m} "
            f"rows) K={nei.shape[1]} T={cfg.nt} "
            f"nL={nL}; clearances in [{float(per.min()):.3f}, "
            f"{float(per.max()):.3f}], {float((ref == 20).float().mean()):.3f}"
            f" clipped at 20, {float((ref == 100).float().mean()):.4f} "
            f"without a valid neighbor")
        worst["fwd"] = max(worst["fwd"], clearance_check(
            f"clearance forward ({name})", out, ref, CLEAR_FWD_RTOL))
        worst["bwd"] = max(worst["bwd"], clearance_check(
            f"clearance backward ({name})", d, dref, CLEAR_BWD_RTOL,
            clearance_near_ties(ego, nei, L, W, nL, CLEAR_TIE_M, m)))
        if float(d.abs().max()) <= 0:
            raise RuntimeError(f"clearance backward ({name}) is all zero")
        if name != "e2 step":
            log(f"clearance times ({name} inputs, a neighbor set per row): "
                f"forward {time_kernel(fwd):.4f} ms, backward "
                f"{time_kernel(bwd):.4f} ms (graph replay)")
            continue
        # the function's own operands, each once: the neighbors per scene
        for k, call, plain, operands in (("fwd", fwd, fwd_p, (ego, nei, out)),
                                         ("bwd", bwd, bwd_p,
                                          (ego, nei, g, d))):
            n_bytes = nbytes(*operands)
            ops = clearance_ops(n, nei.shape[1], cfg.nt, nL, k == "bwd", m)
            ms, plain_ms, bnd = res[k] = (kernel_ms(call), time_cuda(plain),
                                          bound(n_bytes, ops))
            log(f"clearance {k} times (e2 step inputs, n={n}): kernel "
                f"{ms['graph_ms']:.4f} ms (graph replay), one eager call "
                f"{ms['ms']:.4f} ms, plain {plain_ms:.4f} ms (median of "
                f"20); bound {bnd[0]:.5f} ms ({bnd[1]}): {n_bytes} bytes, "
                f"{n_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms at 3.35 TB/s; "
                f"{ops} float32 operations, "
                f"{ops / OPS_PER_S['float32'] * 1e3:.5f} ms at 67 TFLOP/s "
                f"(a peak of fused multiply-adds, which the kernels' "
                f"product-by-product rounding cannot use)")
    log(f"clearance: phase wall {time.time() - t0:.1f} s")
    return {k: (worst[k],) + v for k, v in res.items()}


def grad_err(ga, gb):
    """The largest gradient difference, each tensor's over its largest
    entry."""
    return max(float((ga[k] - gb[k]).abs().max())
               / max(float(gb[k].abs().max()), 1e-30) for k in gb)


def mono_reference_phase(dev, swerve=False, what="mono reference step",
                         **kw):
    """Phase 14: one fp32 e2 train step with stl_weight 1 on the card
    (kernels) against the CPU (plain versions), same parameters, batch and
    draws, on scenes where the safety clause binds: the metrics, every
    parameter's gradient and the backward kernel's own output, d ego.  A
    third step, on the card with that output zeroed, shows how far the
    parameter gradients alone can see the backward kernel.  Phase 36 runs
    it with ``gt_nei=False`` (``kw``: config overrides) on the
    ``swerving_neighbor`` scenes (``swerve``)."""
    import copy
    import numpy as np
    import torch
    from pstl_tpu_torch import diffusion, specs, train
    from pstl_tpu_torch.config import mono_config
    from pstl_tpu_torch.data.dataset import SceneDataset
    from pstl_tpu_torch.ops import clearance_kernel as ck

    cfg = mono_config("e2_vae_mono", stl_weight=1.0, compute_dtype="float32",
                      batch_size=16, **kw)
    ds = SceneDataset.from_synthetic(cfg, seed=3, n_scenes=cfg.batch_size)
    batch = straight_scenes(ds.gather(np.arange(cfg.batch_size)), cfg)
    if swerve:
        batch = swerving_neighbor(batch, cfg)
    net_cpu = mono_net(cfg, "cpu")
    with torch.no_grad():   # a near-zero control head: near-straight rollouts
        net_cpu.policy_net.layers[-1].weight.mul_(0.01)
    n = cfg.batch_size * cfg.n_randoms
    noise = torch.randn((n, cfg.vae_dim),
                        generator=torch.Generator().manual_seed(4))
    real_bwd = ck.min_clearance_bwd

    def run(d, zero_vjp=False):
        seen = []

        def record(ego, nei, g, *a):
            d_ego = real_bwd(ego, nei, g, *a)
            if zero_vjp:
                d_ego = torch.zeros_like(d_ego)
            seen.append(tuple(x.detach().cpu() for x in (ego, nei, g, d_ego))
                        + (a[-1],))
            return d_ego

        net = copy.deepcopy(net_cpu).to(d)
        opt = train.make_optimizer(cfg, net)
        step = train.make_train_step(cfg, net, specs.build_scorer(cfg),
                                     diffusion.get_coeffs(cfg, device=d), opt)
        reset_counts()
        ck.min_clearance_bwd = record
        try:
            rd = step(train.to_device(batch, d),
                      draws={"vae_noise": noise.to(d)})
        finally:
            ck.min_clearance_bwd = real_bwd
        if d != "cpu":
            torch.cuda.synchronize()
            if not zero_vjp:
                check_counts(read_counts(), {"min_clearance_fwd": 1,
                                             "min_clearance_bwd": 1}, what)
        if len(seen) != 1:
            raise RuntimeError(f"{what}: {len(seen)} clearance VJP calls, "
                               f"expected 1")
        return ({k: float(v) for k, v in rd.items()},
                {k: p.grad.detach().cpu() for k, p in net.named_parameters()},
                seen[0])

    m_cpu, g_cpu, (ego, nei, cot, d_cpu, rows) = run("cpu")
    m_dev, g_dev, (ego_dev, _, cot_dev, d_dev, _) = run(dev)
    _, g_zero, _ = run(dev, zero_vjp=True)
    if not float(cot.abs().max()) > 0 or not float(d_cpu.abs().max()) > 0:
        raise RuntimeError("the clearance VJP got or gave a zero cotangent")
    m_err = max(abs(m_dev[k] - m_cpu[k]) / (abs(m_cpu[k]) + 1e-6)
                for k in m_cpu)
    g_err = grad_err(g_dev, g_cpu)
    zero_err = grad_err(g_zero, g_cpu)
    ego_diff = float((ego_dev - ego).abs().max())
    d_scale = float(d_cpu.abs().max())
    log(f"{what} (e2, fp32, stl_weight 1, gt_nei {cfg.gt_nei}, "
        f"{cfg.batch_size} scenes x {cfg.n_randoms}): card loss {m_dev['loss']:.6f} vs cpu "
        f"{m_cpu['loss']:.6f}; worst metric rel err {m_err:.3e} (tolerance "
        f"{MONO_RTOL}); worst gradient err {g_err:.3e} of its tensor's "
        f"largest entry (tolerance {MONO_GRAD_TOL}; {zero_err:.3e} with the "
        f"backward kernel's output zeroed); clearance cotangent "
        f"max |g| card {float(cot_dev.abs().max()):.3e}, cpu "
        f"{float(cot.abs().max()):.3e}; its inputs differ by {ego_diff:.3e} m")
    if not (m_err <= MONO_RTOL and g_err <= MONO_GRAD_TOL):
        raise RuntimeError(f"{what}: card and cpu mono train steps "
                           f"disagree")
    if not ego_diff <= MONO_TIE_M / 10:
        raise RuntimeError("the backward kernel's inputs differ between card "
                           "and cpu beyond its near-tie margin")
    clearance_check(
        f"{what}: backward kernel output (card vs cpu)", d_dev, d_cpu,
        MONO_GRAD_TOL, clearance_near_ties(ego, nei, cfg.ego_L, cfg.ego_W,
                                           cfg.refined_nL, MONO_TIE_M, rows),
        atol=MONO_GRAD_TOL * d_scale, max_share=MONO_MAX_OFF_SHARE)


def check_finite(vals, what):
    import math
    for k, v in vals.items():
        if not math.isfinite(v):
            raise RuntimeError(f"{what}: {k} = {v} is not finite")


def step_loop(dev, cfg, ds, steps, what):
    """``steps`` train steps of a fresh net on ``ds``'s first train
    batches, counted and timed; returns (counts, median step s)."""
    import torch
    from pstl_tpu_torch import diffusion, specs, train
    from pstl_tpu_torch.data.dataset import batch_iterator

    net = mono_net(cfg, dev, seed=1)
    opt = train.make_optimizer(cfg, net)
    step = train.make_train_step(cfg, net, specs.build_scorer(cfg),
                                 diffusion.get_coeffs(cfg, device=dev), opt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    batches = batch_iterator(ds, "train", cfg.batch_size, shuffle=False)
    torch.cuda.synchronize()
    reset_counts()
    step_s = []
    for _ in range(steps):
        batch = train.to_device(next(batches), dev)
        t0 = time.time()
        rd = step(batch, generator=gen)
        vals = {k: float(v) for k, v in rd.items()}
        step_s.append(time.time() - t0)
        check_finite(vals, what)
    counts = read_counts()
    log(f"{what}: {steps} steps, launches={counts}, last "
        + " ".join(f"{k}={v:.4f}" for k, v in sorted(vals.items()))
        + f" (median step {median(step_s) * 1e3:.1f} ms, first "
        f"{step_s[0] * 1e3:.1f} ms)")
    return counts, median(step_s)


def mono_train_phase(dev):
    """Phase 15: one e2 epoch through ``train.train``, then train steps of
    the stl_weight 1 variant and of e4; returns the e2 epoch's clearance
    launches (the main path's), the dataset and the e2 epoch's net (the
    vae_mono row of phase 27)."""
    import torch
    from pstl_tpu_torch import train
    from pstl_tpu_torch.config import mono_config
    from pstl_tpu_torch.data.dataset import SceneDataset

    t0 = time.time()
    cfg = mono_config("e2_vae_mono")
    ds = SceneDataset.from_synthetic(cfg, seed=0, n_scenes=TRAIN_SCENES)
    n_train = ds.split_len("train") // cfg.batch_size
    n_val = ds.split_len("val") // cfg.batch_size
    log(f"mono data: {TRAIN_SCENES} synthetic scenes in "
        f"{time.time() - t0:.1f} s; {n_train} train and {n_val} val batches "
        f"of {cfg.batch_size} scenes x {cfg.n_randoms}")
    hist = []
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.time()
    e2 = train.train(cfg, ds, epochs=1, device=dev, log=log, history=hist)
    torch.cuda.synchronize()
    wall = time.time() - t1
    counts = read_counts()
    check_counts(counts, {"min_clearance_fwd": n_train + n_val,
                          "min_clearance_bwd": n_train}, "e2 epoch")
    if [m for _, m, _ in hist] != ["train"] * n_train + ["val"] * n_val:
        raise RuntimeError("e2 epoch: wrong batches")
    for epi, mode, vals in hist:
        check_finite(vals, f"e2 epoch {mode}")
    nb = n_train + n_val
    log(f"e2 epoch (train.train, bf16): launches={counts}, wall {wall:.2f} "
        f"s for {nb} batches ({wall / nb * 1e3:.1f} ms a batch)")
    main_counts = dict(counts)
    c1, e2_step = step_loop(dev, cfg.with_(stl_weight=1.0), ds,
                            E2_EXTRA_STEPS, "e2 stl_weight 1 train steps")
    check_counts(c1, {"min_clearance_fwd": E2_EXTRA_STEPS,
                      "min_clearance_bwd": E2_EXTRA_STEPS},
                 "e2 stl_weight 1 train steps")
    c4, e4_step = step_loop(dev, mono_config("e4_ddpm_mono"), ds, E4_STEPS,
                            "e4 train steps")
    check_counts(c4, {"min_clearance_fwd": E4_STEPS}, "e4 train steps")
    log(f"mono training: median train step e2 {e2_step * 1e3:.1f} ms, e4 "
        f"{e4_step * 1e3:.1f} ms; phase wall {time.time() - t0:.1f} s")
    return main_counts, ds, e2.net


# --------------------------------------------------------------------------
# the dense training step (phases 16-18)
# --------------------------------------------------------------------------

def dense_config(preset, **kw):
    """A dense preset as this script runs it: no experiment directory."""
    from pstl_tpu_torch.config import PRESETS
    return PRESETS[preset].with_(exp_name=None, **kw)


def dense_net(cfg, dev, seed=0, warm=False):
    """A flax-like initialised net of ``cfg``; with ``warm`` the committed
    e5b_round5 base loaded over it (``train.load_params_only``), the
    RefineNet head left as initialised."""
    from pstl_tpu_torch import train
    from pstl_tpu_torch.models import convert
    net = mono_net(cfg, "cpu", seed)
    if warm:
        train.load_params_only(
            os.path.join(convert.WEIGHTS_DIR, "e5b_round5.npz"),
            train.TrainState(net, None, 0))
    return net.to(dev)


def with_gt_seed(batch, cfg):
    """A numpy batch whose control seed 0 holds the GT controls (finite
    differences of the GT speed and heading) for every maneuver: the
    labelled maneuver's row then satisfies its calibrated spec, as a
    trajopt target does, and the eps-MSE (``stl_bc_mask``) keeps it."""
    import numpy as np
    b = dict(batch)
    ego = b["ego_traj"]
    u = (ego[:, 1:, 2:4] - ego[:, :-1, 2:4]) / cfg.dt
    b["params"] = b["params"].copy()
    b["params"][:, 0] = np.concatenate([u, u[:, -1:]], 1)[:, None]
    return b


def dense_draws(cfg, bs, seed):
    """Every draw of one dense train step of ``bs`` scenes, seeded, on the
    CPU: the flex uniforms, prep's noise and steps, the sampler's chain and,
    for the VAE, its latent noise."""
    import torch
    from pstl_tpu_torch import specs
    g = torch.Generator().manual_seed(seed)
    n = bs * cfg.n_randoms * 3
    return {"flex": specs.flex_uniforms(bs, g),
            "prep_noise": torch.randn((n, cfg.nt * 2), generator=g),
            "prep_t": torch.randint(1, cfg.diffusion_steps, (n,),
                                    generator=g),
            "sample_noise": torch.randn(
                (cfg.diffusion_steps, n, cfg.nt * 2), generator=g),
            **({"vae_noise": torch.randn((n, cfg.vae_dim), generator=g)}
               if cfg.vae else {})}


def dense_step(cfg, net, batch, draws, dev):
    """One train step of a copy of ``net`` on ``dev``: (metrics, every
    parameter's gradient on the CPU, zero where the loss does not reach
    it)."""
    import copy
    import torch
    from pstl_tpu_torch import diffusion, specs, train
    net = copy.deepcopy(net).to(dev)
    step = train.make_train_step(cfg, net, specs.build_scorer(cfg),
                                 diffusion.get_coeffs(cfg, device=dev),
                                 train.make_optimizer(cfg, net))
    rd = step(train.to_device(batch, dev),
              draws={k: v.to(dev) for k, v in draws.items()})
    return ({k: float(v) for k, v in rd.items()},
            {k: (torch.zeros_like(p) if p.grad is None else p.grad
                 ).detach().cpu() for k, p in net.named_parameters()})


#: phase 16's steps: (name, preset, overrides).  e7 with the STL hinge on:
#: at a fresh RefineNet head no row turns from violating to satisfying, so
#: the DPP loss alone reaches no parameter
DENSE_REF = (("e5_ddpm", "e5_ddpm", {}),
             ("e7_ours", "e7_ours", {"stl_weight": 1.0}))


def dense_reference_phase(dev, steps=DENSE_REF, what="dense reference"):
    """Phase 16 (and 25 with the baselines' ``steps``): one fp32 train step
    of each (name, preset, overrides) on the card against the same step on
    the CPU, same weights (flax-like from a seed; e7 warm-started from
    e5b_round5), batch and draws, DENSE_REF_SCENES scenes x 64 x 3 rows:
    every metric, every gradient; no kernel launches."""
    import numpy as np
    import torch
    from pstl_tpu_torch.data.dataset import SceneDataset

    t0 = time.time()
    for name, preset, kw in steps:
        cfg = dense_config(preset, compute_dtype="float32",
                           batch_size=DENSE_REF_SCENES, **kw)
        ds = SceneDataset.from_synthetic(cfg, seed=5, n_scenes=cfg.batch_size)
        ds.ensure_random_params(cfg.seed)
        batch = with_gt_seed(ds.gather(np.arange(cfg.batch_size)), cfg)
        net = dense_net(cfg, "cpu", seed=2, warm=cfg.rect_head)
        draws = dense_draws(cfg, cfg.batch_size, seed=6)
        m_cpu, g_cpu = dense_step(cfg, net, batch, draws, "cpu")
        torch.cuda.synchronize()
        reset_counts()
        m_dev, g_dev = dense_step(cfg, net, batch, draws, dev)
        torch.cuda.synchronize()
        check_counts(read_counts(), {}, f"{name} reference step")
        m_err = max(abs(m_dev[k] - m_cpu[k]) / (abs(m_cpu[k]) + 1e-6)
                    for k in m_cpu)
        g_err = grad_err(g_dev, g_cpu)
        log(f"{what} step ({name}, fp32, {cfg.batch_size} scenes x "
            f"{cfg.n_randoms * 3} rows): card loss {m_dev['loss']:.6f} vs "
            f"cpu {m_cpu['loss']:.6f}; worst metric rel err {m_err:.3e} "
            f"(tolerance {DENSE_RTOL}); worst gradient err {g_err:.3e} of "
            f"its tensor's largest entry (tolerance {DENSE_GRAD_TOL}); "
            f"kernel launches 0; "
            + " ".join(f"{k}={v:.5f}" for k, v in sorted(m_dev.items())))
        if not (m_err <= DENSE_RTOL and g_err <= DENSE_GRAD_TOL):
            raise RuntimeError(f"card and cpu {name} train steps disagree")
    log(f"{what}: phase wall {time.time() - t0:.1f} s")


def dense_loop(dev, cfg, net, ds, steps, what):
    """``steps`` train steps of ``net`` on ``ds``'s first train batches and
    an eval step on its first val batch, every draw from a generator seeded
    with ``cfg.seed``; no kernel may launch.  Returns the median step s and
    the last step's metrics."""
    import torch
    from pstl_tpu_torch import diffusion, specs, train
    from pstl_tpu_torch.data.dataset import batch_iterator

    formulas = specs.build_scorer(cfg)
    coeffs = diffusion.get_coeffs(cfg, device=dev)
    step = train.make_train_step(cfg, net, formulas, coeffs,
                                 train.make_optimizer(cfg, net))
    eval_step = train.make_eval_step(cfg, net, formulas, coeffs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    batches = batch_iterator(ds, "train", cfg.batch_size, shuffle=False)
    torch.cuda.synchronize()
    reset_counts()
    step_s = []
    for _ in range(steps):
        batch = train.to_device(next(batches), dev)
        t0 = time.time()
        vals = {k: float(v) for k, v in step(batch, generator=gen).items()}
        step_s.append(time.time() - t0)
        check_finite(vals, what)
    ev = {k: float(v) for k, v in eval_step(train.to_device(next(
        batch_iterator(ds, "val", cfg.batch_size, shuffle=False)), dev),
        generator=gen).items()}
    check_finite(ev, what + " eval")
    check_counts(read_counts(), {}, what)
    log(f"{what}: {steps} steps of {cfg.batch_size} scenes x "
        f"{cfg.n_randoms * 3} rows, last "
        + " ".join(f"{k}={v:.4f}" for k, v in sorted(vals.items()))
        + "; eval " + " ".join(f"{k}={v:.4f}" for k, v in sorted(ev.items()))
        + f" (median step {median(step_s) * 1e3:.1f} ms, first "
        f"{step_s[0] * 1e3:.1f} ms); stl_bc_mask keeps {vals['tj_acc']:.4f} "
        f"of the valid rows")
    return median(step_s), vals


def dense_train_phase(dev, ds, name_power):
    """Phase 17: e5_ddpm train steps at full width from a seed, then
    e7_ours warm-started from e5b_round5: train steps and an eval step;
    every parameter outside the RefineNet head must stay as it was, bit
    for bit.  ``ds``: phase 15's 1,500 synthetic scenes."""
    import torch
    from pstl_tpu_torch import train

    t0 = time.time()
    cfg5 = dense_config("e5_ddpm")
    # GT controls in seed 0, so the eps-MSE has rows to keep (the JAX
    # package's trajopt sidecars are not ported)
    ds.attach("params", with_gt_seed(ds.data, cfg5)["params"])
    e5, _ = dense_loop(dev, cfg5, dense_net(cfg5, dev, seed=1), ds,
                       E5_STEPS, "e5 train steps")
    cfg7 = dense_config("e7_ours")
    net = dense_net(cfg7, dev, seed=1, warm=True)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    e7, _ = dense_loop(dev, cfg7, net, ds, E7_STEPS, "e7 train steps")
    moved = sorted({k.split(".")[0] for k, v in net.state_dict().items()
                    if not torch.equal(v, before[k])})
    if any(m not in train.RECT_MODULES for m in moved):
        raise RuntimeError(f"e7 steps moved {moved}, expected the "
                           f"RefineNet head only")
    # the DPP loss reaches the head only through rows it turns from
    # violating to satisfying; at a fresh head there may be none
    head_grad = max(float(p.grad.abs().max()) for k, p in
                    net.named_parameters()
                    if k.split(".")[0] in train.RECT_MODULES
                    and p.grad is not None)
    log(f"dense training: median train step e5 {e5 * 1e3:.1f} ms, e7 "
        f"{e7 * 1e3:.1f} ms ({cfg7.batch_size} scenes x "
        f"{cfg7.n_randoms * 3} rows, {cfg7.diffusion_steps - 1} denoise "
        f"steps; {name_power}); modules moved by e7: {moved}, the head's "
        f"largest gradient in its last step {head_grad:.3e}; phase wall "
        f"{time.time() - t0:.1f} s")


def dense_checkpoint_phase(dev, ds, preset="e7_ours"):
    """Phase 18 (and 26 with ``e6_trafficsim``): two train steps, a
    checkpoint, a fresh net and Adam loaded from it (parameters, moments
    and step count equal bit for bit), then one more step from each on the
    same batch and draws.  e7 is warm-started from e5b_round5."""
    import shutil
    import torch
    from pstl_tpu_torch import diffusion, specs, train
    from pstl_tpu_torch.data.dataset import batch_iterator

    t0 = time.time()
    cfg = dense_config(preset)
    formulas = specs.build_scorer(cfg)
    coeffs = diffusion.get_coeffs(cfg, device=dev)

    def state_of(net):
        return train.TrainState(net, train.make_optimizer(cfg, net), 0)

    state = state_of(dense_net(cfg, dev, seed=3, warm=cfg.rect_head))
    batches = [train.to_device(b, dev) for _, b in zip(
        range(3), batch_iterator(ds, "train", cfg.batch_size, shuffle=False))]
    step = train.make_train_step(cfg, state.net, formulas, coeffs, state.opt)
    for i in range(2):
        step(batches[i], draws={k: v.to(dev) for k, v in dense_draws(
            cfg, cfg.batch_size, 10 + i).items()})
    state = state._replace(step=2)
    ckpt_dir = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    path = train.save_checkpoint(ckpt_dir, state, 0)
    loaded = train.load_checkpoint(ckpt_dir, state_of(dense_net(
        cfg, dev, seed=4)))
    if loaded.step != 2:
        raise RuntimeError(f"checkpoint step {loaded.step}, expected 2")
    for (k, a), b in zip(state.net.state_dict().items(),
                         loaded.net.state_dict().values()):
        if not torch.equal(a, b):
            raise RuntimeError(f"checkpoint parameter {k} differs")
    n_moments = 0
    for pa, pb in zip(state.opt.param_groups[0]["params"],
                      loaded.opt.param_groups[0]["params"]):
        sa, sb = state.opt.state[pa], loaded.opt.state[pb]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            if not torch.equal(sa[key].cpu(), sb[key].cpu()):
                raise RuntimeError(f"checkpoint Adam {key} differs")
        n_moments += 2
    draws = {k: v.to(dev) for k, v in dense_draws(cfg, cfg.batch_size,
                                                  12).items()}
    out = []
    for st in (state, loaded):
        rd = train.make_train_step(cfg, st.net, formulas, coeffs, st.opt)(
            batches[2], draws=draws)
        out.append({k: float(v) for k, v in rd.items()})
        check_finite(out[-1], "step after the checkpoint")
    p_diff = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(
        state.net.parameters(), loaded.net.parameters()))
    m_diff = max(abs(out[0][k] - out[1][k]) for k in out[0])
    log(f"{preset} checkpoint: {os.path.getsize(path)} bytes, parameters, "
        f"{n_moments} Adam moments and the step count equal bit for bit "
        f"after loading into a fresh net; the next step from both: metrics "
        f"differ by {m_diff:.3e}, parameters by {p_diff:.3e} (tolerance "
        f"{DENSE_RESUME_TOL}); phase wall {time.time() - t0:.1f} s")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not (m_diff <= DENSE_RESUME_TOL and p_diff <= DENSE_RESUME_TOL):
        raise RuntimeError("the step after the checkpoint differs")


# --------------------------------------------------------------------------
# the augmentation and the open-loop evaluation (phases 19-22)
# --------------------------------------------------------------------------

def e1_config(**kw):
    """``e1_trajopt`` as this script runs it: no experiment directory."""
    from pstl_tpu_torch.config import PRESETS
    return PRESETS["e1_trajopt"].with_(exp_name=None, **kw)


def e1_batches(n, batch_size):
    """The sample indices of ``trajopt.augment_dataset``'s batches, the last
    padded as it pads it."""
    import numpy as np
    out = []
    for i0 in range(0, n, batch_size):
        idx = np.arange(i0, min(i0 + batch_size, n))
        if len(idx) < batch_size:
            idx = np.concatenate([idx, idx[:batch_size - len(idx)]])
        out.append(idx)
    return out


def trajopt_inputs(cfg, batch, draws, dev):
    """``optimize``'s inputs for a numpy batch as ``augment_dataset`` makes
    them from one batch's ``draws`` (``trajopt.batch_draws``): (params0,
    states, signal_base, highlevel, stlp_draws, valid) on ``dev``."""
    import torch
    from pstl_tpu_torch import specs, train
    b = train.to_device(batch, dev)
    b["neighbor_trajs_aug"] = b["neighbors_traj"]
    gt = b["ego_traj"][..., :4]
    cflex = cfg.with_(flex=True)
    with torch.no_grad():
        stlp = specs.calibrate_stlp(b, gt, cflex)
        dense = specs.densify_batch(b, stlp, cflex,
                                    flex=draws["densify"].to(dev))
        sb = specs.dense_signal_input(dense, cfg=cfg)
        stack = torch.stack([dense["stlp_dense"]] + [
            specs.get_dense_stlp(b["gt_high_level"], stlp, cflex,
                                 flex=f.to(dev)) for f in draws["extra"]])
    return (b["params"], gt[:, 0], sb, dense["highlevel_dense"], stack,
            dense["valids_dense"].reshape(-1))


def valid_rate(scores, valid):
    """The valid-masked satisfaction of ``augment_dataset``'s stats."""
    sat = (scores.reshape(-1) > 0).float() * valid
    return float(sat.sum() / max(float(valid.sum()), 1.0))


def share_beyond(got, ref, atol, what):
    """Share of elements of ``got`` beyond ``atol`` of ``ref``, and the max
    error (both logged)."""
    err = (got - ref).abs()
    share = float((err > atol).float().mean())
    log(f"{what}: max_abs_err={float(err.max()):.3e}, beyond {atol}: "
        f"{int((err > atol).sum())} of {err.numel()} (share {share:.2e})")
    return share, float(err.max())


def trajopt_reference_phase(dev, ds):
    """Phase 19: ``optimize`` on the card against the CPU, same seeds and
    draws: TRAJOPT_REF_SCENES scenes x 64 x 3 rows, K = 4, 20 iterations,
    fp32, the GT controls in seed 0; one ``trajopt_loss`` gradient first.
    No kernel may launch (the loss's clearance is the "discs" route)."""
    import torch
    from pstl_tpu_torch import specs, trajopt

    t0 = time.time()
    cfg = e1_config()
    K, M, nt = cfg.trajopt_robust_draws, cfg.n_randoms, cfg.nt
    batch = with_gt_seed(ds.gather(list(range(TRAJOPT_REF_SCENES))), cfg)
    draws = trajopt.batch_draws(TRAJOPT_REF_SCENES, K,
                                torch.Generator().manual_seed(7))
    form = specs.build_scorer(cfg)
    out = {}
    for d in ("cpu", dev):
        p0, st, sb, hl, stack, valid = trajopt_inputs(cfg, batch, draws, d)
        x = p0.reshape(-1, nt, 2).clone().requires_grad_(True)
        loss, _ = trajopt.trajopt_loss(
            x, torch.repeat_interleave(st, M * 3, 0), sb, hl, form, cfg,
            tau=30.0, stlp_draws=stack)
        g, = torch.autograd.grad(loss, x)
        if d != "cpu":
            torch.cuda.synchronize()
            reset_counts()
        p, sc, _ = trajopt.optimize(p0, st, sb, hl, form, cfg,
                                    iters=TRAJOPT_REF_ITERS,
                                    stlp_draws=stack)
        if d != "cpu":
            torch.cuda.synchronize()
            check_counts(read_counts(), {}, "trajopt reference")
        out[str(d)] = (float(loss.detach()), g.cpu(), p.cpu(), sc.cpu(),
                       valid.cpu(),
                       p0.cpu())
    (l_c, g_c, p_c, s_c, v_c, p0), (l_d, g_d, p_d, s_d, _, _) = (
        out["cpu"], out[str(dev)])
    l_err = abs(l_d - l_c) / abs(l_c)
    g_err = grad_err({"g": g_d}, {"g": g_c})
    log(f"trajopt reference (e1, fp32, {TRAJOPT_REF_SCENES} scenes x {M} x "
        f"3, K={K}): loss card {l_d:.6f} vs cpu {l_c:.6f} (rel err "
        f"{l_err:.3e}, tolerance {MONO_RTOL}); gradient err {g_err:.3e} of "
        f"its largest entry (tolerance {DENSE_GRAD_TOL})")
    p_share, _ = share_beyond(p_d, p_c, TJ_PARAM_ATOL,
                              f"trajopt reference params after "
                              f"{TRAJOPT_REF_ITERS} iterations")
    s_share, _ = share_beyond(s_d, s_c, TJ_SCORE_ATOL,
                              "trajopt reference final scores")
    moved = float((p_c - p0).abs().max())
    log(f"trajopt reference: controls moved up to {moved:.3f}; valid-masked "
        f"satisfaction card {valid_rate(s_d, v_c):.4f}, cpu "
        f"{valid_rate(s_c, v_c):.4f}; phase wall {time.time() - t0:.1f} s")
    if not (l_err <= MONO_RTOL and g_err <= DENSE_GRAD_TOL
            and p_share <= TJ_MAX_OFF_SHARE and s_share <= TJ_MAX_OFF_SHARE
            and moved > 0):
        raise RuntimeError("card and cpu trajopt disagree")


def profile_calls(fn, n):
    """Device launches, device ms, wall ms and {kernel: device ms} a call of
    ``fn``, over ``n`` calls under ``torch.profiler`` (kernels as
    ``scripts/profile_torch_step.py`` counts them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches = busy_us = 0
    by_name = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            launches += e.count
            busy_us += us
            by_name[e.key] = us / 1e3 / n
    return launches / n, busy_us / 1e3 / n, wall / n, by_name


def e1_phase(dev, ds, name_power):
    """Phase 20: ``augment_dataset`` at the preset's full width over phase
    15's scenes (their own random seeds), E1_ITERS iterations; the seeds'
    satisfaction before, the launches and device time of an iteration
    (profiled apart), peak memory; then the store's save / load round trip
    and E5_STEPS ``e5_ddpm`` steps on it.  Returns the loaded store."""
    import numpy as np
    import torch
    from pstl_tpu_torch import specs, trajopt
    from pstl_tpu_torch.data.dataset import SceneDataset

    t0 = time.time()
    cfg = e1_config()
    K, M, nt = cfg.trajopt_robust_draws, cfg.n_randoms, cfg.nt
    store = SceneDataset(
        {**{k: v for k, v in ds.data.items()
            if k not in SceneDataset.TRAJOPT_COLUMNS}, **ds.scene_data}, cfg)
    n = len(store)
    batches = e1_batches(n, cfg.batch_size)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    draws = [trajopt.batch_draws(len(idx), K, gen, dev) for idx in batches]
    iter_s, mark = [], [None]

    def on_iter(i):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if i > 0:
            iter_s.append(now - mark[0])
        mark[0] = now

    form = specs.build_scorer(cfg)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    trajopt.augment_dataset(store, cfg, form, batch_size=cfg.batch_size,
                            iters=E1_ITERS, seed=cfg.seed, draws=draws,
                            device=dev, log=log, on_iter=on_iter)
    torch.cuda.synchronize()
    wall = time.time() - t1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_counts(read_counts(), {}, "e1 augmentation")
    cols = {"params": (n, M, 3, nt, 2), "tj_scores_prior": (n, M, 3),
            "pre_stlp": (n, M, 3, 1, 6)}
    for k, shape in cols.items():
        v = store.data[k]
        if v.shape != shape or not np.isfinite(v).all():
            raise RuntimeError(f"e1 column {k}: shape {v.shape} (expected "
                               f"{shape}) or not finite")
    # the seeds' own satisfaction: params_init under the same draws
    accs0, first = [], None
    for idx, d in zip(batches, draws):
        b = store.gather(idx)
        b["params"] = b["params_init"]
        p0, st, sb, hl, stack, valid = trajopt_inputs(cfg, b, d, dev)
        with torch.no_grad():
            _, aux = trajopt.trajopt_loss(
                p0.reshape(-1, nt, 2), torch.repeat_interleave(st, M * 3, 0),
                sb, hl, form, cfg)
        accs0.append(valid_rate(aux["scores"], valid))
        first = first or (p0, st, sb, hl, stack)
    acc0 = float(np.mean(accs0))
    stats = store.trajopt_stats
    one = lambda iters: lambda: trajopt.optimize(
        *first[:4], form, cfg, iters=iters, stlp_draws=first[4])
    prof = {k: profile_calls(one(k), 2) for k in (1, 4)}
    launches = (prof[4][0] - prof[1][0]) / 3
    dev_ms = (prof[4][1] - prof[1][1]) / 3
    top = sorted(((prof[4][3].get(k, 0.0) - prof[1][3].get(k, 0.0)) / 3, k)
                 for k in prof[4][3])[::-1][:TOP_KERNELS]
    med = median(iter_s) * 1e3
    log(f"e1 augmentation ({n} scenes in {len(batches)} batches of "
        f"{cfg.batch_size} x {M} x 3 = {cfg.batch_size * M * 3} rows, the "
        f"last padded to {len(batches[-1])} scenes; K={K}; {E1_ITERS} of "
        f"the preset's {cfg.traj_opt_iters} iterations): median iteration "
        f"{med:.2f} ms (host clock + sync, {len(iter_s)} iterations; first "
        f"{iter_s[0] * 1e3:.2f} ms), {launches:.0f} device launches and "
        f"{dev_ms:.2f} device ms an iteration (profiled apart, busy "
        f"{dev_ms / ((prof[4][2] - prof[1][2]) / 3):.3f} of its "
        f"wall); peak device memory {peak:.2f} GiB; wall {wall:.1f} s; "
        f"{cfg.traj_opt_iters} iterations would take "
        f"{med * cfg.traj_opt_iters / 1e3:.1f} s a batch; {name_power}")
    log("e1 iteration's device time by kernel (ms): " + "; ".join(
        f"{ms:.2f} {name[:70]}" for ms, name in top))
    log(f"e1 oracle after {E1_ITERS} iterations: acc_seen "
        f"{stats['acc_seen']:.4f}, acc_fresh {stats['acc_fresh']:.4f}; the "
        f"random seeds before optimizing {acc0:.4f} (same draws)")
    if not stats["acc_seen"] > acc0:
        raise RuntimeError("the augmentation did not raise satisfaction")

    path = os.path.join(HERE, "build", "chip_smoke_store", "e1.npz")
    t2 = time.time()
    store.save(path)
    cfg5 = dense_config("e5_ddpm")
    loaded = SceneDataset.load(path, cfg5)
    for k in SceneDataset.TRAJOPT_COLUMNS:
        if not np.array_equal(loaded.data[k], store.data[k]):
            raise RuntimeError(f"store round trip: column {k} differs")
    for k in store.splits:
        if not np.array_equal(loaded.splits[k], store.splits[k]):
            raise RuntimeError(f"store round trip: split {k} differs")
    log(f"e1 store: saved and loaded in {time.time() - t2:.1f} s "
        f"({os.path.getsize(path) / 2 ** 20:.1f} MiB), columns and split "
        f"equal to the bit")
    _, vals = dense_loop(dev, cfg5, dense_net(cfg5, dev, seed=1), loaded,
                         E5_STEPS, "e5 train steps on the augmented store")
    log(f"e5 on the augmented store: stl_bc_mask keeps {vals['tj_acc']:.4f} "
        f"of the valid rows (0.0064 with one GT seed a scene, PR 7's "
        f"phase 17); phase wall {time.time() - t0:.1f} s")
    return loaded


def eval_config(preset, **kw):
    """An evaluation preset as ``eval_openloop.run`` finalizes it."""
    from pstl_tpu_torch.config import PRESETS
    return PRESETS[preset].with_(exp_name=None, **kw).with_(
        run_sampling_test=True).finalize()


def e7_net(cfg, dev):
    """The e7_round5 weights (strict) in a net of ``cfg`` on ``dev``."""
    from pstl_tpu_torch.models import convert
    from pstl_tpu_torch.models.net import Net
    net = Net(cfg)
    convert.load_weights(net, "e7_round5")
    return net.to(dev).eval()


def eval_reference_phase(dev, store):
    """Phase 21: the oracle row, the timed region and the metric tail of
    EVAL_REF_SCENES val scenes on the card against the CPU, fp32, guided
    (``ours_guidance`` + ``guidance_pallas_fuse_freeze``), the same draws
    and pinned sampler noise: scores within EVAL_SCORE_ATOL on all but
    EVAL_MAX_OFF_SHARE of the rows; the counts of satisfying rows may differ
    only by the rows off or within the tolerance of 0."""
    import torch
    from pstl_tpu_torch import diffusion, eval_openloop, specs, train

    t0 = time.time()
    cfg = eval_config("ours_guidance", guidance_pallas_fuse_freeze=True,
                      compute_dtype="float32", batch_size=EVAL_REF_SCENES)
    batch = store.gather(store.splits["val"][:EVAL_REF_SCENES])
    g = torch.Generator().manual_seed(9)
    tj_flex = specs.flex_uniforms(EVAL_REF_SCENES, g)
    flex = specs.flex_uniforms(EVAL_REF_SCENES, g)
    noise = torch.randn((cfg.diffusion_steps,) + eval_openloop.sampler_shape(
        cfg, EVAL_REF_SCENES), generator=g)
    guided = int(diffusion._trigger_schedule(cfg).sum())
    res = {}
    for d in ("cpu", dev):
        net = e7_net(cfg, d)
        b = train.to_device(batch, d)
        form = specs.build_scorer(cfg)
        if d != "cpu":
            torch.cuda.synchronize()
            reset_counts()
        with torch.no_grad():
            tj = eval_openloop._trajopt_row(net, b, cfg, form,
                                            flex=tj_flex.to(d))
            nn = eval_openloop._sample_and_score(
                net, b, cfg, form, diffusion.get_coeffs(cfg, device=d),
                flex=flex.to(d), noise=noise.to(d))
            m = eval_openloop._nn_metrics(*nn, b, cfg)
        if d != "cpu":
            torch.cuda.synchronize()
            check_counts(read_counts(), {"guidance_fused": guided},
                         "eval reference")
        res[str(d)] = {"tj": tj, "nn": m, "valid": nn[3].cpu()}
    cpu, card = res["cpu"], res[str(dev)]
    ok = True
    for row in ("tj", "nn"):
        s_c = cpu[row]["scores"].cpu()
        s_d = card[row]["scores"].cpu()
        valid = cpu["valid"] > 0
        share, err = share_beyond(s_d, s_c, EVAL_SCORE_ATOL,
                                  f"eval reference {row} scores")
        off = (s_d - s_c).abs() > EVAL_SCORE_ATOL
        near = s_c.abs() <= EVAL_SCORE_ATOL
        n_c = int(((s_c > 0) & valid).sum())
        n_d = int(((s_d > 0) & valid).sum())
        slack = int(((off | near) & valid).sum())
        log(f"eval reference {row}: satisfying valid rows card {n_d}, cpu "
            f"{n_c} of {int(valid.sum())} ({slack} rows off or within "
            f"{EVAL_SCORE_ATOL} of 0); acc card "
            f"{float(card[row]['acc']):.4f} cpu {float(cpu[row]['acc']):.4f}, "
            f"scene_acc card {float(card[row]['scene_acc']):.4f} cpu "
            f"{float(cpu[row]['scene_acc']):.4f}")
        ok &= share <= EVAL_MAX_OFF_SHARE and abs(n_c - n_d) <= slack
    for k in sorted(cpu["nn"]):
        if k != "scores":
            log(f"eval reference metric {k}: card "
                f"{float(card['nn'][k]):.6f}, cpu {float(cpu['nn'][k]):.6f}")
    log(f"eval reference: phase wall {time.time() - t0:.1f} s")
    if not ok:
        raise RuntimeError("card and cpu evaluations disagree")


def table1_phase(dev, store, name_power):
    """Phase 22: ``eval_openloop.run`` on the augmented store's val split at
    full width: the guided row (kernel 1 must launch once per guided
    denoise step of every batch and of the warm-up), kernel 1 against its
    plain version on the first guided step's inputs, then the unguided e7
    row (no kernel).  Returns kernel 1's record numbers."""
    import math
    import torch
    from pstl_tpu_torch import diffusion, eval_openloop
    from pstl_tpu_torch.ops import guidance_kernel as gk

    t0 = time.time()
    rows = {}
    for what, preset, kw in (("guided", "ours_guidance",
                              {"guidance_pallas_fuse_freeze": True}),
                             ("unguided e7", "e7_ours", {})):
        cfg = eval_config(preset, **kw)
        n_batches = min(math.ceil(store.split_len("val") / cfg.batch_size),
                        cfg.n_trials + 1)
        want = int(diffusion._trigger_schedule(cfg).sum()) * (n_batches + 1)
        net = e7_net(cfg, dev)
        times = []
        torch.cuda.synchronize()
        reset_counts()
        with Recorder(gk, "guidance_fused") as rec:
            out = eval_openloop.run(cfg, store, net, log=log, device=dev,
                                    times=times)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(counts, {"guidance_fused": want} if want else {},
                     f"Table I {what}")
        check_finite(out, f"Table I {what}")
        log(f"Table I {what} ({preset}, e7_round5 weights, {n_batches} val "
            f"batches of {cfg.batch_size} scenes x {cfg.sampling_size} x 3): "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(out.items())))
        log(f"Table I {what}: timed sampling region per batch "
            + ", ".join(f"{t * 1e3:.1f}" for t in times)
            + f" ms (median {median(times) * 1e3:.1f}); launches {counts}; "
            f"{name_power}")
        rows[what] = (counts["guidance_fused"], rec.calls, cfg)
    launches, calls, cfg = rows["guided"]
    args = calls[0][0]
    if abs(float(args[-2][1]) - cfg.stl_nn_thres) > 1e-9:
        raise RuntimeError(f"the eval path's hinge threshold is "
                           f"{float(args[-2][1])}, expected {cfg.stl_nn_thres}")
    err, ms, plain_ms, bnd = recorded_kernel1(args, "the eval path")
    log(f"kernel 1 on the eval path: launches {launches}; phase wall "
        f"{time.time() - t0:.1f} s")
    return launches, err, ms, plain_ms, bnd


def recorded_kernel1(args, where):
    """Kernel 1 against its plain version on a launch's recorded ``args``:
    the guided tolerance, both times and the bound, printed.  Returns
    (max error, times, plain ms, bound)."""
    import torch
    from pstl_tpu_torch.ops import guidance_kernel as gk
    gvec, p = args[-2], args[-1]
    ow, oa = gk.guidance_fused(*args)
    pw, pa = gk.guidance_fused_plain(*args)
    torch.cuda.synchronize()
    start = torch.stack([args[0], args[1]])
    got = torch.stack([ow, oa])
    err = check_guided(got, torch.stack([pw, pa]), start, float(gvec[0]),
                       f"kernel 1 on {where} (first guided step)")
    moved = float(((got - start).abs().amax(dim=(0, 2)) > 0).float().mean())
    bs, R = args[0].shape[0], args[0].shape[-1]
    ms = kernel_ms(lambda: gk.guidance_fused(*args))
    plain_ms = time_cuda(lambda: gk.guidance_fused_plain(*args))
    bnd = bound(nbytes(args[:-1], ow, oa), guidance_ops(p, bs, R, True))
    log(f"kernel 1 on {where} (bs={bs}, R={R}, niters={p.niters}, lr "
        f"{p.lr:g}, quirk {int(p.quirk)}, threshold {float(gvec[1]):.6g}, "
        f"the first guided step's beta_t {float(gvec[0]):.6g}): "
        f"{moved:.3f} of the candidate columns moved; kernel "
        f"{ms['graph_ms']:.4f} ms (graph replay), one eager call "
        f"{ms['ms']:.4f} ms, plain {plain_ms:.4f} ms (median of 20); bound "
        f"{bnd[0]:.5f} ms ({bnd[1]})")
    return err, ms, plain_ms, bnd


# --------------------------------------------------------------------------
# the closed-loop Table-II evaluation (phases 23-24)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def table2_data(cfg, n_keep=TABLE2_SCENES):
    """``scripts/closed_loop_eval.py``'s held-out scenes as a numpy dataset:
    synthetic seed 777, 2 x 25 scenes at scene_len 38, the pre-check (mean
    GT speed >= 1 m/s), the first ``n_keep`` kept, with their drivable
    rasters made once (``sim.scenes_from_dataset`` rasterizes a synthetic
    scene's corridor, ~0.5 s a scene on the host), once per (cfg, n_keep)
    a run."""
    import numpy as np
    from pstl_tpu_torch import sim
    from pstl_tpu_torch.data import synthetic
    data = synthetic.generate_dataset(TABLE2_SEED, 2 * TABLE2_SCENES, cfg,
                                      scene_len=38)
    keep = np.where(data["scene_ego_full"][:, :, 3].mean(-1)
                    >= 1.0)[0][:n_keep]
    data = {k: (v[keep] if k.startswith("scene_") else v)
            for k, v in data.items()}
    sc = sim.scenes_from_dataset(data, device="cpu")
    data.update(scene_drivable=sc.drivable.numpy(),
                scene_drivable_origin=sc.drivable_origin.numpy(),
                scene_drivable_res=sc.drivable_res.numpy())
    return data


def table2_scenes(data, dev, unsafe=0, repeat=None):
    """The scenes of ``table2_data`` on ``dev``: with
    ``closed_loop_eval.py``'s unsafe fixture (a 6 m x 6 m neighbor box
    riding the GT corridor two frames ahead) on the first ``unsafe`` of
    them, or ``repeat`` copies of the first scene (the ``--test_aggressive``
    presets' batch)."""
    import numpy as np
    from pstl_tpu_torch import sim
    data = dict(data)
    if repeat is not None:
        data = {k: (np.repeat(v[:1], repeat, axis=0)
                    if k.startswith("scene_") else v)
                for k, v in data.items()}
    if unsafe:
        nei = np.array(data["scene_nei_full"])
        ego = data["scene_ego_full"]
        T = ego.shape[1]
        ahead = ego[:unsafe, np.minimum(np.arange(T) + 2, T - 1)]
        nei[:unsafe, 0, :, 0] = 1.0
        nei[:unsafe, 0, :, 1:5] = ahead
        nei[:unsafe, 0, :, 5] = 6.0
        nei[:unsafe, 0, :, 6] = 6.0
        data["scene_nei_full"] = nei
    return sim.scenes_from_dataset(data, device=dev)


def keep_scores(info, cfg):
    """The planner's lane-keep scores (bs, M) after the forward shield, as
    ``sim.make_planner`` ranks them: their argmax is the chosen plan and
    their share above 0 the step's compliance."""
    import torch
    s = info["scores"].reshape(-1, cfg.n_randoms, 3)
    if cfg.forward_shield:
        min_v = torch.amin(info["trajs"][..., 3], dim=-1).reshape(s.shape)
        s = s - torch.clamp(-min_v, min=0.0) * 1e3
    return s[:, :, 0]


class Recorder:
    """Records the first ``n`` calls of a module's function while it runs
    (``with Recorder(module, name) as rec``): ``rec.calls`` holds (args,
    kwargs, result) a call, its tensor arguments cloned before the call."""

    def __init__(self, module, name, n=1):
        self.module, self.name, self.n, self.calls = module, name, n, []

    def __enter__(self):
        import torch
        self.real = real = getattr(self.module, self.name)

        def record(*a, **kw):
            if len(self.calls) >= self.n:
                return real(*a, **kw)
            args = tuple(x.clone() if torch.is_tensor(x) else x for x in a)
            out = real(*a, **kw)
            self.calls.append((args, dict(kw), out))
            return out

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def scorer_to(scorer, dev):
    """A copy of a ``specs.TiledScorer`` with its tensors on ``dev``."""
    import copy
    import torch
    out = copy.copy(scorer)
    for k, v in vars(scorer).items():
        if torch.is_tensor(v):
            setattr(out, k, v.to(dev))
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            setattr(out, k, type(v)(*(x.to(dev) for x in v)))
    return out


def table2_reference_phase(dev):
    """Phase 23: the Table-II step on the card against the CPU.  5 held-out
    scenes (an odd batch for kernel 1's G = 2 packing), the unsafe fixture
    on 2 of them, TABLE2_REF_M seeds a scene, fp32, route "2" with the
    backup controller (its solve cut to TABLE2_REF_BACKUP_ITERS Adam steps,
    see below) and the convex refinement (K = 6), TABLE2_REF_STEPS steps of
    pinned noise.  Each step starts both devices from the CPU's carry, so a
    difference does not compound.  The planner's discrete choices (the
    multi-cands argmax, the in-kernel argmins, the refinement's violation
    gate, the lane-keep argmax) may go another way at a near tie, after
    which a row or a scene's plan differs by any amount; so the gates are:
    kernel 1 launched once per denoise step; per step, the same plan (its
    first states within TABLE2_REF_TOL) in most scenes, and on those the
    ego state within TABLE2_REF_TOL, the chosen scores within
    EVAL_SCORE_ATOL and the repair, flags, time and done equal; the counts
    of compliant lane-keep rows equal up to the rows off by more than
    EVAL_SCORE_ATOL or within it of 0; the candidates' scores within
    EVAL_SCORE_ATOL on all but TABLE2_MAX_OFF_SHARE of the rows; the backup
    fired.  Then the full-length backup solve (500 Adam steps) and convex
    refinement (50) on the first step's recorded inputs, card against CPU,
    their largest differences printed: near its optimum the solve circles
    within ~lr, and the refinement is chaotic in its inputs
    (tests/test_torch_closed_loop.py), so neither has a card-vs-CPU
    tolerance."""
    import torch
    from pstl_tpu_torch import diffusion, refine, sim
    from pstl_tpu_torch.config import bench_config

    t0 = time.time()
    cfg = bench_config("heavy").with_(
        n_randoms=TABLE2_REF_M, compute_dtype="float32", backup=True,
        backup_niters=TABLE2_REF_BACKUP_ITERS, refinement=True,
        lite_refine=False)
    bs, M = TABLE2_REF_SCENES, TABLE2_REF_M
    g = torch.Generator().manual_seed(23)
    noise = [torch.randn((cfg.diffusion_steps, bs, cfg.nt, 2, 3 * M),
                         generator=g) for _ in range(TABLE2_REF_STEPS)]
    steps = {}
    data = table2_data(cfg, n_keep=bs)
    for d in ("cpu", dev):
        sc = table2_scenes(data, d, unsafe=TABLE2_REF_UNSAFE)
        steps[str(d)] = sim.make_closed_loop_step(
            sc, cfg, e7_net(cfg, d), diffusion.get_coeffs(cfg, device=d),
            with_info=True)
    init_cpu, step_cpu = steps["cpu"]
    _, step_dev = steps[str(dev)]
    c = init_cpu(0)
    gen_dev = torch.Generator(device=dev)
    apart = repairs = off_rows = 0
    worst_ego = 0.0
    for si in range(TABLE2_REF_STEPS):
        with Recorder(refine, "solve_backup") as rb, \
                Recorder(refine, "convex_refinement") as rc:
            c_cpu, info_c = step_cpu(c, noise[si])
        if si == 0:
            first = (rb.calls, rc.calls)
        c_in = sim.Carry(*(x.to(dev) for x in c[:-1]), generator=gen_dev)
        torch.cuda.synchronize()
        reset_counts()
        c_dev, info_d = step_dev(c_in, noise[si].to(dev))
        torch.cuda.synchronize()
        check_counts(read_counts(),
                     {"guidance_fused": cfg.diffusion_steps - 1},
                     f"Table-II reference step {si}")
        info_d = {k: v.cpu() for k, v in info_d.items()}
        c_dev = sim.Carry(*(x.cpu() for x in c_dev[:-1]),
                          generator=c.generator)
        what = f"Table-II reference step {si}"
        same = (info_c["plan_traj"][:, :3] - info_d["plan_traj"][:, :3]
                ).abs().amax(dim=(1, 2)) <= TABLE2_REF_TOL
        if not int(same.sum()) * 2 > bs:
            raise RuntimeError(f"{what}: the devices chose apart in "
                               f"{int((~same).sum())} of {bs} scenes")
        apart += int((~same).sum())
        ks_c, ks_d = keep_scores(info_c, cfg), keep_scores(info_d, cfg)
        d_best = (ks_c.amax(-1) - ks_d.amax(-1)).abs()[same]
        d_ego = (c_cpu.ego - c_dev.ego).abs().amax(-1)[same]
        worst_ego = max(worst_ego, float(d_ego.max()))
        if not (float(d_ego.max()) <= TABLE2_REF_TOL
                and float(d_best.max()) <= EVAL_SCORE_ATOL):
            raise RuntimeError(f"{what}: on the same plans the ego differs "
                               f"by {float(d_ego.max()):.3e}, the chosen "
                               f"score by {float(d_best.max()):.3e}")
        for k in ("collide", "out_of_lane", "repairs", "t", "done"):
            a, b = getattr(c_cpu, k)[same], getattr(c_dev, k)[same]
            if not torch.equal(a, b):
                raise RuntimeError(f"{what}: {k} {a.tolist()} (cpu) vs "
                                   f"{b.tolist()} (card)")
        s_c = info_c["scores"].reshape(bs, M, 3)
        s_d = info_d["scores"].reshape(bs, M, 3)
        off = (s_c - s_d).abs() > EVAL_SCORE_ATOL
        off_rows += int(off.sum())
        slack = (off | (s_c.abs() <= EVAL_SCORE_ATOL))[:, :, 0].sum(-1)
        n_c, n_d = (ks_c > 0).sum(-1), (ks_d > 0).sum(-1)
        if not bool(((n_c - n_d).abs() <= slack).all()):
            raise RuntimeError(f"{what}: compliant lane-keep rows "
                               f"{n_c.tolist()} (cpu) vs {n_d.tolist()} "
                               f"(card), slack {slack.tolist()}")
        repairs = int(c_cpu.repairs.sum())
        log(f"{what}: the same plan in {int(same.sum())} of {bs} scenes, "
            f"ego within {float(d_ego.max()):.3e} there; rows off "
            f"{int(off.sum())} of {off.numel()} (max "
            f"{float((s_c - s_d).abs().max()):.3e}); compliance cpu "
            f"{float(info_c['stl_acc'].mean()):.4f} card "
            f"{float(info_d['stl_acc'].mean()):.4f}; repairs so far "
            f"{repairs}")
        c = c_cpu
    n_rows = TABLE2_REF_STEPS * bs * M * 3
    if not off_rows <= TABLE2_MAX_OFF_SHARE * n_rows:
        raise RuntimeError(f"Table-II reference: {off_rows} of {n_rows} "
                           f"rows' scores beyond {EVAL_SCORE_ATOL}")
    if not repairs > 0:
        raise RuntimeError("Table-II reference: the backup never fired")

    (bk_args, _, _), = first[0]
    (cv_args, cv_kw, _), = first[1]
    out = {}
    for d in ("cpu", dev):
        mv = lambda a: tuple(x.to(d) for x in a)
        res = refine.solve_backup(*mv(bk_args[:3]), cfg, n_iters=500)
        u = refine.convex_refinement(*mv(cv_args[:3]),
                                     scorer_to(cv_args[3], d),
                                     *mv(cv_args[4:5]), cfg, **cv_kw)
        out[str(d)] = (res.cpu(), u.cpu())
    errs = [float((a - b).abs().max())
            for a, b in zip(out["cpu"], out[str(dev)])]
    if not all(bool(torch.isfinite(v).all()) for v in out[str(dev)]):
        raise RuntimeError("Table-II reference: a full-length loop on the "
                           "card is not finite")
    log(f"Table-II reference: {TABLE2_REF_STEPS} steps of {bs} scenes "
        f"({TABLE2_REF_UNSAFE} with the unsafe fixture) x {M} x 3: ego "
        f"within {worst_ego:.3e} on the same plans, {apart} scene-steps "
        f"chose apart, {off_rows} of {n_rows} rows off, {repairs} repairs.  "
        f"Full length on the first step's inputs, card vs cpu: backup solve "
        f"(500 Adam steps, {bk_args[0].shape[0]} unsafe scenes) "
        f"max_abs_err={errs[0]:.3e}; convex refinement (K=6, 50 Adam "
        f"steps, {cv_args[0].shape[0]} rows) max_abs_err={errs[1]:.3e}; "
        f"phase wall {time.time() - t0:.1f} s")


#: phase 24's rows: (name, configuration from the heavy contract, steps,
#: scenes' keyword arguments for table2_scenes, stlp_override)
def table2_rows():
    from pstl_tpu_torch import sim
    from pstl_tpu_torch.config import bench_config
    heavy = bench_config("heavy")
    return [
        ("a guided", heavy, TABLE2_STEPS, {}, None),
        ("b ref_parity", heavy.ref_parity(open_loop=False), TABLE2_STEPS,
         {}, None),
        ("c backup, unsafe fixture", heavy.with_(backup=True),
         TABLE2_SHORT_STEPS, {"unsafe": TABLE2_SCENES}, None),
        ("d refinement + lite_refine",
         heavy.with_(refinement=True, lite_refine=True), TABLE2_SHORT_STEPS,
         {}, None),
        ("d raw_refinement", heavy.with_(raw_refinement=True),
         TABLE2_SHORT_STEPS, {}, None),
        ("e test_aggressive", heavy, TABLE2_STEPS,
         {"repeat": len(sim.TEST_AGGRESSIVE_STLPS)},
         sim.TEST_AGGRESSIVE_STLPS),
    ]


def step_launches(scenes, cfg, net, coeffs, override):
    """Device launches of one recorded closed-loop step from the episodes'
    start, profiled apart.  Under the backup, a step of 1 and of 2 solve
    iterations are profiled and the step of ``backup_niters`` extrapolated
    (the loop repeats one iteration's launches; the profiler's overhead on a
    step of ~10^5 launches would take minutes)."""
    from pstl_tpu_torch import sim

    def one(c):
        return profile_calls(lambda: sim.run_closed_loop_host(
            0, scenes, c, net, coeffs, 1, record=True,
            stlp_override=override), 1)[0]

    if not cfg.backup:
        return one(cfg)
    l1, l2 = one(cfg.with_(backup_niters=1)), one(cfg.with_(backup_niters=2))
    return l1 + (l2 - l1) * (cfg.backup_niters - 1)


def table2_phase(dev, name_power):
    """Phase 24: Table II at full width (``scripts/closed_loop_eval.py``'s
    protocol on the port): the held-out scenes, ``run_closed_loop_host``
    with ``record=True`` and the e7_round5 weights, at the heavy contract's
    width and route ``"2"`` for each of ``table2_rows``.  Every metric must
    be finite; kernel 1 must launch once per guided denoise step of every
    step run (and nothing else); the backup row must repair.  Per row: the
    Table-II columns, the median step (host clock + sync, the record's
    area metric included, as in the JAX package) and, profiled apart on one
    more step, the device launches of a step.  Kernel 1 against its plain
    version on row (b)'s first guided step's recorded inputs.  Returns
    kernel 1's record numbers for row (b)."""
    import numpy as np
    import torch
    from pstl_tpu_torch import diffusion, sim
    from pstl_tpu_torch.ops import guidance_kernel as gk

    t0 = time.time()
    rows = table2_rows()
    net = e7_net(rows[0][1], dev)
    coeffs = diffusion.get_coeffs(rows[0][1], device=dev)
    data = table2_data(rows[0][1])
    parity = None
    for what, cfg, steps, scene_kw, override in rows:
        t_row = time.time()
        scenes = table2_scenes(data, dev, **scene_kw)
        guided = int(diffusion._trigger_schedule(cfg).sum())
        torch.cuda.synchronize()
        reset_counts()
        with Recorder(gk, "guidance_fused") as rec:
            out = sim.run_closed_loop_host(0, scenes, cfg, net, coeffs,
                                           steps, record=True,
                                           stlp_override=override)
        torch.cuda.synchronize()
        counts = read_counts()
        hist = out["history"]
        ran = len(hist["step_s"])
        check_counts(counts, {"guidance_fused": guided * ran},
                     f"Table II {what}")
        if what.startswith("b"):
            parity = (counts["guidance_fused"], rec.calls[0][0])
        vals = {k: float(v.float().mean()) if torch.is_tensor(v) else v
                for k, v in out.items() if k != "history"}
        vals["repairs_fired"] = float(out["repairs"].sum())
        vals["area"] = float(out["area"])
        check_finite(vals, f"Table II {what}")
        if not np.isfinite(np.stack(hist["ego"])).all():
            raise RuntimeError(f"Table II {what}: ego history not finite")
        if what.startswith("c") and not vals["repairs_fired"] > 0:
            raise RuntimeError("Table II backup row: no repair fired")
        launches = step_launches(scenes, cfg, net, coeffs, override)
        log(f"Table II {what} ({scenes.ego_full.shape[0]} scenes x "
            f"{cfg.n_randoms} x 3, {ran} of {steps} steps, {guided} of "
            f"{cfg.diffusion_steps - 1} denoise steps guided, niters "
            f"{cfg.guidance_niters}, e7_round5 weights): compliance="
            f"{vals['stl_acc']:.4f} area={vals['area']:.4f} progress="
            f"{vals['progress']:.3f} collision={vals['collide']:.4f} "
            f"out_of_lane={vals['out_of_lane']:.4f} mean_traj_len="
            f"{vals['traj_len']:.2f} repairs_fired="
            f"{vals['repairs_fired']:.0f}; median step "
            f"{median(hist['step_s']) * 1e3:.1f} ms (first "
            f"{hist['step_s'][0] * 1e3:.1f} ms), {launches:.0f} device "
            f"launches a step (profiled apart); kernel 1 launches "
            f"{counts['guidance_fused']} = {guided} x {ran}; row wall "
            f"{time.time() - t_row:.1f} s; {name_power}")

    launches, args = parity
    err, ms, plain_ms, bnd = recorded_kernel1(args, "the ref_parity row")
    log(f"kernel 1 on the ref_parity row: launches {launches}; phase wall "
        f"{time.time() - t0:.1f} s")
    return launches, err, ms, plain_ms, bnd


# --------------------------------------------------------------------------
# the baselines: VAE, TrafficSim, BC and CTG (phases 25-28)
# --------------------------------------------------------------------------

def baseline_train_phase(dev, store, name_power):
    """Phase 26: BASELINE_STEPS train steps and an eval step of each of
    BASELINES at full width on phase 20's store (128 scenes x 64 x 3 =
    24,576 rows, bf16), from a seed; no kernel may launch.  The median
    step, the peak device memory (e6's hinge backward runs the
    ``TiledScorer``'s recompute VJP and its collision loss materializes the
    (n, K, T, nL, nW) pair tensors of the geometry route) and finite
    metrics; then an e6 checkpoint saved and loaded (phase 18's checks).
    Returns the trained nets by name."""
    import torch

    t0 = time.time()
    nets = {}
    for name, preset, kw in BASELINES:
        cfg = dense_config(preset, **kw)
        net = dense_net(cfg, dev, seed=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        med, _ = dense_loop(dev, cfg, net, store, BASELINE_STEPS,
                            f"{name} train steps")
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"{name} training ({preset}, {cfg.batch_size} scenes x "
            f"{cfg.n_randoms * 3} rows, {cfg.compute_dtype}): median train "
            f"step {med * 1e3:.1f} ms, peak device memory {peak:.2f} GiB; "
            f"{name_power}")
        nets[name] = net
    dense_checkpoint_phase(dev, store, "e6_trafficsim")
    log(f"baseline training: phase wall {time.time() - t0:.1f} s")
    return nets


def eval_net(cfg, src, dev):
    """A net of ``cfg`` on ``dev`` holding ``src``'s parameters (a net reads
    its own config: a mono-trained net evaluates its multi-candidate
    rows)."""
    from pstl_tpu_torch.models.net import Net
    net = Net(cfg)
    net.load_state_dict(src.state_dict())
    return net.to(dev).eval()


def e5b_net(cfg, dev):
    """The committed e5b_round5 DDPM base (strict) in a net of ``cfg``."""
    from pstl_tpu_torch.models import convert
    from pstl_tpu_torch.models.net import Net
    net = Net(cfg)
    convert.load_weights(net, "e5b_round5")
    return net.to(dev).eval()


def table1_baseline_phase(dev, store, nets, name_power):
    """Phase 27: Table I's baseline rows with phase 22's protocol on the
    store's val split: vae_mono (phase 15's e2 net, ``gt_data_training``
    off as ``scripts/e2e_pipeline.py`` evaluates it), vae_aug (e3),
    trafficsim (e6) and BC from phase 26, and ctg (e5b_round5, guided on
    every denoise step under ``guidance_pallas_fuse_freeze``: kernel 1 on
    every denoise step of every batch and of the warm-up; the VAE / BC rows
    launch nothing).  Kernel 1 against its plain version on the ctg row's
    first guided step.  Returns kernel 1's record numbers."""
    import math
    import torch
    from pstl_tpu_torch import diffusion, eval_openloop
    from pstl_tpu_torch.ops import guidance_kernel as gk

    t0 = time.time()
    rows = (("vae_mono", "e2_vae_mono", {"gt_data_training": False}, "e2"),
            ("vae_aug", "e3_vae", {}, "e3"),
            ("trafficsim", "e6_trafficsim", {}, "e6"),
            ("bc", "e3_vae", BC_KW, "bc"),
            ("ctg", "ctg", {"guidance_pallas_fuse_freeze": True}, None))
    ctg = None
    for what, preset, kw, src in rows:
        cfg = eval_config(preset, **kw)
        net = e5b_net(cfg, dev) if src is None else eval_net(cfg, nets[src],
                                                             dev)
        n_batches = min(math.ceil(store.split_len("val") / cfg.batch_size),
                        cfg.n_trials + 1)
        guided = (int(diffusion._trigger_schedule(cfg).sum())
                  if cfg.guidance else 0)
        times = []
        torch.cuda.synchronize()
        reset_counts()
        with Recorder(gk, "guidance_fused") as rec:
            out = eval_openloop.run(cfg, store, net, log=lambda *a: None,
                                    device=dev, times=times)
        torch.cuda.synchronize()
        counts = read_counts()
        want = guided * (n_batches + 1)
        check_counts(counts, {"guidance_fused": want} if want else {},
                     f"Table I {what}")
        check_finite(out, f"Table I {what}")
        weights = ("e5b_round5 weights" if src is None else
                   f"phase {15 if src == 'e2' else 26}'s {src} net: a "
                   f"wiring check, not a Table result")
        log(f"Table I {what} ({preset}, {weights}; {n_batches} val batches "
            f"of {cfg.batch_size} scenes x {cfg.sampling_size} x 3): "
            f"success={out['nn_scene_acc']:.4f} "
            f"compliance={out['nn_acc']:.4f} area={out['nn_area']:.4f} "
            f"entropy={out['nn_ent_ent_s']:.4f}; "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(out.items())))
        log(f"Table I {what}: timed sampling region per batch "
            + ", ".join(f"{t * 1e3:.1f}" for t in times)
            + f" ms (median {median(times) * 1e3:.1f}); kernel 1 launches "
            f"{counts['guidance_fused']} = {guided} x {n_batches + 1}; "
            f"{name_power}")
        if src is None:
            ctg = (counts["guidance_fused"], rec.calls[0][0])
    launches, args = ctg
    err, ms, plain_ms, bnd = recorded_kernel1(args, "the ctg Table-I row")
    log(f"kernel 1 on the ctg Table-I row: launches {launches}; phase wall "
        f"{time.time() - t0:.1f} s")
    return launches, err, ms, plain_ms, bnd


def table2_baseline_phase(dev, nets, name_power):
    """Phase 28: Table II's baseline rows with phase 24's protocol (seed
    777, the first 25 held-out scenes that pass the pre-check, scene_len
    38, ``run_closed_loop_host(record=True)``, M 64, TABLE2_STEPS steps):
    vae_aug and trafficsim with phase 26's nets (a wiring check), ctg with
    e5b_round5 under ``guidance_pallas_fuse_freeze`` (kernel 1 on all 99
    denoise steps of every step run; the VAE rows launch nothing).  Per
    row the six Table-II columns, the median step and, profiled apart on
    one more step, the device launches of a step.  Returns ctg's kernel 1
    launches."""
    import numpy as np
    import torch
    from pstl_tpu_torch import diffusion, sim
    from pstl_tpu_torch.config import bench_config

    t0 = time.time()
    data = table2_data(bench_config("heavy"))
    rows = (("vae_aug", dense_config("e3_vae"), nets["e3"]),
            ("trafficsim", dense_config("e6_trafficsim"), nets["e6"]),
            ("ctg", dense_config("ctg", guidance_pallas_fuse_freeze=True
                                 ).finalize(), None))
    ctg_launches = None
    for what, cfg, src in rows:
        t_row = time.time()
        net = e5b_net(cfg, dev) if src is None else eval_net(cfg, src, dev)
        coeffs = diffusion.get_coeffs(cfg, device=dev)
        scenes = table2_scenes(data, dev)
        guided = (int(diffusion._trigger_schedule(cfg).sum())
                  if cfg.guidance else 0)
        torch.cuda.synchronize()
        reset_counts()
        out = sim.run_closed_loop_host(0, scenes, cfg, net, coeffs,
                                       TABLE2_STEPS, record=True)
        torch.cuda.synchronize()
        counts = read_counts()
        hist = out["history"]
        ran = len(hist["step_s"])
        check_counts(counts, {"guidance_fused": guided * ran} if guided
                     else {}, f"Table II {what}")
        if guided:
            ctg_launches = counts["guidance_fused"]
        vals = {k: float(v.float().mean()) if torch.is_tensor(v) else v
                for k, v in out.items() if k != "history"}
        vals["area"] = float(out["area"])
        check_finite(vals, f"Table II {what}")
        if not np.isfinite(np.stack(hist["ego"])).all():
            raise RuntimeError(f"Table II {what}: ego history not finite")
        hits = torch.nonzero(out["collide"].float().cpu() > 0).flatten()
        log(f"Table II {what}: colliding scenes (index into table2_data's "
            f"kept scenes) {hits.tolist()}")
        launches = step_launches(scenes, cfg, net, coeffs, None)
        log(f"Table II {what} ({scenes.ego_full.shape[0]} scenes x "
            f"{cfg.n_randoms} x 3, {ran} of {TABLE2_STEPS} steps, "
            + ("e5b_round5 weights" if src is None else
               "phase 26's net: a wiring check, not a Table result")
            + f"): compliance={vals['stl_acc']:.4f} area={vals['area']:.4f} "
            f"progress={vals['progress']:.3f} collision="
            f"{vals['collide']:.4f} out_of_lane={vals['out_of_lane']:.4f} "
            f"mean_traj_len={vals['traj_len']:.2f}; median step "
            f"{median(hist['step_s']) * 1e3:.1f} ms (first "
            f"{hist['step_s'][0] * 1e3:.1f} ms), {launches:.0f} device "
            f"launches a step (profiled apart); kernel 1 launches "
            f"{counts['guidance_fused']} = {guided} x {ran}; row wall "
            f"{time.time() - t_row:.1f} s; {name_power}")
    log(f"Table II baselines: phase wall {time.time() - t0:.1f} s")
    return ctg_launches


# --------------------------------------------------------------------------
# the rest of the sampler and the shard store (phases 29-32)
# --------------------------------------------------------------------------

def plan_context(cfg, scenes):
    """The first plan step's dense batch and guidance context of the scenes
    (``sim.make_planner``'s: ``score_rows``, the validity mask, the dense
    initial states and the fused loss where ``cfg`` enables it), and the
    rows' count n."""
    import torch
    from pstl_tpu_torch import diffusion, sim, specs
    dev = scenes.ego_full.device
    bs = scenes.ego_full.shape[0]
    obs = sim.observe(scenes, scenes.ego_full[:, 0],
                      torch.zeros(bs, dtype=torch.long, device=dev), cfg)
    n = bs * cfg.n_randoms * 3
    stlp = torch.as_tensor(sim.AGGRESSIVE_STLP, device=dev)
    dense = specs.densify_batch(obs, stlp.expand(bs, 6), cfg,
                                stlp.expand(n, 1, 6))
    states = obs["ego_traj"][:, 0, :4]
    valid = dense["valids_dense"].reshape(-1)
    ctx = diffusion.make_guidance_ctx(
        specs.make_score_rows(obs, dense, cfg), valid,
        torch.repeat_interleave(states, cfg.n_randoms * 3, 0),
        specs.make_guidance_loss(obs, dense, cfg, states, valid))
    return dense, ctx, n


#: phase 29's passes: (what, BENCH_GPALLAS, overrides of the heavy row)
SAMPLER_REF = (
    ("DDIM eta 0", "2", {"sampler": "ddim", "ddim_steps": 6}),
    ("DDIM eta 0.5", "2", {"sampler": "ddim", "ddim_steps": 6,
                           "ddim_eta": 0.5}),
    ("DPM++", "2", {"sampler": "dpmpp", "ddim_steps": 6}),
    ("m-major DDPM", "2", {"cm_sampler": False}),
    ("bf16 robustness", "0", {"robustness_dtype": "bfloat16"}))


def sampler_reference_phase(dev, net_cpu, net_dev):
    """Phase 29: small reverse passes of the new samplers on the card
    against the CPU with pinned draws, each through ``diffusion.sample``
    with the planner's guidance context: DDIM at eta 0 and 0.5, DPM++ and
    the m-major guided DDPM on route "2" (kernel 1 on the card, its plain
    version on the CPU), and route "0" (the XLA loop) with bf16
    robustness.  Phase 5's tolerance, 1e-3 in the controls, on all but
    EVAL_MAX_OFF_SHARE of them: an in-kernel argmin at a near-tie can go
    the other way on the card (FMA contraction), which moves that column
    within its trust region, and the later steps carry it (on the CPU
    alone, a 1e-7 relative change of eps moves the DDIM eta-0.5 pass's
    controls this way).  Every control within ``trust_region_bound``.  In
    bf16 the two devices round the robustness gradients apart, so any
    share may flip; there only the bound holds.  Then one fp32
    ``ours_guidance`` train step, card against CPU, at phase 16's
    tolerances."""
    import torch
    from pstl_tpu_torch import diffusion
    from pstl_tpu_torch.config import bench_config
    from pstl_tpu_torch.models import net as models

    t0 = time.time()
    for what, gpallas, kw in SAMPLER_REF:
        cfg = bench_config("heavy", gpallas=gpallas).with_(
            n_randoms=4, diffusion_steps=12, compute_dtype="float32", **kw)
        out = {}
        for d, net in (("cpu", net_cpu), (dev, net_dev)):
            scenes = scene_batch(cfg, d, n_scenes=2)
            dense, ctx, n = plan_context(cfg, scenes)
            g = torch.Generator()
            g.manual_seed(3)
            noise = torch.randn(
                (diffusion.n_draws(cfg),)
                + diffusion.draw_layout(cfg, 2, 3 * cfg.n_randoms),
                generator=g).to(d)
            with torch.no_grad():
                feature = torch.repeat_interleave(net.encode(dense),
                                                  cfg.n_randoms * 3, 0)
                cm_fn = (models.make_cm_eps_fn(
                    net, dense, dense["highlevel_dense"], feature, cfg)
                    if cfg.cm_sampler and ctx.fused_loss is not None
                    else None)
                ctrl, _ = diffusion.sample(
                    lambda e: net(dense, e, prev_feature=feature),
                    dense["highlevel_dense"], cfg,
                    diffusion.get_coeffs(cfg, device=d), n, noise=noise,
                    stlp_dense=dense["stlp_dense"], guide=ctx,
                    maximize=True, cm_fn=cm_fn)
            out[str(d)] = ctrl.cpu()
        diff = (out[str(dev)] - out["cpu"]).abs()
        err = float(diff.max())
        share = float((diff > 1e-3).float().mean())
        bnd = trust_region_bound(cfg)
        bf16 = cfg.robustness_dtype == "bfloat16"
        log(f"sampler reference: {what} (BENCH_GPALLAS={gpallas}, "
            f"{diffusion.n_draws(cfg)} draws), card vs cpu "
            f"max_abs_err={err:.3e} (bound {bnd:.3g}), {share:.4f} of the "
            f"controls beyond 1e-3 (allowed "
            f"{'any' if bf16 else EVAL_MAX_OFF_SHARE})")
        if not (err <= bnd and (bf16 or share <= EVAL_MAX_OFF_SHARE)):
            raise RuntimeError(f"card and cpu {what} passes disagree: "
                               f"{err}, {share} beyond 1e-3")
    dense_reference_phase(dev, (("ours_guidance", "ours_guidance",
                                 {"stl_weight": 1.0}),),
                          "guided dense reference")
    log(f"phase 29 wall {time.time() - t0:.1f} s")


def trust_region_bound(cfg):
    """The sum over the guided denoise steps of 2 beta_t, times the larger
    control scale: how far a chain's controls can move if every guided
    update flips within its trust region on either side."""
    from pstl_tpu_torch import diffusion
    beta = diffusion.get_coeffs(cfg).beta
    if cfg.sampler in diffusion.FAST_SAMPLERS:
        taus = [int(t) for t in diffusion._fast_taus(cfg)]
        ts = taus if cfg.sampler == "ddim" else taus[1:]
    else:
        trig = diffusion._trigger_schedule(cfg)
        ts = [t for j, t in enumerate(range(cfg.diffusion_steps - 1, 0, -1))
              if trig[j]]
    return float(sum(2 * beta[t] for t in ts)) * max(cfg.mul_w_max,
                                                     cfg.mul_a_max)


#: phase 30's rows: (what, BENCH mode, BENCH_GPALLAS, overrides, steps)
SAMPLER_ROWS = (
    ("DDIM 20 steps", "heavy", "2", {"sampler": "ddim", "ddim_steps": 20},
     STEPS),
    ("DPM++ 20 steps", "heavy", "2", {"sampler": "dpmpp", "ddim_steps": 20},
     ROUTE_STEPS),
    ("DDIM 20 steps, frozen payloads", "heavy", "1",
     {"sampler": "ddim", "ddim_steps": 20}, ROUTE_STEPS),
    ("m-major DDPM (cm_sampler off)", "heavy", "2", {"cm_sampler": False},
     ROUTE_STEPS),
    ("parity, DDIM 20 steps, guided focus 0.5", "parity", "2",
     {"sampler": "ddim", "ddim_steps": 20, "fast_guided_focus": 0.5},
     ROUTE_STEPS),
    ("XLA loop, bf16 robustness", "heavy", "0",
     {"robustness_dtype": "bfloat16"}, ROUTE_STEPS))


def guided_steps(cfg):
    """Guided denoise steps a plan: every step of a fast sampler (DDIM S,
    DPM++ S - 1), the trigger schedule's on the DDPM chain."""
    from pstl_tpu_torch import diffusion
    if cfg.sampler == "ddim":
        return len(diffusion._fast_taus(cfg))
    if cfg.sampler == "dpmpp":
        return len(diffusion._fast_taus(cfg)) - 1
    return int(diffusion._trigger_schedule(cfg).sum())


def sampler_loop_phase(dev, net, name_power):
    """Phase 30: the heavy contract at full width (e7_round5, 16 synthetic
    scenes) under the new samplers: ``SAMPLER_ROWS``, each launching its
    route's kernel once per guided step of every plan and nothing else;
    kernel 1 against its plain version on the DDIM row's first guided
    step's recorded inputs.  Per row the median step, launches a step and
    the quality, beside the DDPM route "2" (phase 6).  Returns kernel 1's
    record numbers at the DDIM point."""
    from pstl_tpu_torch.config import bench_config
    from pstl_tpu_torch.ops import guidance_kernel as gk

    t0 = time.time()
    ddim = None
    for what, mode, gpallas, kw, steps in SAMPLER_ROWS:
        t_row = time.time()
        cfg = bench_config(mode, gpallas=gpallas).with_(**kw)
        kernel = ROUTE_KERNEL[gpallas]
        guided = guided_steps(cfg)
        with Recorder(gk, "guidance_fused") as rec:
            counts, m, step_s, wall = run_loop(dev, net, cfg, steps)
        check_counts(counts, {kernel: guided * steps} if kernel else {},
                     f"{what} closed loop")
        report_loop(f"{what} closed loop (BENCH_GPALLAS={gpallas})", steps,
                    counts, m, step_s, wall)
        log(f"{what}: median step {median(step_s) * 1e3:.1f} ms, "
            f"{counts.get(kernel, 0) // steps if kernel else 0} kernel "
            f"launches a step ({guided} guided steps a plan); row wall "
            f"{time.time() - t_row:.1f} s; {name_power}")
        if ddim is None:
            ddim = (counts[kernel], rec.calls[0][0])
    ref = LOOPS.get("BENCH_GPALLAS=2 sel_every=1 closed loop")
    if ref is not None:
        log(f"beside the DDPM chain on route 2 (phase 6, 99 guided steps a "
            f"plan): median step {ref[0] * 1e3:.1f} ms, "
            + " ".join(f"{k}={v:.4f}" for k, v in ref[1].items()))
    launches, args = ddim
    err, ms, plain_ms, bnd = recorded_kernel1(args, "the DDIM closed loop")
    log(f"kernel 1 on the DDIM closed loop: launches {launches}; phase "
        f"wall {time.time() - t0:.1f} s")
    return launches, err, ms, plain_ms, bnd


def guided_train_phase(dev, ds, name_power):
    """Phase 31: ``ours_guidance`` (the training sampler guided on its last
    10 denoise steps through the row-major fallback loss) warm-started
    from e5b_round5 at full width (phase 15's scenes with the GT controls
    in seed 0: 128 scenes x 64 x 3 = 24,576 rows, bf16): E7_STEPS train
    steps and an eval step, finite, no kernel launch; every parameter
    outside the RefineNet head bit for bit as loaded."""
    import torch
    from pstl_tpu_torch import train

    t0 = time.time()
    cfg = dense_config("ours_guidance")
    net = dense_net(cfg, dev, seed=1, warm=True)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    step, _ = dense_loop(dev, cfg, net, ds, E7_STEPS,
                         "ours_guidance train steps")
    moved = sorted({k.split(".")[0] for k, v in net.state_dict().items()
                    if not torch.equal(v, before[k])})
    if any(m not in train.RECT_MODULES for m in moved):
        raise RuntimeError(f"ours_guidance steps moved {moved}, expected "
                           f"the RefineNet head only")
    log(f"guided training: median train step {step * 1e3:.1f} ms "
        f"({cfg.batch_size} scenes x {cfg.n_randoms * 3} rows, "
        f"{guided_steps(cfg)} of "
        f"{cfg.diffusion_steps - 1} denoise steps guided, "
        f"{cfg.guidance_niters} Adam iteration at lr {cfg.guidance_lr}; "
        f"{name_power}); modules moved: {moved}; phase wall "
        f"{time.time() - t0:.1f} s")


def shard_store_phase(dev, store, name_power):
    """Phase 32: phase 20's store written as a native shard store (under
    build/), one epoch of its shuffled train batches against
    ``batch_iterator``'s bit for bit, then E5_STEPS ``e5_ddpm`` train steps
    (and the val pass) through ``train.train(use_shard_store=True,
    time_profile=True)`` on a subset of E5_STEPS train batches, with the
    timer's sections printed."""
    import shutil
    import numpy as np
    from pstl_tpu_torch import train
    from pstl_tpu_torch.data.dataset import (SceneDataset, batch_iterator,
                                             shard_store_iterator,
                                             to_shard_store)
    from pstl_tpu_torch.runtime import ShardStore

    t0 = time.time()
    cfg = dense_config("e5_ddpm")
    path = os.path.join(HERE, "build", "chip_smoke_store", "shard_store")
    shutil.rmtree(path, ignore_errors=True)
    to_shard_store(store, path)
    ss = ShardStore(path)
    t1 = time.time()
    got = list(shard_store_iterator(ss, store, "train", cfg.batch_size,
                                    shuffle=True, seed=cfg.seed, epoch=0))
    t_store = time.time() - t1
    t1 = time.time()
    want = list(batch_iterator(store, "train", cfg.batch_size, shuffle=True,
                               seed=cfg.seed, epoch=0))
    t_np = time.time() - t1
    if len(got) != len(want) or not got:
        raise RuntimeError(f"shard store: {len(got)} batches, "
                           f"batch_iterator {len(want)}")
    for g, w in zip(got, want):
        if sorted(g) != sorted(w) or not all(
                g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
                for k in w):
            raise RuntimeError("shard store batches differ from "
                               "batch_iterator's")
    ss.close()
    log(f"shard store: {len(got)} train batches of {cfg.batch_size} scenes "
        f"({len(got[0])} columns) equal batch_iterator's bit for bit; "
        f"epoch read {t_store:.2f} s (shard store) vs {t_np:.2f} s "
        f"(numpy gather)")
    # a subset whose train split holds E5_STEPS batches
    n = E5_STEPS * cfg.batch_size
    while True:
        sub = SceneDataset({k: v[:n] for k, v in store.data.items()}, cfg)
        if sub.split_len("train") // cfg.batch_size >= E5_STEPS:
            break
        n += 8
    sdir = os.path.join("exps", "_tmp", "shard_store")
    shutil.rmtree(sdir, ignore_errors=True)
    logs = []
    reset_counts()
    state = train.train(cfg.with_(use_shard_store=True, time_profile=True),
                        sub, epochs=1, device=dev, log=logs.append)
    check_counts(read_counts(), {}, "e5 through the shard store")
    shutil.rmtree(sdir, ignore_errors=True)
    for ln in logs:
        if ln.startswith("profile[") or ln.startswith(("train[", "val  [")):
            log(f"shard store e5: {ln}")
    prof = [ln for ln in logs if ln.startswith("profile[")]
    if state.step != sub.split_len("train") // cfg.batch_size or len(
            prof) != 2:
        raise RuntimeError(f"train.train on the shard store ran "
                           f"{state.step} steps, {len(prof)} profiles")
    log(f"shard store e5: {state.step} train steps of {cfg.batch_size} "
        f"scenes through train.train(use_shard_store=True, "
        f"time_profile=True); {name_power}; phase wall "
        f"{time.time() - t0:.1f} s")


#: phase 33, the command line on the card: the scenes of its ``data``
#: command, the trajopt iterations, the closed loop's scenes and steps
CLI_SCENES = 256
CLI_TJ_ITERS = 20
CLI_SIM_SCENES = 16
CLI_SIM_STEPS = 4
#: its working directory (made anew)
CLI_WORK = os.path.join(HERE, "build", "cli_phase")
#: bench.py's heavy contract as ``--set`` pairs: with no preset, the
#: command line's config equals ``bench_config("heavy")`` field for field
#: (tests/test_torch_cli.py)
CLI_HEAVY = ("diffusion=true", "rect_head=true", "diverse_loss=true",
             "multi_cands=10", "guidance=true", "guidance_niters=3",
             "n_rolls=3", "n_randoms=64", "n_neighbors=8", "flex=true",
             "guidance_pallas=true", "guidance_pallas_fuse_freeze=true",
             "guidance_pallas_pack=2", "guidance_pallas_cols=0",
             "guidance_reuse_selection=true", "clearance_coarse_pair=true",
             "guidance_pallas_bf16_cumsum=true")


def printed_json(text, what):
    """The JSON object a command printed, every value finite."""
    res = json.loads(text[text.index("{"):])
    check_finite(res, what)
    return res


def cli_run(what, argv, sets=()):
    """``cli.main(argv + --set sets)`` in CLI_WORK with the launch counts
    set to 0 just before and read just after; its stdout is captured.
    Returns (stdout, counts, wall s)."""
    import contextlib
    import io
    import torch
    from pstl_tpu_torch import cli
    cwd = os.getcwd()
    os.chdir(CLI_WORK)
    try:
        torch.cuda.synchronize()
        reset_counts()
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            cli.main(list(argv) + ["--set", *sets])
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        os.chdir(cwd)
    counts = read_counts()
    text = buf.getvalue()
    tail = text.strip().splitlines()[-1] if text.strip() else ""
    log(f"cli {what}: {wall:.2f} s; launches {counts}; last line: {tail}")
    return text, counts, wall


def cli_phase(dev, name_power, width=()):
    """Phase 33: the port's command line (``pstl_tpu_torch.cli.main``) in
    this process, on the card it picks by default (no ``--device``), in
    CLI_WORK: ``data`` (CLI_SCENES synthetic scenes), ``check``,
    ``trajopt`` (CLI_TJ_ITERS iterations), ``train --preset e2_vae_mono``
    with the clearance kernels for one epoch, ``eval`` of the guided
    Table-I row and ``sim`` of CLI_SIM_SCENES scenes x CLI_SIM_STEPS steps
    under bench.py's heavy contract, both with the e7_round5 weights
    (``--ckpt``).  Each command's tensors must lie on ``dev``, its printed
    JSON be finite and its kernel launches (counts set to 0 just before it
    and read just after) be what its path needs: kernels 6 / 7 once a
    train / val step, kernel 1 once a guided denoise step of every eval
    batch and of its warm-up, and of every closed-loop step.  Where
    matplotlib is installed, one ``train -e`` epoch draws its viz.
    ``width``: ``--set`` pairs appended to every command (a smaller size
    for a rehearsal)."""
    import contextlib
    import importlib.util
    import math
    import shutil
    import torch
    from pstl_tpu_torch import cli, diffusion, eval_openloop, sim, train
    from pstl_tpu_torch import trajopt

    t_phase = time.time()
    shutil.rmtree(CLI_WORK, ignore_errors=True)
    os.makedirs(CLI_WORK)
    ckpt = os.path.join(HERE, "pstl_tpu_torch", "weights", "e7_round5.npz")
    on_dev = lambda x: (x.device if torch.is_tensor(x)
                        else next(x.parameters()).device) == dev

    def run(what, argv, sets=()):
        """``cli_run`` with ``width`` appended: (stdout, counts)."""
        text, counts, _ = cli_run(what, argv, (*sets, *width))
        return text, counts

    cwd = os.getcwd()
    os.chdir(CLI_WORK)
    try:
        with contextlib.ExitStack() as stack:
            calls = {name: stack.enter_context(Recorder(mod, name)).calls
                     for mod, name in ((cli, "check_batches"),
                                       (trajopt, "augment_dataset"),
                                       (train, "train"),
                                       (eval_openloop, "run"),
                                       (sim, "run_closed_loop_host"))}
            _, counts = run("data", ["data", "--out", "cache.npz", "--scenes",
                                     str(CLI_SCENES)])
            check_counts(counts, {}, "cli data")
            text, counts = run("check", ["check", "--cache", "cache.npz"])
            check_counts(counts, {}, "cli check")
            acc = float(text.strip().splitlines()[-1].split("ACC:")[1])
            if not (0.0 <= acc <= 1.0) or not all(
                    c[0][2] == dev for c in calls["check_batches"]):
                raise RuntimeError(f"cli check: ACC {acc}, or off {dev}")
            _, counts = run("trajopt", ["trajopt", "--cache", "cache.npz",
                                        "--out", "aug.npz", "--iters",
                                        str(CLI_TJ_ITERS)])
            check_counts(counts, {}, "cli trajopt")
            if calls["augment_dataset"][0][1]["device"] != dev:
                raise RuntimeError(f"cli trajopt ran off {dev}")

            _, counts = run("train", ["train", "--preset", "e2_vae_mono",
                                      "--cache", "aug.npz", "--epochs", "1"],
                            ["use_pallas_clearance=true", "no_viz=true"])
            (cfg, ds), _, state = calls["train"][0]
            n_tr = ds.split_len("train") // cfg.batch_size
            n_va = ds.split_len("val") // cfg.batch_size
            if n_tr == 0 or not on_dev(state.net):
                raise RuntimeError(f"cli train: {n_tr} train batches, or off "
                                   f"{dev}")
            check_counts(counts, {"min_clearance_fwd": n_tr + n_va,
                                  "min_clearance_bwd": n_tr}, "cli train")

            text, counts = run("eval", ["eval", "--preset", "ours_guidance",
                                        "--cache", "aug.npz", "--ckpt", ckpt,
                                        "--trials", "1"],
                               ["guidance_pallas_fuse_freeze=true"])
            ev = printed_json(text, "cli eval")
            (cfg, ds, net), kw, _ = calls["run"][0]
            cfg = cfg.with_(run_sampling_test=True).finalize()
            n_batches = min(math.ceil(ds.split_len("val") / cfg.batch_size), 2)
            guided = int(diffusion._trigger_schedule(cfg).sum())
            want = guided * (n_batches + 1)
            if not (on_dev(net) and kw["device"] == dev and want > 0):
                raise RuntimeError(f"cli eval ran off {dev}, or unguided")
            check_counts(counts, {"guidance_fused": want}, "cli eval")

            text, counts = run("sim", ["sim", "--scenes", str(CLI_SIM_SCENES),
                                       "--steps", str(CLI_SIM_STEPS), "--ckpt",
                                       ckpt], CLI_HEAVY)
            res = printed_json(text, "cli sim")
            (_, scenes, cfg, net, coeffs), _, out = calls[
                "run_closed_loop_host"][0]
            steps = int(out["traj_len"].max())
            want = guided_steps(cfg) * steps
            if not (on_dev(scenes.ego_full) and on_dev(net)
                    and on_dev(coeffs.beta) and want > 0):
                raise RuntimeError(f"cli sim ran off {dev}, or unguided")
            check_counts(counts, {"guidance_fused": want}, "cli sim")
            log(f"cli sim: kernel 1 launched {counts['guidance_fused']} "
                f"times = {guided_steps(cfg)} guided denoise steps x "
                f"{steps} steps of {len(scenes.ego_full)} scenes; "
                f"stl_compliance="
                f"{res['stl_acc']:.4f} collide={res['collide']:.4f} "
                f"out_of_lane={res['out_of_lane']:.4f}; Table I guided "
                f"nn_acc={ev['nn_acc']:.4f} nn_scene_acc="
                f"{ev['nn_scene_acc']:.4f}")

            if importlib.util.find_spec("matplotlib") is None:
                log("cli train -e: matplotlib is not installed here, so the "
                    "per-epoch viz is not drawn")
            else:
                run("train -e", ["train", "--preset", "e2_vae_mono", "-e",
                                 "cli_viz", "--cache", "aug.npz", "--epochs",
                                 "1"], ["use_pallas_clearance=true",
                                        "num_viz=2"])
                pngs = sorted(os.listdir(os.path.join("exps", "cli_viz",
                                                      "viz")))
                if pngs != ["epoch0000_scene00.png", "epoch0000_scene01.png"]:
                    raise RuntimeError(f"cli train -e drew {pngs}")
                log(f"cli train -e: drew {pngs}")
    finally:
        os.chdir(cwd)
    log(f"cli: phase wall {time.time() - t_phase:.1f} s; {name_power}")


# --------------------------------------------------------------------------
# the parallel layer (phase 34) and the NuScenes extraction (phase 35)
# --------------------------------------------------------------------------

#: phase 34: ranks of its two-rank runs (gloo: NCCL refuses two ranks on
#: one card, so these runs check what the sharding computes and are no
#: scaling figure), scenes and steps of its scene-sharded closed loop,
#: its work directory and the seconds its ranks may take
PAR_WORLD = 2
PAR_SCENES = 16
PAR_STEPS = 4
PAR_WORK = os.path.join(HERE, "build", "parallel_phase")
PAR_TIMEOUT_S = 600
#: phase 35's work directory
EXTRACT_WORK = os.path.join(HERE, "build", "extract_phase")


def par_dense_case():
    """Phase 16's e7_ours step inputs (fp32, stl_weight 1, DENSE_REF_SCENES
    scenes, e5b_round5 base, seeded draws), on the CPU: the same on every
    process."""
    import numpy as np
    from pstl_tpu_torch.data.dataset import SceneDataset
    cfg = dense_config("e7_ours", compute_dtype="float32",
                       batch_size=DENSE_REF_SCENES, stl_weight=1.0)
    ds = SceneDataset.from_synthetic(cfg, seed=5, n_scenes=cfg.batch_size)
    ds.ensure_random_params(cfg.seed)
    batch = with_gt_seed(ds.gather(np.arange(cfg.batch_size)), cfg)
    net = dense_net(cfg, "cpu", seed=2, warm=True)
    return cfg, batch, net, dense_draws(cfg, cfg.batch_size, seed=6)


def par_plan_case(dev):
    """Phase 34c's plan inputs, the same on every process: bench.py's heavy
    contract with the e7_round5 weights, one synthetic scene observed at
    t = 0, and the whole pinned noise of a plan (seeded)."""
    import torch
    from pstl_tpu_torch import diffusion, sim
    from pstl_tpu_torch.config import bench_config
    from pstl_tpu_torch.models import convert
    from pstl_tpu_torch.models.net import Net
    cfg = bench_config("heavy")
    net = Net(cfg)
    convert.load_weights(net, "e7_round5")
    net = net.to(dev).eval()
    scenes = scene_batch(cfg, dev, n_scenes=1)
    obs = sim.observe(scenes, scenes.ego_full[:, 0],
                      torch.zeros(1, dtype=torch.long, device=dev), cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    noise = torch.randn((diffusion.n_draws(cfg), *diffusion.draw_layout(
        cfg, 1, 3 * cfg.n_randoms)), generator=g, device=dev)
    return cfg, net, obs, noise


def timed_plan(plan, obs, noise):
    """One plan with the launch counts set to 0 just before and read just
    after: (u0, info, counts, wall s)."""
    import torch
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    u, info = plan(obs, noise=noise)
    torch.cuda.synchronize()
    return u, info, read_counts(), time.time() - t0


def parallel_worker(rank, run_dir):
    """A rank of phase 34's two-rank runs on the card (``chip_smoke.py
    --parallel-rank <rank> <dir>``): (b) the e7_ours step under a data
    mesh, (c) the candidate-sharded plan (kernel 1 held to its plain
    version on this rank's columns; rank 0 times it while rank 1 waits),
    (d) the scene-sharded closed loop.  Writes its results to
    ``<dir>/out<rank>.pt``."""
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist
    from pstl_tpu_torch import diffusion, sim, specs, train
    from pstl_tpu_torch.ops import _build
    from pstl_tpu_torch.ops import guidance_kernel as gk
    from pstl_tpu_torch.parallel import (candidate_sharding, init_multihost,
                                         make_mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.load_all(LIBS)
    init_multihost(init_method="file://" + os.path.join(run_dir, "store"),
                   world_size=PAR_WORLD, rank=rank, device=dev,
                   backend="gloo", timeout_s=PAR_TIMEOUT_S)
    data_mesh = make_mesh((PAR_WORLD,), ("data",))
    out = {}

    cfg, batch, net, draws = par_dense_case()
    net = net.to(dev)
    step = train.make_train_step(cfg, net, specs.build_scorer(cfg),
                                 diffusion.get_coeffs(cfg, device=dev),
                                 train.make_optimizer(cfg, net),
                                 mesh=data_mesh)
    torch.cuda.synchronize()
    reset_counts()
    rd = step(train.to_device(batch, dev),
              draws={k: v.to(dev) for k, v in draws.items()})
    torch.cuda.synchronize()
    out["e7"] = {"metrics": {k: float(v) for k, v in rd.items()},
                 "counts": read_counts(),
                 "grads": {k: (torch.zeros_like(p) if p.grad is None
                               else p.grad).detach().cpu()
                           for k, p in net.named_parameters()},
                 "state": {k: v.detach().cpu()
                           for k, v in net.state_dict().items()}}

    cfg, net, obs, noise = par_plan_case(dev)
    plan = sim.make_planner(cfg, net, diffusion.get_coeffs(cfg, device=dev))
    with candidate_sharding(make_mesh((PAR_WORLD,), ("cand",)), "cand"):
        timed_plan(plan, obs, noise)            # the warm-up
        with Recorder(gk, "guidance_fused") as rec:
            u, info, counts, wall = timed_plan(plan, obs, noise)
    args = rec.calls[0][0]
    if rank == 0:
        k1 = recorded_kernel1(args, f"the candidate-sharded plan (rank "
                                    f"{rank} of {PAR_WORLD})")
    else:
        ow, oa = gk.guidance_fused(*args)
        pw, pa = gk.guidance_fused_plain(*args)
        k1 = (check_guided(torch.stack([ow, oa]), torch.stack([pw, pa]),
                           torch.stack([args[0], args[1]]),
                           float(args[-2][0]),
                           f"kernel 1 on the candidate-sharded plan (rank "
                           f"{rank} of {PAR_WORLD})"),)
    dist.barrier()
    out["plan"] = {"u": u.cpu(), "plan_traj": info["plan_traj"].cpu(),
                   "scores": info["scores"].cpu(), "counts": counts,
                   "wall": wall, "columns": int(args[0].shape[-1]),
                   "kernel1": k1}

    scenes = sim.shard_scenes(scene_batch(cfg, dev, n_scenes=PAR_SCENES),
                              data_mesh)
    counts, m, walls, _ = run_loop(dev, net, cfg, PAR_STEPS, scenes,
                                   data_mesh)
    out["loop"] = {"metrics": m, "counts": counts, "walls": walls,
                   "scenes": int(scenes.ego_full.shape[0])}
    torch.save(out, os.path.join(run_dir, f"out{rank}.pt"))
    dist.destroy_process_group()
    return 0


def run_parallel_ranks(run_dir):
    """Phase 34's ranks (b)-(d) as PAR_WORLD processes of this script on
    the one card; their output is logged; every process is waited for or
    killed.  Returns each rank's results and the wall s."""
    import subprocess
    import torch
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         str(r), run_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(PAR_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=PAR_TIMEOUT_S)[0],
                         p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (text, rc) in enumerate(outs):
        for ln in text.strip().splitlines():
            log(f"parallel rank {r}: {ln}")
        if rc != 0:
            raise RuntimeError(f"parallel rank {r} exited with {rc}")
    return ([torch.load(os.path.join(run_dir, f"out{r}.pt"),
                        weights_only=False) for r in range(PAR_WORLD)],
            time.time() - t0)


def parallel_phase(dev, name_power):
    """Phase 34: the parallel layer on the card.  (a) ``cli train --mesh
    --preset e2_vae_mono --set use_pallas_clearance=true`` in this process
    (a world-1 mesh, NCCL) for one epoch on phase 33's store: kernels 6 / 7
    launched as without the mesh and every logged metric within MONO_RTOL
    of the same command without ``--mesh``.  Then two gloo ranks of this
    script share the card: (b) phase 16's fp32 e7_ours step under a data
    mesh (4 scenes a rank) against the one-process step on the card
    (DENSE_RTOL, DENSE_GRAD_TOL), both ranks with the same parameters
    after it; (c) one scene of the heavy contract candidate-sharded (96
    of the 192 columns a rank): kernel 1 launched once a denoise step on
    every rank and held to its plain version on the rank's columns, the
    chosen plan (first control and first states) within TABLE2_REF_TOL of
    the unsharded plan's and the candidates' scores within
    EVAL_SCORE_ATOL on all but TABLE2_MAX_OFF_SHARE of the rows; (d)
    PAR_STEPS scene-sharded closed-loop steps of PAR_SCENES scenes, every
    gathered metric finite and kernel 1 once a denoise step on each rank.
    The wall a step, sharded and not, beside the card's name and power
    limit.  Returns kernel 1's record on the candidate-sharded plan
    (launches a rank, error, times, plain ms, bound)."""
    import contextlib
    import io
    import shutil
    import torch
    import torch.distributed as dist
    from pstl_tpu_torch import cli, diffusion, sim, train

    t_phase = time.time()
    runs = []
    real = train.train

    def recorded(*a, **kw):
        hist = []
        state = real(*a, history=hist, **kw)
        runs.append((kw.get("mesh"), hist, read_counts()))
        return state

    argv = ["train", "--preset", "e2_vae_mono", "--cache", "aug.npz",
            "--epochs", "1", "--set", "use_pallas_clearance=true",
            "no_viz=true"]
    cwd = os.getcwd()
    os.chdir(CLI_WORK)
    train.train = recorded
    try:
        for extra in ([], ["--mesh"]):
            torch.cuda.synchronize()
            reset_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(argv + extra)
            torch.cuda.synchronize()
        backend = dist.get_backend()
    finally:
        train.train = real
        os.chdir(cwd)
        if dist.is_initialized():
            dist.destroy_process_group()
    (m0, h0, c0), (m1, h1, c1) = runs
    if m0 is not None or m1 is None or m1.size(0) != 1 or backend != "nccl":
        raise RuntimeError(f"cli train --mesh: mesh {m1}, backend {backend}")
    if c1 != c0 or c1["min_clearance_bwd"] < 1 \
            or c1["min_clearance_fwd"] < c1["min_clearance_bwd"]:
        raise RuntimeError(f"cli train --mesh launched {c1}, without the "
                           f"mesh {c0}")
    err = max(abs(b[k] - a[k]) / (abs(a[k]) + 1e-6)
              for (_, _, a), (_, _, b) in zip(h0, h1) for k in a)
    if len(h1) != len(h0) or not err <= MONO_RTOL:
        raise RuntimeError(f"cli train --mesh: metrics {h1} against {h0}")
    log(f"parallel (a): cli train --mesh --preset e2_vae_mono at world 1 "
        f"({backend}): {len(h1)} batches, kernels 6 / 7 launched "
        f"{c1['min_clearance_fwd']} / {c1['min_clearance_bwd']} times as "
        f"without the mesh; worst metric rel err {err:.3e} (tolerance "
        f"{MONO_RTOL}); loss {h1[0][2]['loss']:.6f}")

    shutil.rmtree(PAR_WORK, ignore_errors=True)
    os.makedirs(PAR_WORK)
    torch.cuda.empty_cache()        # the ranks share the card with us
    outs, wall = run_parallel_ranks(PAR_WORK)
    r0 = outs[0]

    cfg, batch, net, draws = par_dense_case()
    m_one, g_one = dense_step(cfg, net, batch, draws, dev)
    for k, v in r0["e7"]["state"].items():
        if not torch.equal(v, outs[1]["e7"]["state"][k]):
            raise RuntimeError(f"the ranks' {k} differ after the e7 step")
    m_err = max(abs(r0["e7"]["metrics"][k] - m_one[k]) / (abs(m_one[k])
                                                          + 1e-6)
                for k in m_one)
    g_err = grad_err(r0["e7"]["grads"], g_one)
    check_counts(r0["e7"]["counts"], {}, "the sharded e7 step")
    log(f"parallel (b): e7_ours step (fp32, {cfg.batch_size} scenes over "
        f"{PAR_WORLD} gloo ranks) against the one-process step on the card: "
        f"loss {r0['e7']['metrics']['loss']:.6f} vs {m_one['loss']:.6f}; "
        f"worst metric rel err {m_err:.3e} (tolerance {DENSE_RTOL}); worst "
        f"gradient err {g_err:.3e} of its tensor's largest entry (tolerance "
        f"{DENSE_GRAD_TOL}); the ranks' parameters equal")
    if not (m_err <= DENSE_RTOL and g_err <= DENSE_GRAD_TOL):
        raise RuntimeError("the sharded and one-process e7 steps disagree")

    cfg, net, obs, noise = par_plan_case(dev)
    plan = sim.make_planner(cfg, net, diffusion.get_coeffs(cfg, device=dev))
    timed_plan(plan, obs, noise)
    u1, info1, c_one, w_one = timed_plan(plan, obs, noise)
    want = guided_steps(cfg)
    check_counts(c_one, {"guidance_fused": want}, "the unsharded plan")
    for r, o in enumerate(outs):
        p = o["plan"]
        check_counts(p["counts"], {"guidance_fused": want},
                     f"the candidate-sharded plan on rank {r}")
        du = float((p["u"] - u1.cpu()).abs().max())
        dp = float((p["plan_traj"][:, :3] - info1["plan_traj"][:, :3].cpu()
                    ).abs().max())
        off = float(((p["scores"] - info1["scores"].cpu()).abs()
                     > EVAL_SCORE_ATOL).float().mean())
        log(f"parallel (c): rank {r}: kernel 1 launched "
            f"{p['counts']['guidance_fused']} times a plan step on "
            f"{p['columns']} of {3 * cfg.n_randoms} columns (kernel vs "
            f"plain max err {p['kernel1'][0]:.3e}); chosen plan against "
            f"the unsharded plan: first control {du:.3e}, first states "
            f"{dp:.3e} (tolerance {TABLE2_REF_TOL}); scores off by more "
            f"than {EVAL_SCORE_ATOL} on {off:.4f} of the rows (allowed "
            f"{TABLE2_MAX_OFF_SHARE})")
        if not (du <= TABLE2_REF_TOL and dp <= TABLE2_REF_TOL
                and off <= TABLE2_MAX_OFF_SHARE):
            raise RuntimeError(f"the candidate-sharded plan (rank {r}) "
                               f"disagrees with the unsharded plan")

    c_loop, m_one, w_loop, _ = run_loop(
        dev, net, cfg, PAR_STEPS, scene_batch(cfg, dev, n_scenes=PAR_SCENES))
    check_counts(c_loop, {"guidance_fused": want * PAR_STEPS},
                 "the unsharded closed loop")
    for r, o in enumerate(outs):
        lp = o["loop"]
        check_counts(lp["counts"], {"guidance_fused": want * PAR_STEPS},
                     f"the scene-sharded closed loop on rank {r}")
        for k, v in lp["metrics"].items():
            if v.shape != m_one[k].shape:
                raise RuntimeError(f"scene-sharded metric {k}: {v}")
    lp = r0["loop"]
    log(f"parallel (d): {PAR_SCENES} scenes x {PAR_STEPS} steps over "
        f"{PAR_WORLD} gloo ranks ({lp['scenes']} a rank, kernel 1 "
        f"{lp['counts']['guidance_fused']} times on each): stl_compliance "
        f"{float(lp['metrics']['stl_acc'].mean()):.4f} (unsharded "
        f"{float(m_one['stl_acc'].mean()):.4f}), collide "
        f"{float(lp['metrics']['collide'].mean()):.4f}, out_of_lane "
        f"{float(lp['metrics']['out_of_lane'].mean()):.4f}; every metric "
        f"finite")
    log(f"parallel: wall a step on {name_power}: closed loop {PAR_SCENES} "
        f"scenes unsharded {median(w_loop) * 1e3:.1f} ms, scene-sharded "
        f"over {PAR_WORLD} ranks {median(lp['walls']) * 1e3:.1f} ms; one "
        f"heavy plan of 1 scene unsharded {w_one * 1e3:.1f} ms, "
        f"candidate-sharded {r0['plan']['wall'] * 1e3:.1f} ms (two ranks "
        f"on one card through the host: a correctness check, not a "
        f"scaling figure); ranks' run {wall:.1f} s; phase wall "
        f"{time.time() - t_phase:.1f} s")
    err, ms, plain_ms, bnd = r0["plan"]["kernel1"]
    return r0["plan"]["counts"]["guidance_fused"], err, ms, plain_ms, bnd


def extract_phase(dev, name_power):
    """Phase 35: the port's NuScenes extraction on this host, which has no
    jax: ``extract_dataset`` through the jax-free fake devkit
    (``tests/torch_devkit_shim.py``) against the committed golden capsule
    (every array within 1e-6, same dtypes and shapes), then ``cli data
    --real`` under it, whose cache ``SceneDataset`` loads and the closed
    loop's scene tensors take onto the card."""
    import contextlib
    import io
    import shutil
    import numpy as np
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_devkit_shim as shim
    from pstl_tpu_torch import cli, sim
    from pstl_tpu_torch.config import Config
    from pstl_tpu_torch.data import extract
    from pstl_tpu_torch.data.dataset import SceneDataset

    t0 = time.time()
    shutil.rmtree(EXTRACT_WORK, ignore_errors=True)
    os.makedirs(EXTRACT_WORK)
    out = os.path.join(EXTRACT_WORK, "golden.npz")
    with shim.fake_devkit_ctx():
        extract.extract_dataset(Config(**shim.GOLDEN_CFG).finalize(),
                                version="v1.0-mini", dataroot=None,
                                out_path=out,
                                sample_stride=shim.GOLDEN_STRIDE,
                                table_cache_path=None)
    got = dict(np.load(out, allow_pickle=False))
    want = dict(np.load(shim.GOLDEN, allow_pickle=False))
    if sorted(got) != sorted(want) or any(
            got[k].dtype != want[k].dtype or got[k].shape != want[k].shape
            for k in want):
        raise RuntimeError("the extraction's arrays differ from the "
                           "golden capsule's in keys, dtypes or shapes")
    err = max((float(np.max(np.abs(got[k].astype(np.float64)
                                   - want[k].astype(np.float64))))
               if want[k].size else 0.0) for k in want)
    if not err <= 1e-6:
        raise RuntimeError(f"the extraction is {err:.3e} off the golden "
                           f"capsule")
    real = os.path.join(EXTRACT_WORK, "real.npz")
    with shim.fake_devkit_ctx(), contextlib.redirect_stdout(io.StringIO()):
        cli.main(["data", "--real", "--out", real, "--version", "v1.0-mini",
                  "--dataroot", EXTRACT_WORK, "--t-stride", "6", "--set",
                  "n_neighbors=2"])
    cfg = Config(n_neighbors=2).finalize()
    ds = SceneDataset.load(real, cfg)
    scenes = sim.scenes_from_dataset(dict(np.load(real)), device=dev)
    if len(ds) < 1 or scenes.ego_full.device != dev:
        raise RuntimeError(f"cli data --real: {len(ds)} samples")
    log(f"extract: {len(want)} arrays of the golden capsule reproduced "
        f"(max err {err:.1e}, tolerance 1e-6); cli data --real wrote "
        f"{len(ds)} samples of {scenes.ego_full.shape[0]} scenes, loaded "
        f"by SceneDataset and onto {dev}; phase wall "
        f"{time.time() - t0:.1f} s; {name_power}")


# --------------------------------------------------------------------------
# the formula tree, constant-velocity neighbors and grad_rollout (phase 36)
# --------------------------------------------------------------------------

#: phase 36: trajopt iterations a scorer; epochs of the command-line runs
#: on phase 33's store (one train batch of 128 scenes an epoch, no full val
#: batch): e2 under gt_nei=False, e5 under grad_rollout
TREE_ITERS = 20
CV_EPOCHS = 8
GR_EPOCHS = 4
# the tree against the bank (phase 36 (a)): tests/test_clause_bank.py's
# tolerances, scores 2e-4 and the hinge's gradient rtol 1e-3 / atol 1e-5
# element by element.  The bank takes an Always(0, T) clause's soft min in
# one logsumexp where the tree reads the first entry of a reverse
# logcumsumexp, so their gradients round differently, and where a control's
# gradient is a sum of clause terms that cancel (rows near satisfaction)
# that rounding stays at the terms' scale.  So at most TREE_MAX_OFF_SHARE
# of the elements may lie beyond the per-element bound, and every element
# must lie within TREE_ROW_BOUND of its own row's largest entry.  A witness
# in fp64 (the bank's reductions on the same signals) shows which scorer
# each element beyond the bound sides with; in fp32 both scorers lie off it
# by as much as they lie off each other.  So the tree must be about as
# accurate as the bank against it: its worst row's distance (over the
# row's largest entry) at most TREE_WITNESS_SLACK times the bank's (or
# TREE_GRAD_RTOL), its elements beyond rtol / atol of the witness at most
# TREE_WITNESS_SLACK times the bank's plus a share TREE_WITNESS_FLOOR.  The
# measured values and the witness's verdict are in PERF.md (phase 36 (a))
TREE_SCORE_ATOL = 2e-4
TREE_GRAD_RTOL, TREE_GRAD_ATOL = 1e-3, 1e-5
TREE_MAX_OFF_SHARE = 3e-4
TREE_ROW_BOUND = 2e-2
TREE_WITNESS_SLACK, TREE_WITNESS_FLOOR = 1.25, 1e-5


def tree_phase(dev, store, name_power):
    """Phase 36 (a): ``specs.build_formulas``' tree against the
    ``ClauseBank`` on phase 20's layout (the store's first e1_trajopt batch
    of 1,024 scenes x 64 x 3 rows, K flex draws): on its optimized controls
    and on its random control seeds, the three formulas' scores soft and
    hard and the gradient of the summed trajopt hinge with respect to the
    controls; then, from the seeds, TREE_ITERS
    ``trajopt.optimize`` iterations with each, timed (host clock + sync),
    device launches and ms an iteration (profiled apart), peak memory."""
    import numpy as np
    import torch
    from pstl_tpu_torch import specs, trajopt
    from pstl_tpu_torch.ops import dynamics as dyn

    t0 = time.time()
    cfg = e1_config()
    K, M, nt = cfg.trajopt_robust_draws, cfg.n_randoms, cfg.nt
    b = store.gather(np.arange(cfg.batch_size))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    p_opt, st, sb, hl, stack, valid = trajopt_inputs(
        cfg, b, trajopt.batch_draws(cfg.batch_size, K, gen, dev), dev)
    p0 = torch.as_tensor(b["params_init"], device=dev)
    n = valid.shape[0]
    states = torch.repeat_interleave(st, M * 3, 0)
    scorers = {"bank": specs.build_scorer(cfg),
               "tree": specs.build_formulas(cfg)}

    def scores_grad(form, hard, p):
        x = p.reshape(n, nt, 2).detach().requires_grad_(not hard)
        trajs = dyn.rollout(states, x, cfg.dt)
        sl, s, _ = specs.compute_scores(dict(sb, ego_traj=trajs[:, :-1]),
                                        form, hl, valid, cfg, hard=hard)
        g = None if hard else torch.autograd.grad(
            torch.relu(cfg.stl_trajopt_thres - s).sum(), x)[0]
        return torch.stack(sl[:3]).detach(), g

    def witness(p):
        """The hinge's gradient with the bank's reductions in fp64: the
        fp32 signals both scorers read, cast up; the bank's cotangents on
        them in fp64, carried to the controls by the signals' own VJP."""
        x = p.reshape(n, nt, 2).detach().requires_grad_()
        trajs = dyn.rollout(states, x, cfg.dt)
        sig = specs.prep_signals(dict(sb, ego_traj=trajs[:, :-1]), cfg)
        live = [k for k, v in sig.items()
                if torch.is_tensor(v) and v.requires_grad]
        up = {k: v.detach().double().requires_grad_(k in live)
              if torch.is_tensor(v) and v.is_floating_point() else v
              for k, v in sig.items()}
        bank = specs.build_scorer(cfg)
        bank.dtype = torch.float64
        _, s, _ = specs.compute_scores(up, bank, hl, valid, cfg)
        cot = torch.autograd.grad(
            torch.relu(cfg.stl_trajopt_thres - s).sum(),
            [up[k] for k in live])
        return torch.autograd.grad([sig[k] for k in live], x,
                                   [c.float() for c in cot])[0]

    def row_err(d, top):
        """Each row's largest |d| over its largest entry ``top`` (n,)."""
        return d.flatten(1).amax(1) / top.clamp_min(TREE_GRAD_ATOL)

    torch.cuda.reset_peak_memory_stats()
    for what, p in (("optimized", p_opt), ("seeds", p0)):
        for hard in (False, True):
            (s_b, g_b), (s_t, g_t) = (scores_grad(f, hard, p)
                                      for f in scorers.values())
            err = float((s_t - s_b).abs().max())
            log(f"tree vs bank ({what} controls, "
                f"{'hard' if hard else 'soft'}, {n} rows): scores "
                f"max_abs_err={err:.3e} (tolerance {TREE_SCORE_ATOL}); "
                f"satisfied {float((s_b > 0).float().mean()):.4f} of the "
                f"(row, formula) pairs")
            if not (torch.isfinite(s_t).all() and err <= TREE_SCORE_ATOL):
                raise RuntimeError("the formula tree's scores disagree with "
                                   "the clause bank's")
            if hard:
                continue
            d = (g_t - g_b).abs()
            off = d > TREE_GRAD_ATOL + TREE_GRAD_RTOL * g_b.abs()
            share = float(off.float().mean())
            top = g_b.abs().flatten(1).amax(1)
            rows = row_err(d, top)
            g64 = witness(p)
            e_t, e_b = (g_t - g64).abs(), (g_b - g64).abs()
            top64 = g64.abs().flatten(1).amax(1)
            r_t, r_b = row_err(e_t, top64), row_err(e_b, top64)
            tol64 = TREE_GRAD_ATOL + TREE_GRAD_RTOL * g64.abs()
            far_t, far_b = int((e_t > tol64).sum()), int((e_b > tol64).sum())
            by_t = int((off & (e_t < e_b)).sum())
            worst = int(torch.argmax(rows))
            log(f"tree vs bank gradient of the summed hinge ({what}): "
                f"max_abs_err={float(d.max()):.3e} (largest entry "
                f"{float(top.max()):.3e}); beyond rtol {TREE_GRAD_RTOL} / "
                f"atol {TREE_GRAD_ATOL}: {int(off.sum())} of {off.numel()} "
                f"(share {share:.2e}, allowed {TREE_MAX_OFF_SHARE}) in "
                f"{int(off.flatten(1).any(1).sum())} rows; the worst row's "
                f"error {float(rows[worst]):.3e} of its largest entry "
                f"{float(top[worst]):.3e} (allowed {TREE_ROW_BOUND})")
            log(f"fp64 witness ({what}): of the {int(off.sum())} elements "
                f"beyond the bound it lies nearer the tree's on {by_t}, the "
                f"bank's on {int(off.sum()) - by_t}; its distance, worst row "
                f"over its largest entry: tree {float(r_t.max()):.3e}, bank "
                f"{float(r_b.max()):.3e}; beyond rtol {TREE_GRAD_RTOL} / "
                f"atol {TREE_GRAD_ATOL} of it: tree {far_t}, bank {far_b} "
                f"(the tree's allowed {TREE_WITNESS_SLACK} times the bank's, "
                f"plus a share {TREE_WITNESS_FLOOR})")
            if (not float(top.max()) > 0 or share > TREE_MAX_OFF_SHARE
                    or float(rows.max()) > TREE_ROW_BOUND
                    or float(r_t.max()) > TREE_WITNESS_SLACK * max(
                        float(r_b.max()), TREE_GRAD_RTOL)
                    or far_t > TREE_WITNESS_SLACK * far_b
                    + TREE_WITNESS_FLOOR * off.numel()):
                raise RuntimeError("the formula tree's gradient disagrees "
                                   "with the clause bank's")
            del g_b, g_t, g64, d, off, e_t, e_b, tol64
    log(f"tree vs bank: peak device memory of the comparison "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    res = {}
    for name, form in scorers.items():
        iter_s, mark = [], [None]

        def on_iter(i):
            torch.cuda.synchronize()
            now = time.perf_counter()
            if i > 0:
                iter_s.append(now - mark[0])
            mark[0] = now

        run = lambda iters, hook=None: trajopt.optimize(
            p0, st, sb, hl, form, cfg, iters=iters, stlp_draws=stack,
            on_iter=hook)
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        _, scores, _ = run(TREE_ITERS, on_iter)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_counts(read_counts(), {}, f"trajopt with the {name}")
        if not torch.isfinite(scores).all():
            raise RuntimeError(f"trajopt with the {name}: scores not finite")
        prof = {k: profile_calls(lambda: run(k), 1) for k in (1, 3)}
        res[name] = (median(iter_s) * 1e3, (prof[3][0] - prof[1][0]) / 2,
                     (prof[3][1] - prof[1][1]) / 2, peak,
                     valid_rate(scores, valid))
        log(f"trajopt with the {name} ({n} rows, K={K}, {TREE_ITERS} "
            f"iterations): median iteration {res[name][0]:.2f} ms (host "
            f"clock + sync), {res[name][1]:.0f} device launches and "
            f"{res[name][2]:.2f} device ms an iteration (profiled apart), "
            f"peak device memory {peak:.2f} GiB, satisfaction after "
            f"{res[name][4]:.4f}; {name_power}")
    if abs(res["tree"][4] - res["bank"][4]) > 0.01:
        raise RuntimeError("trajopt with the tree and with the bank reach "
                           "different satisfaction")
    log(f"formula tree: {res['tree'][0] / res['bank'][0]:.2f}x the bank's "
        f"iteration, peak memory {res['tree'][3]:.2f} against "
        f"{res['bank'][3]:.2f} GiB; phase wall {time.time() - t0:.1f} s")


def cv_phase(dev, name_power, width=()):
    """Phase 36 (b), the constant-velocity neighbors (``gt_nei=False``):
    phase 14's card-vs-CPU e2 step on the ``swerving_neighbor`` scenes,
    then ``cli train --preset e2_vae_mono --set gt_nei=false`` for
    CV_EPOCHS epochs on phase 33's store passed through
    ``swerving_neighbor`` (the synthetic neighbors drive at constant
    velocity, so on the store itself the prediction would equal the GT
    tracks): kernels 6 / 7 once a train step, each then held against its
    plain version on the first step's own inputs (phase 13's tolerances)
    and timed there.  Returns per kernel (launches, max error, times, plain
    ms, bound).  ``width``: ``--set`` pairs appended (a smaller size for a
    rehearsal)."""
    import numpy as np
    import torch
    from pstl_tpu_torch import train
    from pstl_tpu_torch.config import PRESETS
    from pstl_tpu_torch.ops import clearance_kernel as ck
    from pstl_tpu_torch.ops import dynamics as dyn

    t0 = time.time()
    mono_reference_phase(dev, swerve=True, gt_nei=False,
                         what="constant-velocity reference step")
    pre = PRESETS["e2_vae_mono"]
    data = dict(np.load(os.path.join(CLI_WORK, "aug.npz"),
                        allow_pickle=False))
    swerved = swerving_neighbor(data, pre)
    if "neighbors" not in data:
        swerved.pop("neighbors")
    np.savez(os.path.join(CLI_WORK, "aug_swerve.npz"), **swerved)
    gaps = {}
    for what, b in (("store", data), ("swerved store", swerved)):
        nei = torch.as_tensor(b["neighbors_traj"])
        pred = dyn.neighbor_rollout(nei[:, :, 0], nei.shape[2], pre.dt,
                                    full=True)
        gap = torch.linalg.vector_norm(pred[..., 1:3] - nei[..., 1:3],
                                       dim=-1)[nei[..., 0] > 0]
        gaps[what] = float(gap.max())
        log(f"constant-velocity prediction against the GT tracks "
            f"({what}, {nei.shape[0]} scenes x {nei.shape[1]} neighbors x "
            f"{nei.shape[2]} frames): max {gaps[what]:.3e} m, mean "
            f"{float(gap.mean()):.3e} m")
    if not gaps["swerved store"] > 1.0:
        raise RuntimeError("the swerved store's neighbors stay on their "
                           "constant-velocity tracks")
    with Recorder(ck, "min_clearance_fwd") as rf, \
            Recorder(ck, "min_clearance_bwd") as rb, \
            Recorder(train, "train") as rt:
        _, counts, wall = cli_run(
            "train (gt_nei=false)",
            ["train", "--preset", "e2_vae_mono", "--cache", "aug_swerve.npz",
             "--epochs", str(CV_EPOCHS)],
            ["gt_nei=false", "use_pallas_clearance=true", "no_viz=true",
             *width])
    (cfg, ds), _, _ = rt.calls[0]
    n_tr = ds.split_len("train") // cfg.batch_size
    n_va = ds.split_len("val") // cfg.batch_size
    if cfg.gt_nei or n_tr == 0:
        raise RuntimeError(f"cli train ran gt_nei={cfg.gt_nei}, {n_tr} "
                           f"train batches")
    check_counts(counts, {"min_clearance_fwd": (n_tr + n_va) * CV_EPOCHS,
                          "min_clearance_bwd": n_tr * CV_EPOCHS},
                 "cli train (gt_nei=false)")
    (ego, nei, L, W, nL, m), _, _ = rf.calls[0]
    (ego_b, nei_b, g, *_), _, _ = rb.calls[0]
    n = ego.shape[0]
    if not (torch.equal(ego, ego_b) and torch.equal(nei, nei_b)):
        raise RuntimeError("the clearance kernels read different inputs in "
                           "one step")
    res = {}
    for k, call, plain, operands, rtol, near in (
            ("fwd", lambda: ck.min_clearance_fwd(ego, nei, L, W, nL, m),
             lambda: ck.min_clearance_fwd_plain(ego, nei, L, W, nL, m),
             (ego, nei), CLEAR_FWD_RTOL, None),
            ("bwd", lambda: ck.min_clearance_bwd(ego, nei, g, L, W, nL, m),
             lambda: ck.min_clearance_bwd_plain(ego, nei, g, L, W, nL, m),
             (ego, nei, g), CLEAR_BWD_RTOL,
             clearance_near_ties(ego, nei, L, W, nL, CLEAR_TIE_M, m))):
        out, ref = call(), plain()
        torch.cuda.synchronize()
        err = clearance_check(f"constant-velocity clearance {k} (cli train "
                              f"step inputs)", out, ref, rtol, near)
        n_bytes = nbytes(*operands, out)
        ops = clearance_ops(n, nei.shape[1], cfg.nt, nL, k == "bwd", m)
        ms, plain_ms, bnd = kernel_ms(call), time_cuda(plain), bound(
            n_bytes, ops)
        res[k] = (counts[f"min_clearance_{k}"], err, ms, plain_ms, bnd)
        log(f"constant-velocity clearance {k} (n={n}, {n // m} neighbor "
            f"sets x {m} rows): kernel {ms['graph_ms']:.4f} ms (graph "
            f"replay), one eager call {ms['ms']:.4f} ms, plain "
            f"{plain_ms:.4f} ms; bound {bnd[0]:.5f} ms ({bnd[1]}); "
            f"launches {res[k][0]}")
    log(f"cli train (gt_nei=false): {n_tr * CV_EPOCHS} train steps of "
        f"{cfg.batch_size} scenes x {cfg.n_randoms} in {wall:.2f} s; "
        f"{name_power}; phase wall {time.time() - t0:.1f} s")
    return res


class StepTimer:
    """``train.make_train_step``'s steps timed while it runs (``with
    StepTimer() as st``): ``st.step_s`` holds each step's host clock with a
    device sync after it, ``st.last`` the last (step, batch)."""

    def __enter__(self):
        import torch
        from pstl_tpu_torch import train
        self.step_s, self.last = [], None
        self.real = real = train.make_train_step

        def make(*a, **kw):
            step = real(*a, **kw)

            def timed(batch, *sa, **skw):
                t0 = time.time()
                out = step(batch, *sa, **skw)
                torch.cuda.synchronize()
                self.step_s.append(time.time() - t0)
                self.last = (step, batch)
                return out
            return timed

        train.make_train_step = make
        return self

    def __exit__(self, *exc):
        from pstl_tpu_torch import train
        train.make_train_step = self.real


def grad_rollout_phase(dev, name_power, width=()):
    """Phase 36 (c), training through the sampler (``grad_rollout``):
    phase 16's card-vs-CPU step on e5_ddpm with grad_rollout and stl_weight
    1 (its scenes, weights, pinned draws and tolerances), then ``cli train
    --preset e5_ddpm --set grad_rollout=true stl_weight=1.0`` for GR_EPOCHS
    epochs on phase 33's store (128 scenes x 64 x 3 = 24,576 rows a step,
    99 differentiated denoise steps): the median step, device launches a
    step (one more step, profiled), peak memory; no kernel launches.
    Phase 16's tolerances hold through the 99 differentiated steps: on the
    CPU a one-ulp move of every nonzero weight moves this step's metrics by
    2.2e-6 and its gradients by 3.6e-5 of their tensors' largest entries
    (``scripts/ulp_sensitivity.py --set grad_rollout=true
    stl_weight=1.0``).
    ``width``: ``--set`` pairs appended (a smaller size for a rehearsal)."""
    import torch
    from pstl_tpu_torch import train

    t0 = time.time()
    dense_reference_phase(dev, (("e5_ddpm grad_rollout", "e5_ddpm", {
        "grad_rollout": True, "stl_weight": 1.0}),),
        "grad_rollout reference")
    torch.cuda.reset_peak_memory_stats()
    with StepTimer() as st, Recorder(train, "train") as rt:
        _, counts, wall = cli_run(
            "train (grad_rollout)",
            ["train", "--preset", "e5_ddpm", "--cache", "aug.npz", "--epochs",
             str(GR_EPOCHS)],
            ["grad_rollout=true", "stl_weight=1.0", "no_viz=true", *width])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_counts(counts, {}, "cli train (grad_rollout)")
        (cfg, ds), _, state = rt.calls[0]
        step, batch = st.last
        launches, dev_ms, prof_wall, _ = profile_calls(lambda: step(batch),
                                                       1)
    vals = {k: float(v) for k, v in step(batch).items()}
    check_finite(vals, "grad_rollout step")
    n_tr = ds.split_len("train") // cfg.batch_size
    if not (cfg.grad_rollout and vals["loss_stl"] > 0
            and len(st.step_s) == n_tr * GR_EPOCHS):
        raise RuntimeError(f"cli train (grad_rollout): grad_rollout "
                           f"{cfg.grad_rollout}, loss_stl "
                           f"{vals['loss_stl']}, {len(st.step_s)} steps")
    rows = cfg.batch_size * cfg.n_randoms * 3
    log(f"cli train (grad_rollout): {len(st.step_s)} steps of {rows} rows, "
        f"{cfg.diffusion_steps - 1} differentiated denoise steps: median step "
        f"{median(st.step_s) * 1e3:.1f} ms (host clock + sync; "
        f"first {st.step_s[0] * 1e3:.1f} ms), {launches:.0f} device launches "
        f"and {dev_ms:.1f} device ms a step (busy {dev_ms / prof_wall:.3f}, "
        f"profiled apart), peak device memory {peak:.2f} GiB; last "
        + " ".join(f"{k}={v:.4f}" for k, v in sorted(vals.items()))
        + f"; {name_power}; phase wall {time.time() - t0:.1f} s")


def unet_norm_check(what, got, ref):
    """The largest error of the U-Net's activation pass against its plain
    version (phase 37's tolerances); raises beyond them."""
    import torch
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    rtol = UNET_BF16_RTOL if got.dtype == torch.bfloat16 else UNET_F32_RTOL
    off = float((err > rtol * r.abs() + UNET_ATOL).float().mean())
    flips = float((g != r).float().mean())
    if off > 0 or (got.dtype == torch.bfloat16
                   and flips > UNET_MAX_FLIP_SHARE):
        raise RuntimeError(f"{what}: {off:.3e} of the elements beyond rtol "
                           f"{rtol:.3e} / atol {UNET_ATOL}, {flips:.3e} not "
                           f"equal to the bit (at most "
                           f"{UNET_MAX_FLIP_SHARE})")
    return float(err.max())


def unet_norm_phase(dev, name_power):
    """Phase 37: ConditionalUnet1D's activation pass on the 25 calls of one
    full-width forward at UNET_ROWS rows (seeded weights, bf16), recorded
    as the forward makes them: each launch against the plain version, its
    times (``kernel_ms``), the plain version's and PyTorch's
    ``F.group_norm`` + ``F.mish`` on the same values in the (n, C, L)
    float32 layout (``library_ms``: timed only, the port never calls it),
    and its bound (bytes over 3.35 TB/s: each call reads its conv output,
    bias, GroupNorm's affine, the FiLM or the residual once and writes its
    outputs once), all summed over the pass.  Then a profiled forward,
    which must show no cuDNN NCHW <-> NHWC transpose and no PyTorch
    GroupNorm kernel.  Returns (launches, max error, times, plain ms,
    bound, library ms)."""
    import torch
    import torch.nn.functional as F
    from pstl_tpu_torch.models import unet1d
    from pstl_tpu_torch.ops import unet1d_norm as un

    t0 = time.time()
    net = unet1d.ConditionalUnet1D(2, 231, unet1d.UnetSpec())
    unet1d.init_torch_default(net, torch.Generator().manual_seed(0))
    net = net.to(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(UNET_ROWS, 2, 20, device=dev, generator=g)
    c = torch.randn(UNET_ROWS, 231, device=dev, generator=g)
    t = torch.full((1,), 50.0, device=dev)
    w = unet1d.unet_weights(net, torch.bfloat16)
    before = un.launches
    with torch.no_grad(), Recorder(un, "norm_mish", n=25) as rec:
        unet1d.forward(net, w, x, t, c)
        torch.cuda.synchronize()
    launches = un.launches - before
    if launches != 25 or len(rec.calls) != 25:
        raise RuntimeError(f"a U-Net forward made {launches} launches of "
                           f"the activation pass, expected 25")
    err, n_bytes = 0.0, 0
    tot = {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    kinds = {}
    with torch.no_grad():
        for a, kw, (out, out32) in rec.calls:
            y, bias, gamma, beta, groups, eps = a
            ref, ref32 = un.norm_mish_plain(*a, **kw)
            kind = ("film" if kw.get("film") is not None else
                    "identity" if kw.get("res_bias") is None
                    and kw.get("res") is not None else
                    "conv residual" if kw.get("res") is not None else
                    "final")
            what = f"activation pass {tuple(y.shape)} {kind}"
            err = max(err, unet_norm_check(what, out, ref))
            if ref32 is not None:
                err = max(err, unet_norm_check(what + " (fp32 stream)",
                                               out32, ref32))
            xl = (y.float() + bias.float()).transpose(1, 2).contiguous()
            ms = kernel_ms(lambda: un.norm_mish(*a, **kw))
            times = {**ms, "plain_ms": time_cuda(
                lambda: un.norm_mish_plain(*a, **kw)),
                "library_ms": time_cuda(lambda: F.mish(F.group_norm(
                    xl, groups, gamma, beta, eps)))}
            for k, v in times.items():
                tot[k] += v
            b = nbytes(y, bias, gamma, beta, *(kw.get(k) for k in (
                "film", "res", "res_bias")), out, out32)
            n_bytes += b
            key = (tuple(y.shape[1:]), kind)
            kinds.setdefault(key, []).append((times["graph_ms"], b))
    for (shape, kind), vals in sorted(kinds.items()):
        gms = sum(v[0] for v in vals)
        log(f"activation pass (L, C) = {shape}, {kind}: {len(vals)} a "
            f"pass, kernel {gms / len(vals) * 1e3:.1f} us a launch (graph "
            f"replay), {sum(v[1] for v in vals) / gms / 1e9:.3f} TB/s")
    bnd = bound(n_bytes, 0)
    ms = {"ms": tot["ms"], "graph_ms": tot["graph_ms"]}
    with torch.no_grad():
        unet1d.forward(net, w, x, t, c)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            unet1d.forward(net, w, x, t, c)
            torch.cuda.synchronize()
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")}
    for bad in ("nchwToNhwc", "nhwcToNchw", "RowwiseMoments"):
        if any(bad in k for k in dev_us):
            raise RuntimeError(f"a channels-last U-Net forward ran {bad}")
    in_pass = sum(v for k, v in dev_us.items() if "norm_mish" in k) / 1e3
    log(f"activation pass, a forward of {UNET_ROWS} rows: 25 launches, "
        f"kernel {ms['graph_ms']:.4f} ms (graph replays, summed), one eager "
        f"call each {ms['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
        f"F.group_norm + F.mish {tot['library_ms']:.4f} ms; bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}, {n_bytes / 1e9:.3f} GB); max error "
        f"{err:.3e}; in a profiled forward {in_pass:.4f} of "
        f"{sum(dev_us.values()) / 1e3:.4f} device ms, {len(dev_us)} "
        f"kernels by name, none a layout transpose or a GroupNorm; "
        f"{name_power}; phase wall {time.time() - t0:.1f} s")
    return launches, err, ms, tot["plain_ms"], bnd, tot["library_ms"]


def phase_36_alone(dev, name_power):
    """``chip_smoke.py --phase 36``: phase 36 without phases 1-35 and without
    the result lines.  Its inputs are made here: phase 33's store (phase 33
    runs) and an e1_trajopt batch of synthetic scenes optimized for
    E1_ITERS iterations as phase 20 optimizes phase 15's."""
    from pstl_tpu_torch import specs, trajopt
    from pstl_tpu_torch.data.dataset import SceneDataset

    cli_phase(dev, name_power)
    cfg = e1_config()
    store = SceneDataset.from_synthetic(cfg, seed=cfg.seed,
                                        n_scenes=cfg.batch_size)
    trajopt.augment_dataset(store, cfg, specs.build_scorer(cfg),
                            batch_size=cfg.batch_size, iters=E1_ITERS,
                            seed=cfg.seed, device=dev, log=log)
    t_ph = time.time()
    tree_phase(dev, store, name_power)
    cv_phase(dev, name_power)
    grad_rollout_phase(dev, name_power)
    log(f"phase 36 wall {time.time() - t_ph:.1f} s; {name_power}")
    return 0


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--parallel-rank":
        return parallel_worker(int(sys.argv[2]), sys.argv[3])
    if not os.path.isdir(os.path.join(HERE, "pstl_tpu_torch")):
        print("chip_smoke.py: the pstl_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "false); the port has no CPU path here", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name_power = gpu_name_power()
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible); nvidia-smi: {name_power}")

    from pstl_tpu_torch.config import bench_config
    from pstl_tpu_torch.models import convert
    from pstl_tpu_torch.models.net import Net
    from pstl_tpu_torch.ops import _build

    t0 = time.time()
    _build.load_all(LIBS)
    for name in LIBS:
        info = _build.BUILD_INFO[name]
        geom = " ".join(f"{k}={v}" for k, v in geometry(name).items())
        log(f"build: {name} (nvcc {info['build_s']:.2f} s); geometry: "
            f"{geom or 'fixed'}")
        for ln in _build.ptxas_summary(info["report"]):
            log(f"build: {name} ptxas: {ln}")
    log(f"build: {len(LIBS)} libraries in {time.time() - t0:.2f} s")

    if sys.argv[1:] == ["--phase", "36"]:
        return phase_36_alone(dev, name_power)
    if sys.argv[1:] == ["--phase", "37"]:
        unet_norm_phase(dev, name_power)
        return 0

    max_err, ms, plain_ms, k_bound = kernel_phase(dev)

    net = Net(bench_config("heavy"))
    convert.load_weights(net, "e7_round5")
    net = net.to(dev).eval()
    ss_err, ss_ms, ss_plain_ms, ss_bound = superstep_phase(dev, net)
    fz_err, fz_ms, fz_plain_ms, fz_bound = frozen_phase(dev)

    net_cpu = Net(bench_config("heavy").with_(compute_dtype="float32"))
    convert.load_weights(net_cpu, "e7_round5")
    net_dev = Net(bench_config("heavy").with_(compute_dtype="float32"))
    convert.load_weights(net_dev, "e7_round5")
    reference_phase(dev, net_cpu.eval(), net_dev.to(dev).eval())
    t1 = time.time()
    reference_phase(dev, net_cpu.eval(), net_dev.to(dev).eval(),
                    routes=(("1", 1), ("1", 2)))
    log(f"frozen reference: phase wall {time.time() - t1:.1f} s")

    launches, _, _, _, _, step_med = route_phase(dev, net, "2", STEPS)
    f2_launches, f2_err, f2_ms, f2_plain_ms, f2_bound, _ = route_phase(
        dev, net, "3", FOLD2_STEPS)
    ss_launches, ss_step_med = superstep_loop_phase(dev, net)
    fz_launches, _, _, _, _, fz_step_med = route_phase(dev, net, "1", STEPS)
    f1_launches, f1_err, f1_ms, f1_plain_ms, f1_bound, _ = route_phase(
        dev, net, "1f", ROUTE_STEPS)
    ff_launches, ff_err, ff_ms, ff_plain_ms, ff_bound, _ = route_phase(
        dev, net, "2f", ROUTE_STEPS)
    route_phase(dev, net, "1", ROUTE_STEPS, sel_every=2)
    _, _, _, _, _, xla_step_med = route_phase(dev, net, "0", ROUTE_STEPS)
    log(f"median closed-loop step, heavy contract: default path "
        f"{step_med * 1e3:.1f} ms, superstep {ss_step_med * 1e3:.1f} ms, "
        f"frozen payloads {fz_step_med * 1e3:.1f} ms, XLA guidance loop "
        f"{xla_step_med * 1e3:.1f} ms")

    clear = clearance_phase(dev)
    mono_reference_phase(dev)
    mono_counts, ds, e2_net = mono_train_phase(dev)
    dense_reference_phase(dev)
    dense_train_phase(dev, ds, name_power)
    dense_checkpoint_phase(dev, ds)
    t_ph = time.time()
    trajopt_reference_phase(dev, ds)
    log(f"phase 19 wall {time.time() - t_ph:.1f} s")
    t_ph = time.time()
    store = e1_phase(dev, ds, name_power)
    log(f"phase 20 wall {time.time() - t_ph:.1f} s")
    t_ph = time.time()
    eval_reference_phase(dev, store)
    log(f"phase 21 wall {time.time() - t_ph:.1f} s")
    t_ph = time.time()
    ev_launches, ev_err, ev_ms, ev_plain_ms, ev_bound = table1_phase(
        dev, store, name_power)
    log(f"phase 22 wall {time.time() - t_ph:.1f} s")
    t_ph = time.time()
    table2_reference_phase(dev)
    log(f"phase 23 wall {time.time() - t_ph:.1f} s")
    t_ph = time.time()
    t2_launches, t2_err, t2_ms, t2_plain_ms, t2_bound = table2_phase(
        dev, name_power)
    log(f"phase 24 wall {time.time() - t_ph:.1f} s")
    t_ph = time.time()
    dense_reference_phase(dev, BASELINES, "baseline reference")
    log(f"phase 25 wall {time.time() - t_ph:.1f} s; {name_power}")
    t_ph = time.time()
    nets = dict(baseline_train_phase(dev, store, name_power), e2=e2_net)
    log(f"phase 26 wall {time.time() - t_ph:.1f} s; {name_power}")
    t_ph = time.time()
    cg_launches, cg_err, cg_ms, cg_plain_ms, cg_bound = \
        table1_baseline_phase(dev, store, nets, name_power)
    log(f"phase 27 wall {time.time() - t_ph:.1f} s; {name_power}")
    t_ph = time.time()
    cg2_launches = table2_baseline_phase(dev, nets, name_power)
    log(f"phase 28 wall {time.time() - t_ph:.1f} s; kernel 1 on the ctg "
        f"rows: {cg_launches} launches on Table I, {cg2_launches} on Table "
        f"II; {name_power}")
    sampler_reference_phase(dev, net_cpu.eval(), net_dev.eval())
    t_ph = time.time()
    dd_launches, dd_err, dd_ms, dd_plain_ms, dd_bound = sampler_loop_phase(
        dev, net, name_power)
    log(f"phase 30 wall {time.time() - t_ph:.1f} s; {name_power}")
    t_ph = time.time()
    guided_train_phase(dev, ds, name_power)
    log(f"phase 31 wall {time.time() - t_ph:.1f} s")
    t_ph = time.time()
    shard_store_phase(dev, store, name_power)
    log(f"phase 32 wall {time.time() - t_ph:.1f} s")
    cli_phase(dev, name_power)
    t_ph = time.time()
    pr_launches, pr_err, pr_ms, pr_plain_ms, pr_bound = parallel_phase(
        dev, name_power)
    log(f"phase 34 wall {time.time() - t_ph:.1f} s")
    extract_phase(dev, name_power)
    t_ph = time.time()
    tree_phase(dev, store, name_power)
    cv = cv_phase(dev, name_power)
    grad_rollout_phase(dev, name_power)
    log(f"phase 36 wall {time.time() - t_ph:.1f} s; {name_power}")
    un_launches, un_err, un_ms, un_plain_ms, un_bound, un_lib_ms = \
        unet_norm_phase(dev, name_power)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd):
        # no single PyTorch call computes any of the TPU kernels' functions,
        # so there is no library time to set beside them (the U-Net's
        # activation pass, which replaces no TPU kernel, sets its own)
        return {"name": name, "route": "cuda",
                "source": "pstl_tpu_torch/csrc/" + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, **ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    at = "pstl_tpu/ops/pallas_guidance.py:"
    pk = "pstl_tpu/ops/pallas_kernels.py:"
    fused, frozen = "guidance_fused", "guidance_frozen"
    print(json.dumps({"kernels": [
        entry(fused, "guidance_fused.cu", at + "396", launches, max_err, ms,
              plain_ms, k_bound),
        entry(fused, "guidance_fused.cu", at + "495", f2_launches, f2_err,
              f2_ms, f2_plain_ms, f2_bound),
        entry("superstep", "superstep.cu", at + "589", ss_launches, ss_err,
              ss_ms, ss_plain_ms, ss_bound),
        entry(frozen, "guidance_frozen.cu", at + "367", fz_launches, fz_err,
              fz_ms, fz_plain_ms, fz_bound),
        entry(frozen, "guidance_frozen.cu", at + "435", f1_launches, f1_err,
              f1_ms, f1_plain_ms, f1_bound),
        entry(fused, "guidance_fused.cu", at + "466", ff_launches, ff_err,
              ff_ms, ff_plain_ms, ff_bound),
        entry("min_clearance_fwd", "min_clearance.cu", pk + "167",
              mono_counts["min_clearance_fwd"], *clear["fwd"]),
        entry("min_clearance_bwd", "min_clearance.cu", pk + "193",
              mono_counts["min_clearance_bwd"], *clear["bwd"]),
        entry(fused, "guidance_fused.cu", at + "396", ev_launches, ev_err,
              ev_ms, ev_plain_ms, ev_bound),
        entry(fused, "guidance_fused.cu", at + "396", t2_launches, t2_err,
              t2_ms, t2_plain_ms, t2_bound),
        entry(fused, "guidance_fused.cu", at + "396", cg_launches, cg_err,
              cg_ms, cg_plain_ms, cg_bound),
        entry(fused, "guidance_fused.cu", at + "396", dd_launches, dd_err,
              dd_ms, dd_plain_ms, dd_bound),
        entry(fused, "guidance_fused.cu", at + "396", pr_launches, pr_err,
              pr_ms, pr_plain_ms, pr_bound),
        entry("min_clearance_fwd", "min_clearance.cu", pk + "167",
              *cv["fwd"]),
        entry("min_clearance_bwd", "min_clearance.cu", pk + "193",
              *cv["bwd"]),
        {**entry("unet1d_norm", "unet1d_norm.cu", None, un_launches, un_err,
                 un_ms, un_plain_ms, un_bound), "library_ms": un_lib_ms}]}),
        flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
