#!/usr/bin/env python3
"""Smoke run of the torch port (``pstl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line of numbers; the first failure exits non-zero
and no result line is printed:

1. device: needs CUDA (there is no CPU path); TF32 off; the card's name and
   power limit from nvidia-smi.
2. build: compiles the three kernel libraries from ``pstl_tpu_torch/csrc``
   (one nvcc per source, all at once) and prints ptxas's report of each.
3. kernel: the fused guidance kernel against its plain PyTorch version on
   identical inputs at the closed-loop shapes (16 scenes, T=20, R=192, K=8,
   S=15, nL=4, 3 Adam iterations), for coarse pair on/off, bf16 cumsum
   on/off and the offset quirk on/off; maximum error and median times (CUDA
   events).
4. superstep kernel: the whole-denoise-step kernel against its plain
   version on identical inputs at the main shapes (16 scenes, R=192, hidden
   256, bf16, e7_round5 weights), guided and unguided, for the same flag
   combinations at t=60 and t=5; maximum error and median times.
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

The line before the last is the card's ``name, power.limit``; before it a
JSON line with each kernel's launches, error and times; the last line is
``{"ok": true, "device": {...}}``.
"""

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
LIBS = ("guidance_fused", "guidance_frozen", "superstep")

# kernel vs plain tolerance (see kernel_phase): controls are normalized
# (|mu| ~ 1); rtol/atol of the JAX package's own kernel-vs-XLA tests
RTOL, ATOL = 2e-4, 2e-5
# share of elements allowed outside RTOL/ATOL, and their bound: a freeze
# argmin can flip on a near-tie between fp32 sums taken in another order
# (FMA contraction on the card), which moves that column's Adam path; the
# move stays inside the trust region |delta| <= beta on either side
MAX_OFF_SHARE = 1e-3
# unguided superstep vs plain, elementwise on x_next: the MLP sums in fp32
# in another order than the library matmul, so a bf16 activation can round
# one step (2^-8 relative) the other way; that moves eps by about that step
# times an output weight (~1e-4 per flip at the e7 weights) and x_next by
# c1/c2 of it (0.019 at t=60, 0.013 at t=5)
SS_RTOL, SS_ATOL = 1e-4, 1e-4


def log(msg):
    print(msg, flush=True)


def gpu_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    bound = 2 * beta + 1e-6
    log(f"{what}: max_abs_err={max_err:.3e} off_share={share:.2e} "
        f"moved={float((got - start).abs().max()):.3e}")
    if share > MAX_OFF_SHARE or max_err > bound:
        raise RuntimeError(
            f"{what} disagrees with the plain version: {share:.2e} of "
            f"elements beyond rtol {RTOL} / atol {ATOL} (allowed "
            f"{MAX_OFF_SHARE}), max error {max_err:.3e} (bound {bound:.3e})")
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
    heavy_ms = heavy_plain_ms = None
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
                    bound = 2 * float(coeffs.beta[t]) + 1e-6
                    moved = float((got - torch.stack([w, a])).abs().max())
                    log(f"kernel coarse={int(coarse)} bf16={int(bf16)} "
                        f"quirk={int(quirk)} t={t}: max_abs_err="
                        f"{max_err:.3e} off_share={share:.2e} "
                        f"moved={moved:.3e}")
                    if share > MAX_OFF_SHARE or max_err > bound:
                        raise RuntimeError(
                            f"kernel disagrees with the plain version: "
                            f"{share:.2e} of elements beyond rtol {RTOL} / "
                            f"atol {ATOL} (allowed {MAX_OFF_SHARE}), max "
                            f"error {max_err:.3e} (bound {bound:.3e})")
                    if moved <= 0:
                        raise RuntimeError("the kernel did not move mu")
                    worst = max(worst, max_err)
                    outs[(coarse, bf16, quirk, t)] = got
                    if coarse and bf16 and not quirk and t == 60:
                        heavy_ms = time_cuda(lambda: gk.guidance_fused(*args))
                        heavy_plain_ms = time_cuda(
                            lambda: gk.guidance_fused_plain(*args))
    # every flag must change the kernel's result on this problem
    for i, flag in enumerate(("coarse", "bf16", "quirk")):
        on = (True, True, False, 60)
        off = tuple((not v) if j == i else v for j, v in enumerate(on))
        d = float((outs[on] - outs[off]).abs().max())
        log(f"kernel flag {flag}: on vs off max diff {d:.3e}")
        if not d > 0:
            raise RuntimeError(f"flag {flag} does not change the kernel")
    log(f"kernel times (coarse+bf16, bs={SCENES}, R={3 * base.n_randoms}, "
        f"niters={base.guidance_niters}): kernel {heavy_ms:.4f} ms, plain "
        f"{heavy_plain_ms:.4f} ms (median of 20)")
    return worst, heavy_ms, heavy_plain_ms


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
                            log(f"{what}: max_abs_err={err:.3e} "
                                f"beyond_tol={bad}")
                            if bad:
                                raise RuntimeError(
                                    f"{what} disagrees with the plain "
                                    f"version beyond rtol {SS_RTOL} / atol "
                                    f"{SS_ATOL}: {err:.3e}")
                        worst = max(worst, err)
                        outs[guided] = got
                        if coarse and bf16 and not quirk and t == 60:
                            times[guided] = (
                                time_cuda(lambda: sk.superstep(*args)),
                                time_cuda(lambda: sk.superstep_plain(*args)))
                    if not float((outs[True] - outs[False]).abs().max()) > 0:
                        raise RuntimeError("the guided superstep did not "
                                           "change the step")
    for guided, (ms, plain_ms) in times.items():
        log(f"superstep times ({'guided' if guided else 'unguided'}, "
            f"coarse+bf16, bs={SCENES}, R={3 * base.n_randoms}, hidden "
            f"{base.hiddens}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(median of 20)")
    return worst, times[True][0], times[True][1]


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


def run_loop(dev, net, cfg, steps):
    """``steps`` closed-loop steps of the scenes under ``cfg``, with every
    kernel's launch count set to 0 just before and read just after; every
    metric must be finite.  Returns (counts, metrics, step seconds, wall)."""
    import torch
    from pstl_tpu_torch import diffusion, sim
    from pstl_tpu_torch.ops import guidance_kernel as gk
    from pstl_tpu_torch.ops import superstep_kernel as sk

    scenes = scene_batch(cfg, dev)
    coeffs = diffusion.get_coeffs(cfg, device=dev)
    init_carry, step = sim.make_closed_loop_step(scenes, cfg, net, coeffs)
    c = init_carry(0)
    torch.cuda.synchronize()
    gk.launches = gk.frozen_launches = sk.launches = sk.guided_launches = 0
    step_s = []
    t_all = time.time()
    for _ in range(steps):
        t0 = time.time()
        c = step(c)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)
    wall = time.time() - t_all
    counts = {"guidance_fused": gk.launches,
              "guidance_frozen": gk.frozen_launches,
              "superstep": sk.launches,
              "superstep_guided": sk.guided_launches}
    m = {k: v.cpu() for k, v in sim._carry_metrics(c).items()}
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


def report_loop(what, steps, counts, m, step_s, wall):
    sps = SCENES / median(step_s)
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
    ms = time_cuda(call)
    plain_ms = time_cuda(lambda: plain(*args))
    log(f"{what} times: guidance_adam_cm {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms (median of 20)")
    return err, ms, plain_ms


#: the kernel each BENCH_GPALLAS route launches once per guided denoise step
ROUTE_KERNEL = {"0": None, "1": "guidance_frozen", "1f": "guidance_frozen",
                "2f": "guidance_fused", "2": "guidance_fused",
                "3": "guidance_fused"}


def route_phase(dev, net, gpallas, steps, sel_every=1):
    """The configuration ``bench_config("heavy", gpallas, sel_every)``: its
    guidance call against the plain version (not for the XLA loop, which
    runs no kernel), then ``steps`` closed-loop steps, which must launch
    the route's kernel once per guided denoise step and nothing else.
    Returns (launches, max error, ms, plain ms, median step s)."""
    from pstl_tpu_torch import diffusion
    from pstl_tpu_torch.config import bench_config

    t0 = time.time()
    cfg = bench_config("heavy", gpallas=gpallas, sel_every=sel_every)
    what = f"BENCH_GPALLAS={gpallas} sel_every={sel_every}"
    kernel = ROUTE_KERNEL[gpallas]
    err = ms = plain_ms = None
    if kernel is not None:
        err, ms, plain_ms = route_call(dev, cfg, what)
    counts, m, step_s, wall = run_loop(dev, net, cfg, steps)
    guided = int(diffusion._trigger_schedule(cfg).sum())
    check_counts(counts, {kernel: guided * steps} if kernel else {},
                 f"{what} closed loop")
    report_loop(f"{what} closed loop", steps, counts, m, step_s, wall)
    log(f"{what}: phase wall {time.time() - t0:.1f} s")
    return (counts.get(kernel, 0), err, ms, plain_ms, median(step_s))


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
                times = (time_cuda(lambda: gk.guidance_frozen(*args)),
                         time_cuda(lambda: gk.guidance_frozen_plain(*args)))
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
        f"{times[0]:.4f} ms, plain {times[1]:.4f} ms (median of 20); "
        f"phase wall {time.time() - t_start:.1f} s")
    return worst, times[0], times[1]


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


def main():
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
        ptx = [ln.strip() for ln in info["report"].splitlines()
               if "registers" in ln or "spill" in ln]
        log(f"build: {name} (nvcc {info['build_s']:.2f} s); "
            + " | ".join(ptx))
    log(f"build: {len(LIBS)} libraries in {time.time() - t0:.2f} s")

    max_err, ms, plain_ms = kernel_phase(dev)

    net = Net(bench_config("heavy"))
    convert.load_weights(net, "e7_round5")
    net = net.to(dev).eval()
    ss_err, ss_ms, ss_plain_ms = superstep_phase(dev, net)
    fz_err, fz_ms, fz_plain_ms = frozen_phase(dev)

    net_cpu = Net(bench_config("heavy").with_(compute_dtype="float32"))
    convert.load_weights(net_cpu, "e7_round5")
    net_dev = Net(bench_config("heavy").with_(compute_dtype="float32"))
    convert.load_weights(net_dev, "e7_round5")
    reference_phase(dev, net_cpu.eval(), net_dev.to(dev).eval())
    t1 = time.time()
    reference_phase(dev, net_cpu.eval(), net_dev.to(dev).eval(),
                    routes=(("1", 1), ("1", 2)))
    log(f"frozen reference: phase wall {time.time() - t1:.1f} s")

    launches, _, _, _, step_med = route_phase(dev, net, "2", STEPS)
    f2_launches, f2_err, f2_ms, f2_plain_ms, _ = route_phase(
        dev, net, "3", FOLD2_STEPS)
    ss_launches, ss_step_med = superstep_loop_phase(dev, net)
    fz_launches, _, _, _, fz_step_med = route_phase(dev, net, "1", STEPS)
    f1_launches, f1_err, f1_ms, f1_plain_ms, _ = route_phase(
        dev, net, "1f", ROUTE_STEPS)
    ff_launches, ff_err, ff_ms, ff_plain_ms, _ = route_phase(
        dev, net, "2f", ROUTE_STEPS)
    route_phase(dev, net, "1", ROUTE_STEPS, sel_every=2)
    _, _, _, _, xla_step_med = route_phase(dev, net, "0", ROUTE_STEPS)
    log(f"median closed-loop step, heavy contract: default path "
        f"{step_med * 1e3:.1f} ms, superstep {ss_step_med * 1e3:.1f} ms, "
        f"frozen payloads {fz_step_med * 1e3:.1f} ms, XLA guidance loop "
        f"{xla_step_med * 1e3:.1f} ms")

    fused = {"name": "guidance_fused", "route": "cuda",
             "source": "pstl_tpu_torch/csrc/guidance_fused.cu"}
    frozen = {"name": "guidance_frozen", "route": "cuda",
              "source": "pstl_tpu_torch/csrc/guidance_frozen.cu"}
    at = "pstl_tpu/ops/pallas_guidance.py:"
    print(json.dumps({"kernels": [
        dict(fused, replaces=at + "396", launches=launches,
             max_abs_err=max_err, ms=ms, plain_ms=plain_ms),
        dict(fused, replaces=at + "495", launches=f2_launches,
             max_abs_err=f2_err, ms=f2_ms, plain_ms=f2_plain_ms),
        {"name": "superstep", "route": "cuda",
         "source": "pstl_tpu_torch/csrc/superstep.cu",
         "replaces": at + "589", "launches": ss_launches,
         "max_abs_err": ss_err, "ms": ss_ms, "plain_ms": ss_plain_ms},
        dict(frozen, replaces=at + "367", launches=fz_launches,
             max_abs_err=fz_err, ms=fz_ms, plain_ms=fz_plain_ms),
        dict(frozen, replaces=at + "435", launches=f1_launches,
             max_abs_err=f1_err, ms=f1_ms, plain_ms=f1_plain_ms),
        dict(fused, replaces=at + "466", launches=ff_launches,
             max_abs_err=ff_err, ms=ff_ms, plain_ms=ff_plain_ms)]}),
        flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
