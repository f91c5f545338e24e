"""The port's CUDA kernels on the card (the fused and frozen-payload
guidance kernels, the superstep kernel and the clearance kernel pair),
against their plain PyTorch versions on identical inputs, at the main
path's widths and at the edges of the warp-per-column design (``EDGES``,
``HIDDENS``) and of the clearance kernels' block layout (``CLEAR_CASES``).
Marked
``cuda``: skipped where ``torch.cuda.is_available()`` is false (a CUDA
kernel has no CPU mode).
This file imports no jax, so it also runs on a host without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: chip_smoke.py's.  Guided outputs: rtol 2e-4 / atol 2e-5 for
all but a 1e-3 share of elements, all within the 2*beta_t trust region
(the kernel's hand-written gradient and the plain version's autograd
differ in fp32 rounding, which bf16 cumsum rounding can turn into one bf16
step).  Unguided superstep: SS_RTOL / SS_ATOL elementwise (MLP sums in
another order, a bf16 activation rounding the other way).  Clearance:
forward rtol / atol 1e-4 for every element, VJP rtol 1e-3 / atol 1e-4
(the JAX package's kernel-vs-XLA tolerances) for every element but, up to
chip_smoke's share, those the plain version routes by a near-tie
(``chip_smoke.clearance_near_ties``).
"""

import pytest
import torch

import chip_smoke
from pstl_tpu_torch import diffusion
from pstl_tpu_torch.config import bench_config
from pstl_tpu_torch.models.net import Net
from pstl_tpu_torch.ops import _build
from pstl_tpu_torch.ops import clearance_kernel as ck
from pstl_tpu_torch.ops import guidance_kernel as gk
from pstl_tpu_torch.ops import superstep_kernel as sk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


#: the edges of the warp-per-column kernels: horizons that leave 20 lanes
#: idle, fill the warp exactly or sit between; one neighbor and the most the
#: 4-bit selection fields hold; a column count that is no multiple of a
#: block's columns, with one scene; the Eventually window at its two ends
EDGES = [dict(nt=12, n_neighbors=1), dict(nt=32, n_neighbors=16),
         dict(n_randoms=5, scenes=1), dict(nt2=1), dict(nt2="T")]
EDGE_IDS = ["T12_K1", "T32_K16", "R15_bs1", "nt2_1", "nt2_T"]


def _edge(kw, n_scenes):
    """Split an EDGES entry into (config fields, scenes, nt2 override)."""
    kw = dict(kw)
    return kw, kw.pop("scenes", n_scenes), kw.pop("nt2", None)


def _with_nt2(p, nt2):
    return p if nt2 is None else p._replace(nt2=p.T if nt2 == "T" else nt2)


def _problem(dev, n_scenes, **kw):
    kw, n_scenes, nt2 = _edge(kw, n_scenes)
    cfg = bench_config("heavy").with_(**kw)
    scenes = chip_smoke.scene_batch(cfg, dev, n_scenes=n_scenes)
    _, fused, mu = chip_smoke.plan_inputs(cfg, scenes)
    ops = gk.kernel_operands(fused, cfg)
    beta = diffusion.get_coeffs(cfg, device=dev).beta[40]
    gvec = torch.stack([beta, torch.tensor(100.0, device=dev), ops.gscale])
    args = (mu[:, :, 0].contiguous(), mu[:, :, 1].contiguous(), *ops[:-1],
            gvec, _with_nt2(gk.kernel_params(cfg, fused), nt2))
    return args, float(beta)


def _assert_guided(got, ref, beta):
    assert torch.isfinite(got).all()
    err = (got - ref).abs()
    off = err > chip_smoke.ATOL + chip_smoke.RTOL * ref.abs()
    assert float(off.float().mean()) <= chip_smoke.MAX_OFF_SHARE
    assert float(err.max()) <= 2 * beta + 1e-6


@pytest.mark.parametrize("kw", [
    dict(), dict(clearance_coarse_pair=False, guidance_pallas_bf16_cumsum=False),
    dict(guidance_positive_offset_quirk=True, inline=True, clip_dist=True,
         norm_stl=True), *EDGES],
    ids=["heavy", "exact_fp32", "quirk_inline_norm", *EDGE_IDS])
def test_kernel_matches_plain(dev, kw):
    args, beta = _problem(dev, 4, **kw)
    before = gk.launches
    got = torch.stack(gk.guidance_fused(*args))
    assert gk.launches == before + 1
    ref = torch.stack(gk.guidance_fused_plain(*args))
    torch.cuda.synchronize()
    _assert_guided(got, ref, beta)
    assert float((got - torch.stack(args[:2])).abs().max()) > 0


def test_kernel_rejects_bad_operands(dev):
    args, _ = _problem(dev, 2)
    with pytest.raises(ValueError):
        gk.guidance_fused(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError):
        gk.guidance_fused(args[0][:, :, :-1].contiguous(),
                          args[1][:, :, :-1].contiguous(), *args[2:])


def test_build_four_libraries(dev):
    """chip_smoke's libraries build together (one nvcc each) and load, each
    exporting its C entries."""
    entries = {"min_clearance": ("pstl_min_clearance_fwd",
                                 "pstl_min_clearance_bwd")}
    libs = _build.load_all(chip_smoke.LIBS)
    assert sorted(libs) == sorted(chip_smoke.LIBS)
    for name, lib in libs.items():
        for entry in entries.get(name, (f"pstl_{name}",)):
            assert hasattr(lib, entry)
        report = _build.BUILD_INFO[name]["report"]
        assert "registers" in report
        kernels = _build.ptxas_summary(report)
        assert kernels and all("stack frame" in k for k in kernels)


def _frozen_problem(dev, n_scenes, **kw):
    """The frozen kernel's arguments at the main path's widths: payloads
    frozen once by freeze_cm on the card."""
    kw, n_scenes, nt2 = _edge(kw, n_scenes)
    cfg = bench_config("heavy", gpallas="1").with_(**kw)
    scenes = chip_smoke.scene_batch(cfg, dev, n_scenes=n_scenes)
    _, fused, mu = chip_smoke.plan_inputs(cfg, scenes)
    with torch.no_grad():
        pay = gk.frozen_operands(fused.freeze_cm(mu))
    ops = gk.kernel_operands(fused, cfg)
    beta = diffusion.get_coeffs(cfg, device=dev).beta[40]
    gvec = torch.stack([beta, torch.tensor(100.0, device=dev), ops.gscale])
    args = (mu[:, :, 0].contiguous(), mu[:, :, 1].contiguous(), *pay,
            *gk.frozen_scene(ops), gvec,
            _with_nt2(gk.kernel_params(cfg, fused), nt2))
    return args, float(beta)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(clearance_coarse_pair=False, guidance_pallas_bf16_cumsum=False),
    dict(guidance_positive_offset_quirk=True, inline=True, clip_dist=True,
         norm_stl=True, geometry_dtype="bfloat16"), *EDGES],
    ids=["heavy", "exact_fp32", "quirk_inline_norm_geom_bf16", *EDGE_IDS])
def test_frozen_kernel_matches_plain(dev, kw):
    args, beta = _frozen_problem(dev, 4, **kw)
    before = gk.frozen_launches
    got = torch.stack(gk.guidance_frozen(*args))
    assert gk.frozen_launches == before + 1
    ref = torch.stack(gk.guidance_frozen_plain(*args))
    torch.cuda.synchronize()
    _assert_guided(got, ref, beta)
    assert float((got - torch.stack(args[:2])).abs().max()) > 0


def test_frozen_kernel_rejects_bad_operands(dev):
    args, _ = _frozen_problem(dev, 2)
    i = gk._FROZEN_NAMES.index("nx")
    before = gk.frozen_launches
    for bad in (args[i].cpu(), args[i][:, :-1].contiguous(),
                args[i].double()):
        with pytest.raises((ValueError, TypeError)):
            gk.guidance_frozen(*args[:i], bad, *args[i + 1:])
    assert gk.frozen_launches == before


def _superstep_problem(dev, hiddens, n_scenes=4, **kw):
    """Superstep operands of a randomly initialised net (seeded) with the
    given hidden widths, at the main path's other shapes unless ``kw`` (an
    EDGES entry) changes them."""
    kw, n_scenes, nt2 = _edge(kw, n_scenes)
    cfg = bench_config("heavy", gpallas="4").with_(hiddens=hiddens, **kw)
    torch.manual_seed(0)
    net = Net(cfg).to(dev).eval()
    scenes = chip_smoke.scene_batch(cfg, dev, n_scenes=n_scenes)
    ins = chip_smoke.superstep_inputs(cfg, scenes, net)
    return cfg, ins[:-1] + (_with_nt2(ins[-1], nt2),)


#: hidden widths: the main path's, no mid layer, the widest the kernel takes,
#: a narrow one, and widths that are no multiple of the 32-feature padding
#: (with two mid layers)
HIDDENS = [(256, 256), (256,), (512, 512), (64,), (96, 40, 72)]


@pytest.mark.parametrize("hiddens,kw", [
    *((h, {}) for h in HIDDENS), *(((256, 256), e) for e in EDGES)],
    ids=[*("x".join(map(str, h)) for h in HIDDENS), *EDGE_IDS])
@pytest.mark.parametrize("guided", [True, False], ids=["guided", "unguided"])
def test_superstep_matches_plain(dev, hiddens, kw, guided):
    cfg, (x, z, te_all, gvec_all, mlp, gops, p) = _superstep_problem(
        dev, hiddens, **kw)
    j = cfg.diffusion_steps - 1 - 60
    args = (x, z, te_all[j], gvec_all[j], mlp, gops, p, guided)
    before = (sk.launches, sk.guided_launches)
    with torch.no_grad():
        got = sk.superstep(*args)
        ref = sk.superstep_plain(*args)
    torch.cuda.synchronize()
    assert (sk.launches, sk.guided_launches) == (before[0] + 1,
                                                 before[1] + int(guided))
    assert torch.isfinite(got).all()
    err = (got - ref).abs()
    if guided:
        off = err > chip_smoke.ATOL + chip_smoke.RTOL * ref.abs()
        assert float(off.float().mean()) <= chip_smoke.MAX_OFF_SHARE
        assert float(err.max()) <= 2 * float(gvec_all[j, 0]) + 1e-6
    else:
        assert bool((err <= chip_smoke.SS_ATOL
                     + chip_smoke.SS_RTOL * ref.abs()).all())


def test_superstep_fp32_weights_match_plain(dev):
    """float32 weights take the CUDA-core path (in-order FMAs, no TF32): the
    unguided step equals the plain version to fp32 rounding."""
    cfg = bench_config("heavy", gpallas="4").with_(compute_dtype="float32")
    torch.manual_seed(0)
    net = Net(cfg).to(dev).eval()
    scenes = chip_smoke.scene_batch(cfg, dev, n_scenes=2)
    x, z, te_all, gvec_all, mlp, gops, p = chip_smoke.superstep_inputs(
        cfg, scenes, net)
    assert mlp.base.dtype == torch.float32 and mlp.packed is None
    j = cfg.diffusion_steps - 1 - 60
    with torch.no_grad():
        got = sk.superstep(x, z, te_all[j], gvec_all[j], mlp, gops, p, False)
        ref = sk.superstep_plain(x, z, te_all[j], gvec_all[j], mlp, gops, p,
                                 False)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5


def test_superstep_without_hidden_layer_raises(dev):
    """With no hidden layer the MLP has no layer 1 to split: the operands
    are refused where they are made, on the card as on the CPU, before any
    launch."""
    before = sk.launches
    with pytest.raises(ValueError, match="hidden layer"):
        _superstep_problem(dev, (), n_scenes=1)
    assert sk.launches == before


def test_superstep_wrapper_launches_on_cuda(dev):
    """A CUDA tensor always launches the kernel (the count moves, the plain
    version is not taken); a mixed-device operand raises."""
    cfg, (x, z, te_all, gvec_all, mlp, gops, p) = _superstep_problem(
        dev, (256,), n_scenes=2)
    calls = []
    real = sk.superstep_plain
    sk.superstep_plain = lambda *a: calls.append(1) or real(*a)
    try:
        before = sk.launches
        with torch.no_grad():
            sk.superstep(x, z, te_all[0], gvec_all[0], mlp, gops, p, False)
        torch.cuda.synchronize()
        assert sk.launches == before + 1 and not calls
        with pytest.raises(ValueError):
            sk.superstep(x, z.cpu(), te_all[0], gvec_all[0], mlp, gops, p,
                         False)
    finally:
        sk.superstep_plain = real


#: the clearance kernels' edges: a neighbor set per row (the TPU layout) and
#: per scene at 7, 20 and 64 rows a scene; a scene count that is no multiple
#: of a block's scenes (33 at 2 a block), rows a scene that are no multiple
#: of a block's rows (20 = 16 + 4, 40 = 16 + 16 + 8); a grid large enough to
#: keep 64 rows a block (200 scenes x 20: three scenes a block, two turns a
#: thread; 140 x 64: a scene a block); one neighbor and 16; short and
#: warp-wide horizons; disc counts on the generic loop
CLEAR_CASES = [dict(scenes=1000, clip_region=False), dict(scenes=333),
               dict(scenes=33, m=7), dict(scenes=20, m=64),
               dict(scenes=9, m=20), dict(scenes=200, m=20),
               dict(scenes=140, m=64), dict(scenes=40, m=3, K=1, T=12),
               dict(scenes=11, m=5, K=16, T=32), dict(scenes=50, m=2, nL=1),
               dict(scenes=50, m=2, nL=2), dict(scenes=6, m=40, nL=8)]
CLEAR_IDS = ["random", "clip_region", "m7_odd_scenes", "m64", "m20_ragged",
             "m20_3_scenes_a_block", "m64_full_grid", "K1_T12", "K16_T32",
             "nL1", "nL2", "nL8"]


def _clearance_inputs(dev, scenes, m=1, K=8, T=20, clip_region=True):
    """Ego rows for ``scenes`` x m, the neighbor sets of each scene's first
    row, and a cotangent, on ``dev``."""
    n = scenes * m
    ego, nei = chip_smoke.clearance_random_inputs(n, K, T, seed=n,
                                                 clip_region=clip_region)
    g = torch.randn((n, T), generator=torch.Generator().manual_seed(1))
    return ego.to(dev), nei[::m].contiguous().to(dev), g.to(dev)


@pytest.mark.parametrize("case", CLEAR_CASES, ids=CLEAR_IDS)
def test_clearance_kernels_match_plain(dev, case):
    case = dict(case)
    m, nL = case.get("m", 1), case.pop("nL", 4)
    ego, nei, g = _clearance_inputs(dev, **case)
    L, W = chip_smoke.EGO_L, chip_smoke.EGO_W
    before = (ck.fwd_launches, ck.bwd_launches)
    out = ck.min_clearance_fwd(ego, nei, L, W, nL, m)
    d = ck.min_clearance_bwd(ego, nei, g, L, W, nL, m)
    torch.cuda.synchronize()
    assert (ck.fwd_launches, ck.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    chip_smoke.clearance_check(
        "forward", out, ck.min_clearance_fwd_plain(ego, nei, L, W, nL, m),
        chip_smoke.CLEAR_FWD_RTOL)
    chip_smoke.clearance_check(
        "backward", d, ck.min_clearance_bwd_plain(ego, nei, g, L, W, nL, m),
        chip_smoke.CLEAR_BWD_RTOL, chip_smoke.clearance_near_ties(
            ego, nei, L, W, nL, chip_smoke.CLEAR_TIE_M, m))
    assert float(d.abs().max()) > 0


@pytest.mark.parametrize("m", [1, 64])
def test_clearance_kernels_without_rows(dev, m):
    """n = 0: empty outputs, nothing launched."""
    ego = torch.zeros((0, 20, 3), device=dev)
    nei = torch.zeros((0, 8, 20, 7), device=dev)
    before = (ck.fwd_launches, ck.bwd_launches)
    out = ck.min_clearance_fwd(ego, nei, 4.084, 1.73, 4, m)
    d = ck.min_clearance_bwd(ego, nei, out, 4.084, 1.73, 4, m)
    torch.cuda.synchronize()
    assert out.shape == (0, 20) and d.shape == (0, 20, 3)
    assert (ck.fwd_launches, ck.bwd_launches) == before


def test_clearance_autograd_launches_both(dev):
    """MinClearance on CUDA tensors with 64 rows a scene: the forward
    kernel, then the backward kernel as its VJP, once each; no gradient to
    the neighbors; bad operands raise without a launch."""
    ego, nt, _ = _clearance_inputs(dev, 2, m=64)
    e = ego.clone().requires_grad_(True)
    before = (ck.fwd_launches, ck.bwd_launches)
    ck.min_clearance(e, nt, 4.084, 1.73, 4, 64).sum().backward()
    torch.cuda.synchronize()
    assert (ck.fwd_launches, ck.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    ref = ck.min_clearance_bwd_plain(ego, nt, torch.ones(128, 20, device=dev),
                                     4.084, 1.73, 4, 64)
    assert float((e.grad - ref).abs().max()) <= 1e-3
    for bad in (nt.cpu(), nt.double(), nt[:, :, :-1].contiguous(),
                nt.transpose(1, 2), nt[:1]):
        with pytest.raises((ValueError, TypeError)):
            ck.min_clearance_fwd(ego, bad, 4.084, 1.73, 4, 64)
    with pytest.raises(ValueError):
        ck.min_clearance_fwd(ego, nt, 4.084, 1.73, 4, 3)
    with pytest.raises(ValueError):     # K * T * (2 nL + 2) floats > 227 KB
        ck.min_clearance_fwd(torch.zeros((2, 64, 3), device=dev),
                             torch.zeros((2, 64, 64, 7), device=dev),
                             4.084, 1.73, 8)
    assert (ck.fwd_launches, ck.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)


# --------------------------------------------------------------------------
# the evaluation's path and the augmentation (chip_smoke.py phases 19-22)
# --------------------------------------------------------------------------

def test_kernel_matches_plain_eval_regime(dev):
    """Kernel 1 as the open-loop evaluation runs it (``ours_guidance``: one
    Adam iteration, all disc pairs, fp32 cumsum) at the minimizing hinge
    threshold ``stl_nn_thres``, where satisfied columns have a zero
    gradient and stay put."""
    cfg = chip_smoke.eval_config("ours_guidance",
                                 guidance_pallas_fuse_freeze=True)
    scenes = chip_smoke.scene_batch(cfg, dev, n_scenes=4)
    _, fused, mu = chip_smoke.plan_inputs(cfg, scenes)
    ops = gk.kernel_operands(fused, cfg)
    beta = diffusion.get_coeffs(cfg, device=dev).beta[10]
    gvec = torch.stack([beta, torch.tensor(cfg.stl_nn_thres, device=dev),
                        ops.gscale])
    args = (mu[:, :, 0].contiguous(), mu[:, :, 1].contiguous(), *ops[:-1],
            gvec, gk.kernel_params(cfg, fused))
    assert args[-1].niters == 1
    got = torch.stack(gk.guidance_fused(*args))
    ref = torch.stack(gk.guidance_fused_plain(*args))
    torch.cuda.synchronize()
    _assert_guided(got, ref, float(beta))


def test_trajopt_card_matches_cpu(dev):
    """10 Adam steps of ``trajopt.optimize`` at a small size (2 scenes x 4
    x 3, K = 2) on the card against the CPU, the same draws: controls within
    chip_smoke's TJ_PARAM_ATOL, no kernel launched."""
    from pstl_tpu_torch import specs, trajopt
    from pstl_tpu_torch.data.dataset import SceneDataset
    cfg = chip_smoke.e1_config(n_randoms=4, trajopt_robust_draws=2)
    ds = SceneDataset.from_synthetic(cfg, seed=0, n_scenes=2)
    ds.ensure_random_params(0)
    batch = chip_smoke.with_gt_seed(ds.gather([0, 1]), cfg)
    draws = trajopt.batch_draws(2, 2, torch.Generator().manual_seed(1))
    out = []
    before = gk.launches, ck.fwd_launches
    for d in ("cpu", dev):
        p0, st, sb, hl, stack, _ = chip_smoke.trajopt_inputs(cfg, batch,
                                                             draws, d)
        p, _, _ = trajopt.optimize(p0, st, sb, hl, specs.build_scorer(cfg),
                                   cfg, iters=10, stlp_draws=stack)
        out.append(p.cpu())
    assert (gk.launches, ck.fwd_launches) == before
    assert float((out[1] - out[0]).abs().max()) <= chip_smoke.TJ_PARAM_ATOL


def test_eval_region_card_matches_cpu(dev):
    """The evaluation's timed region at a small size (width-32 random net,
    2 scenes x 4 x 3, 10 denoise steps, guided with kernel 1) on the card
    against the CPU with pinned noise: scores within chip_smoke's
    EVAL_SCORE_ATOL, one kernel launch per guided denoise step."""
    from pstl_tpu_torch import eval_openloop, specs, train
    from pstl_tpu_torch.data.dataset import SceneDataset
    from pstl_tpu_torch.models.net import init_flax_like
    cfg = chip_smoke.eval_config(
        "ours_guidance", guidance_pallas_fuse_freeze=True, n_randoms=4,
        sampling_size=4, hiddens=(32, 32), rect_hiddens=(32, 32),
        diffusion_steps=10, compute_dtype="float32")
    ds = SceneDataset.from_synthetic(cfg, seed=0, n_scenes=2)
    ds.ensure_random_params(0)
    batch = ds.gather([0, 1])
    g = torch.Generator().manual_seed(2)
    flex = specs.flex_uniforms(2, g)
    noise = torch.randn((cfg.diffusion_steps,)
                        + eval_openloop.sampler_shape(cfg, 2), generator=g)
    net = Net(cfg)
    init_flax_like(net, torch.Generator().manual_seed(0))
    out = []
    for d in ("cpu", dev):
        before = gk.launches
        with torch.no_grad():
            nn, *_ = eval_openloop._sample_and_score(
                net.to(d), train.to_device(batch, d), cfg,
                specs.build_scorer(cfg), diffusion.get_coeffs(cfg, device=d),
                flex=flex.to(d), noise=noise.to(d))
        out.append(nn["scores"].cpu())
    assert gk.launches == before + int(diffusion._trigger_schedule(cfg).sum())
    assert float((out[1] - out[0]).abs().max()) <= chip_smoke.EVAL_SCORE_ATOL


@pytest.mark.parametrize("n_iters,tol", [(50, 1e-4), (500, 1e-2)])
def test_backup_solve_card_matches_cpu(dev, n_iters, tol):
    """``refine.solve_backup`` on the card against the CPU on
    ``torch_parity.backup_case``: after 50 Adam steps within 1e-4, after
    the full 500 within the learning rate (``test_torch_refine``'s bounds
    against the JAX package, and why)."""
    import torch_parity
    from pstl_tpu_torch import refine
    from pstl_tpu_torch.config import Config
    cfg = Config().finalize()
    plan, u01, nei = (torch.as_tensor(a) for a in torch_parity.backup_case())
    out = [refine.solve_backup(plan[:, 0:3].to(d), u01.to(d),
                               nei[:, 0:3].to(d), cfg, n_iters=n_iters).cpu()
           for d in ("cpu", dev)]
    assert float((out[1] - out[0]).abs().max()) <= tol
    assert float(out[0].abs().max()) > 0.1


@pytest.mark.parametrize("how", ["convex6", "convex8", "raw"])
def test_refinement_card_matches_cpu(dev, how):
    """The convex (K = 6, 8; 50 Adam steps) and raw (5) refinements on the
    card against the CPU on ``torch_parity.refine_case`` (inputs on which
    the loops are well conditioned): controls within 1e-4, the rows that
    satisfy their spec untouched on both."""
    import torch_parity
    from pstl_tpu_torch import refine, specs
    from pstl_tpu_torch.config import Config
    cfg = Config(diffusion=True, n_randoms=4, n_neighbors=3,
                 compute_dtype="float32", flex=True).finalize()
    batch, stlp, states, valid, u, steps = torch_parity.refine_case(cfg)
    out = []
    for d in ("cpu", dev):
        t = lambda a: torch.as_tensor(a).to(d)
        scorer = specs.TiledScorer({k: t(v) for k, v in batch.items()},
                                   t(stlp), cfg)
        with torch.no_grad():
            if how == "raw":
                r = refine.raw_refinement(t(u), t(states), scorer, t(valid),
                                          cfg)
            else:
                r = refine.convex_refinement(t(u), t(steps), t(states),
                                             scorer, t(valid), cfg,
                                             K=int(how[-1]))
        out.append(r.cpu())
    assert float((out[1] - out[0]).abs().max()) <= 1e-4
    assert float((out[0] - torch.as_tensor(u)).abs().max()) > 0.05
