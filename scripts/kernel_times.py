"""Times and ptxas reports of the guidance, superstep and clearance kernels
of one checkout of the port, on one GPU.

Imports ``pstl_tpu_torch`` and ``chip_smoke`` from ``--repo`` (default: this
checkout), builds its kernel libraries, prints ptxas's registers, spills and
stack frame per kernel, and times the fused guidance kernel, the
frozen-payload kernel and the superstep kernel (guided and unguided) at the
main path's shapes (16 scenes, R=192, T=20, K=8, hidden 256, bf16, e7_round5
weights, t=60), and the clearance kernel pair on the ``e2_vae_mono`` step's
own operands (128 scenes x 64 rows, K=8, T=20, nL=4, as ``--repo``'s step
hands them to the kernels: one neighbor set per scene, or, in a checkout
whose kernels take one per row, each scene's repeated 64 times; the values
are the same): the kernel's own time as a CUDA graph replays 20 launches,
and one eager call of its wrapper (median of 20, CUDA events).  The last
line is one JSON object.  The timers and the report parser are this
checkout's (``chip_smoke.kernel_ms``, ``_build.ptxas_summary``), loaded
beside ``--repo``'s modules, so the script also runs a checkout that
predates them.  To set two commits side by side on one card, unpack the
other into a directory that git ignores and run both in turns in one command:

    git archive <commit> | tar -x -C build/parent
    for d in build/parent . . build/parent; do
        python scripts/kernel_times.py --repo $d; done
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBS = ("guidance_fused", "guidance_frozen", "superstep", "min_clearance")


def own_module(path, name):
    """This checkout's ``path`` as a module called ``name``, so that it can
    stand beside another checkout's module of the same file name."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main_path_calls(dev):
    """The kernels' calls at the main path's shapes, from the ``chip_smoke``
    and ``pstl_tpu_torch`` on ``sys.path``: name -> (wrapper call, plain
    version's call, check(got, ref, what) that raises where the two
    disagree beyond ``chip_smoke.py``'s tolerances).  Each name starts with
    its library's."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from pstl_tpu_torch import diffusion
    from pstl_tpu_torch.config import bench_config, mono_config
    from pstl_tpu_torch.data.dataset import SceneDataset
    from pstl_tpu_torch.models import convert
    from pstl_tpu_torch.models.net import Net
    from pstl_tpu_torch.ops import clearance_kernel as ck
    from pstl_tpu_torch.ops import guidance_kernel as gk
    from pstl_tpu_torch.ops import superstep_kernel as sk

    cfg = bench_config("heavy", gpallas="4")
    scenes = cs.scene_batch(cfg, dev)
    net = Net(cfg)
    convert.load_weights(net, "e7_round5")
    net = net.to(dev).eval()
    _, fused, mu = cs.plan_inputs(cfg, scenes)
    ops = gk.kernel_operands(fused, cfg)
    p = gk.kernel_params(cfg, fused)
    beta = diffusion.get_coeffs(cfg, device=dev).beta[60]
    gvec = torch.stack([beta, torch.tensor(100.0, device=dev), ops.gscale])
    w, a = mu[:, :, 0].contiguous(), mu[:, :, 1].contiguous()
    fused_args = (w, a, *ops[:-1], gvec, p)
    with torch.no_grad():
        pay = gk.frozen_operands(fused.freeze_cm(mu))
    frozen_args = (w, a, *pay, *gk.frozen_scene(ops), gvec, p)
    x, z, te_all, gvec_all, mlp, gops, sp = cs.superstep_inputs(cfg, scenes,
                                                               net)
    j = cfg.diffusion_steps - 1 - 60
    ss = lambda guided: (x, z, te_all[j], gvec_all[j], mlp, gops, sp, guided)
    start = torch.stack([w, a])

    def guided(start):
        return lambda got, ref, what: cs.check_guided(got, ref, start,
                                                      float(beta), what)

    def unguided(got, ref, what):
        if bool((~torch.isfinite(got) | ((got - ref).abs() > cs.SS_ATOL
                                         + cs.SS_RTOL * ref.abs())).any()):
            raise RuntimeError(f"{what}: disagrees with the plain version")

    # the e2 step's clearance operands; ``rows`` is (rows a scene,), or ()
    # where the step repeats the neighbors per row itself
    mcfg = mono_config("e2_vae_mono")
    ds = SceneDataset.from_synthetic(mcfg, seed=0, n_scenes=mcfg.batch_size)
    ego, nei, *rows = cs.e2_clearance_inputs(
        dev, mcfg, ds.gather(np.arange(mcfg.batch_size)))
    geo = (mcfg.ego_L, mcfg.ego_W, mcfg.refined_nL, *rows)
    cot = torch.randn(ego.shape[:2],
                      generator=torch.Generator().manual_seed(2)).to(dev)
    near = cs.clearance_near_ties(ego, nei, *geo[:3], cs.CLEAR_TIE_M, *rows)
    return {
        "guidance_fused": (
            lambda: torch.stack(gk.guidance_fused(*fused_args)),
            lambda: torch.stack(gk.guidance_fused_plain(*fused_args)),
            guided(start)),
        "guidance_frozen": (
            lambda: torch.stack(gk.guidance_frozen(*frozen_args)),
            lambda: torch.stack(gk.guidance_frozen_plain(*frozen_args)),
            guided(start)),
        "superstep guided": (lambda: sk.superstep(*ss(True)),
                             lambda: sk.superstep_plain(*ss(True)),
                             guided(x)),
        "superstep unguided": (lambda: sk.superstep(*ss(False)),
                               lambda: sk.superstep_plain(*ss(False)),
                               unguided),
        "min_clearance forward": (
            lambda: ck.min_clearance_fwd(ego, nei, *geo),
            lambda: ck.min_clearance_fwd_plain(ego, nei, *geo),
            lambda got, ref, what: cs.clearance_check(
                what, got, ref, cs.CLEAR_FWD_RTOL)),
        "min_clearance backward": (
            lambda: ck.min_clearance_bwd(ego, nei, cot, *geo),
            lambda: ck.min_clearance_bwd_plain(ego, nei, cot, *geo),
            lambda got, ref, what: cs.clearance_check(
                what, got, ref, cs.CLEAR_BWD_RTOL, near)),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE)
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    tools = own_module("chip_smoke.py", "own_chip_smoke")
    ptxas_summary = own_module("pstl_tpu_torch/ops/_build.py",
                               "own_build").ptxas_summary
    sys.path.insert(0, repo)

    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_times.py needs a CUDA device")
    from pstl_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_all(LIBS)
    ptxas = {}
    for name in LIBS:
        ptxas[name] = ptxas_summary(_build.BUILD_INFO[name]["report"])
        for ln in ptxas[name]:
            print(f"{repo}: ptxas {name}: {ln}", flush=True)

    calls = main_path_calls(torch.device("cuda", 0))
    ms = {}
    with torch.no_grad():
        for what, (fn, _, _) in calls.items():
            ms[what] = tools.kernel_ms(fn)
            print(f"{repo}: {what}: {ms[what]['graph_ms']:.5f} ms a launch "
                  f"in a graph replay, {ms[what]['ms']:.5f} ms one eager "
                  f"call", flush=True)
    print(json.dumps({"repo": repo, "device": tools.gpu_name_power(),
                      "ptxas": ptxas, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
