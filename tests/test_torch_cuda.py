"""The fused guidance CUDA kernel on the card, against its plain PyTorch
version on identical inputs.  Marked ``cuda``: skipped where
``torch.cuda.is_available()`` is false (a CUDA kernel has no CPU mode).
This file imports no jax, so it also runs on a host without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: chip_smoke.py's (rtol 2e-4 / atol 2e-5 on guided controls for
all but a 1e-3 share of elements, all within the 2*beta_t trust region;
the kernel's hand-written gradient and the plain version's autograd differ
in fp32 rounding, which bf16 cumsum rounding can turn into one bf16 step).
"""

import pytest
import torch

import chip_smoke
from pstl_tpu_torch import diffusion
from pstl_tpu_torch.config import bench_config
from pstl_tpu_torch.ops import guidance_kernel as gk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the guidance kernel runs only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _problem(dev, n_scenes, **kw):
    cfg = bench_config("heavy").with_(**kw)
    scenes = chip_smoke.scene_batch(cfg, dev, n_scenes=n_scenes)
    _, fused, mu = chip_smoke.plan_inputs(cfg, scenes)
    ops = gk.kernel_operands(fused, cfg)
    beta = diffusion.get_coeffs(cfg, device=dev).beta[40]
    gvec = torch.stack([beta, torch.tensor(100.0, device=dev), ops.gscale])
    args = (mu[:, :, 0].contiguous(), mu[:, :, 1].contiguous(), *ops[:-1],
            gvec, gk.kernel_params(cfg, fused))
    return args, float(beta)


@pytest.mark.parametrize("kw", [
    dict(), dict(clearance_coarse_pair=False, guidance_pallas_bf16_cumsum=False),
    dict(guidance_positive_offset_quirk=True, inline=True, clip_dist=True,
         norm_stl=True)], ids=["heavy", "exact_fp32", "quirk_inline_norm"])
def test_kernel_matches_plain(dev, kw):
    args, beta = _problem(dev, 4, **kw)
    before = gk.launches
    got = torch.stack(gk.guidance_fused(*args))
    assert gk.launches == before + 1
    ref = torch.stack(gk.guidance_fused_plain(*args))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got - ref).abs()
    off = err > chip_smoke.ATOL + chip_smoke.RTOL * ref.abs()
    assert float(off.float().mean()) <= chip_smoke.MAX_OFF_SHARE
    assert float(err.max()) <= 2 * beta + 1e-6


def test_kernel_rejects_bad_operands(dev):
    args, _ = _problem(dev, 2)
    with pytest.raises(ValueError):
        gk.guidance_fused(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError):
        gk.guidance_fused(args[0][:, :, :-1].contiguous(),
                          args[1][:, :, :-1].contiguous(), *args[2:])
