"""One whole DDPM denoise step in one launch: the split-layer-1 epsilon
MLP, the posterior mean, optionally the fused guidance update, and the
noise term.

This is the port of the Pallas kernel ``_kernel_superstep``
(``pstl_tpu/ops/pallas_guidance.py``, reached through ``superstep_call``
from ``diffusion._reverse_superstep``).  On a CUDA tensor :func:`superstep`
launches the hand-written kernel in ``csrc/superstep.cu``; on a CPU tensor
it runs :func:`superstep_plain`, the same computation in PyTorch ops.
There is no fallback from one to the other.  ``launches`` counts kernel
launches and ``guided_launches`` those of them that ran the guidance.

The TPU kernel folds the scenes into (T, bs*R) lane columns; the port keeps
its candidate-minor layout: x, z and the result are (bs, T, 2, R) float32.
The MLP operands are ``models.net.make_cm_eps_fn``'s ``eps_cm.operands`` in
the compute dtype; the guidance operands and parameters are
``guidance_kernel.kernel_operands`` / ``kernel_params``.  Per denoise step
the kernel takes ``te`` (h1,), the layer-1 term of the timestep, and
``gvec`` (8,) float32 = [beta_t, thres, gscale, c1, c2, c3, 0, 0] with
mu = (x - c1*eps)/c2 and x_next = mu + c3*z; :func:`step_tables` builds
both for every step once per plan.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from pstl_tpu_torch.config import Config
from pstl_tpu_torch.ops import guidance_kernel as gk

Tensor = torch.Tensor

#: kernel launches since the last reset (the plain version does not count)
launches = 0
#: the launches among them that ran the guided update
guided_launches = 0

_MAXMID, _MAXH = 8, 512


class PackedMlp(NamedTuple):
    """The bf16 weight matrices in the order the tensor-core kernel reads
    them (:func:`pack_b`), flat."""
    Wnw: Tensor
    Wna: Tensor
    mid: Tuple[Tensor, ...]
    Wo: Tensor                          # rows [WowT; WoaT]


class MlpOperands(NamedTuple):
    """The split eps MLP in the compute dtype, contiguous (``eps_cm.operands``
    without the timestep projection and the sizes).  ``packed`` is set for
    bfloat16 weights."""
    base: Tensor                        # (bs, h1, R)
    WnwT: Tensor                        # (h1, T)
    WnaT: Tensor                        # (h1, T)
    mid: Tuple[Tuple[Tensor, Tensor], ...]   # ((k, h) W^T, (k, 1) b)
    WowT: Tensor                        # (T, h_last)
    WoaT: Tensor
    bow: Tensor                         # (T, 1)
    boa: Tensor
    packed: Optional[PackedMlp] = None


def pack_b(W: Tensor, n_mult: int = 32) -> Tensor:
    """A weight matrix W^T (n_out, n_in) as the B operand of
    ``mma.sync.aligned.m16n8k16.row.col`` in fragment order, flat: zero
    padded to (Np, Kp) = multiples of (``n_mult``, 32), then for output tile
    nt (8 rows), feature block kk (32 features) and lane = 4*g + q the eight
    values Wp[nt*8 + g, kk*32 + 16*ks + 8*r + 2*q + h] in (ks, r, h) order:
    the lane's fragment registers b_r of k-steps 2kk + ks, 16 bytes a lane,
    one 512-byte line a warp."""
    n_out, n_in = W.shape
    Np = -(-n_out // n_mult) * n_mult
    Kp = -(-n_in // 32) * 32
    Wp = W.new_zeros((Np, Kp))
    Wp[:n_out, :n_in] = W
    v = Wp.view(Np // 8, 8, Kp // 32, 2, 2, 4, 2)   # nt, g, kk, ks, r, q, h
    return v.permute(0, 2, 1, 5, 3, 4, 6).contiguous().view(-1)


def pack_mlp(mlp: MlpOperands) -> PackedMlp:
    """The matrices of ``mlp`` for the tensor-core kernel: hidden widths
    padded to multiples of 32 (so a layer's padded outputs are the next
    layer's padded features), the stacked output rows to a multiple of 8."""
    return PackedMlp(
        Wnw=pack_b(mlp.WnwT), Wna=pack_b(mlp.WnaT),
        mid=tuple(pack_b(W) for W, _ in mlp.mid),
        Wo=pack_b(torch.cat([mlp.WowT, mlp.WoaT], dim=0), n_mult=8))


def mlp_operands(ops: dict) -> MlpOperands:
    """``eps_cm.operands`` -> the kernel's MLP operands (with the packed
    matrices when the compute dtype is bfloat16).  Raises where the layers do
    not chain, as with no hidden layer (``hiddens=()``): the split MLP needs
    a layer 1 whose outputs the output layer reads."""
    c = lambda x: x.contiguous()
    widths = [ops["base_cm"].shape[1]] + [W.shape[0] for W, _ in ops["mid"]]
    reads = [W.shape[1] for W, _ in ops["mid"]] + [ops["WowT"].shape[1]]
    if widths != reads:
        raise ValueError(
            f"superstep: the split eps MLP needs at least one hidden layer, "
            f"each layer reading the one before it: layer widths {widths}, "
            f"read as {reads}")
    mlp = MlpOperands(
        base=c(ops["base_cm"]), WnwT=c(ops["WnwT"]), WnaT=c(ops["WnaT"]),
        mid=tuple((c(W), c(b)) for W, b in ops["mid"]),
        WowT=c(ops["WowT"]), WoaT=c(ops["WoaT"]), bow=c(ops["bow"]),
        boa=c(ops["boa"]))
    if mlp.base.dtype == torch.bfloat16:
        mlp = mlp._replace(packed=pack_mlp(mlp))
    return mlp


def step_tables(cfg: Config, coeffs, cm_ops: dict, gscale: Tensor,
                maximize: bool):
    """Per-denoise-step inputs for steps t = T-1 .. 1, built once per plan
    (``pstl_tpu/diffusion.py:_reverse_superstep``): ``te_all`` (T-1, h1) =
    pos_encoding(t) in the compute dtype @ Wt, and ``gvec_all`` (T-1, 8)
    float32 = [beta, thres, gscale, c1, c2, c3, 0, 0]."""
    from pstl_tpu_torch.models.net import Net, pos_encoding
    T = cfg.diffusion_steps
    dev = coeffs.beta.device
    ts = torch.arange(T - 1, 0, -1, device=dev)
    Wt = cm_ops["Wt"]
    te_all = pos_encoding(ts[:, None].float(), Net.TIME_DIM).to(Wt.dtype) \
        @ Wt
    beta, alpha, alpha_hat = (coeffs.beta[ts], coeffs.alpha[ts],
                              coeffs.alpha_hat[ts])
    thres = 100.0 if maximize else cfg.stl_nn_thres
    ones = torch.ones_like(beta)
    gvec_all = torch.stack(
        [beta, thres * ones, gscale.to(beta.dtype) * ones,
         (1 - alpha) / torch.sqrt(1 - alpha_hat), torch.sqrt(alpha),
         cfg.sample_noise_scale * torch.sqrt(beta), 0 * ones, 0 * ones],
        dim=1)
    return te_all.contiguous(), gvec_all.float().contiguous()


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def eps_plain(xw: Tensor, xa: Tensor, te: Tensor, mlp: MlpOperands):
    """``_eps_mlp_k`` on (bs, T, R) controls: fp32 sums of products of
    operands rounded to the compute dtype, ReLU and a rounding to it after
    each hidden layer, an fp32 output layer plus the residual x."""
    dt = mlp.base.dtype
    f = lambda v: v.float()
    rnd = lambda v: v.to(dt).float()
    h = (f(mlp.base) + f(te)[None, :, None] + f(mlp.WnwT) @ rnd(xw)
         + f(mlp.WnaT) @ rnd(xa))                           # (bs, h1, R)
    h = rnd(torch.relu(h))
    for W, b in mlp.mid:
        h = rnd(torch.relu(f(W) @ h + f(b)))
    return f(mlp.WowT) @ h + f(mlp.bow) + xw, f(mlp.WoaT) @ h + f(mlp.boa) + xa


def superstep_plain(x: Tensor, z: Tensor, te: Tensor, gvec: Tensor,
                    mlp: MlpOperands, gops: gk.Operands,
                    p: gk.KernelParams, guided: bool) -> Tensor:
    """One denoise step in PyTorch ops: (bs, T, 2, R) -> (bs, T, 2, R)."""
    xw, xa = x[:, :, 0], x[:, :, 1]
    epsw, epsa = eps_plain(xw, xa, te, mlp)
    c1, c2, c3 = gvec[3], gvec[4], gvec[5]
    muw = (xw - c1 * epsw) / c2
    mua = (xa - c1 * epsa) / c2
    if guided:
        muw, mua = gk.guidance_fused_plain(
            muw.contiguous(), mua.contiguous(), *gops[:-1], gvec[:3], p)
    return torch.stack([muw + c3 * z[:, :, 0], mua + c3 * z[:, :, 1]],
                       dim=2)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double


def _lib():
    from pstl_tpu_torch.ops import _build
    fn = _build.load("superstep").pstl_superstep
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 6 + [ctypes.POINTER(_P)] * 2
                       + [ctypes.POINTER(_I), _I] + [_P] * 6
                       + [ctypes.POINTER(_P)] + [_P] * 12
                       + [_I] * 10 + [_F] * 5 + [_D] * 2 + [_I] * 3 + [_P])
        fn.restype = _I
    return fn


def _launch(x, z, te, gvec, mlp: MlpOperands, gops: gk.Operands,
            p: gk.KernelParams, guided: bool) -> Tensor:
    global launches, guided_launches
    bs, T, _, R = x.shape
    dt = mlp.base.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"superstep: compute dtype {dt} is neither bfloat16 "
                        f"nor float32")
    dims = [mlp.base.shape[1]] + [W.shape[0] for W, _ in mlp.mid]
    nmid = len(mlp.mid)
    if nmid > _MAXMID or max(dims) > _MAXH:
        raise ValueError(f"superstep: the MLP is beyond the kernel's limits "
                         f"(at most {_MAXMID} mid layers, widths <= {_MAXH})"
                         f": widths {dims}")
    dev = x.device
    gk.check_operands(gops[:-1], p, bs, T, R, dev, "superstep")
    f32 = torch.float32
    h1, hl = dims[0], dims[-1]
    checks = [("x", x, (bs, T, 2, R), f32), ("z", z, (bs, T, 2, R), f32),
              ("gvec", gvec, (8,), f32), ("te", te, (h1,), dt),
              ("base", mlp.base, (bs, h1, R), dt),
              ("WnwT", mlp.WnwT, (h1, T), dt),
              ("WnaT", mlp.WnaT, (h1, T), dt),
              ("WowT", mlp.WowT, (T, hl), dt),
              ("WoaT", mlp.WoaT, (T, hl), dt),
              ("bow", mlp.bow, (T, 1), dt), ("boa", mlp.boa, (T, 1), dt)]
    for i, (W, b) in enumerate(mlp.mid):
        checks += [(f"mid[{i}].W", W, (dims[i + 1], dims[i]), dt),
                   (f"mid[{i}].b", b, (dims[i + 1], 1), dt)]
    for name, t, shape, dtype in checks:
        gk._check(name, t, shape, dev, dtype, who="superstep")
    bf16 = dt == torch.bfloat16
    packed = None
    if bf16:
        packed = mlp.packed
        if packed is None:
            raise ValueError("superstep: bfloat16 weights need their packed "
                             "form (mlp_operands, or pack_mlp)")
        for name, t in (("Wnw", packed.Wnw), ("Wna", packed.Wna),
                        ("Wo", packed.Wo),
                        *((f"mid[{i}]", W) for i, W in enumerate(packed.mid))):
            if t.device != dev or t.dtype != dt or not t.is_contiguous():
                raise ValueError(f"superstep: packed {name} must be a "
                                 f"contiguous {dt} tensor on {dev}")
    out = torch.empty_like(x)
    midW = (_P * max(nmid, 1))(*[W.data_ptr() for W, _ in mlp.mid])
    midb = (_P * max(nmid, 1))(*[b.data_ptr() for _, b in mlp.mid])
    pmid = (_P * max(nmid, 1))(*[W.data_ptr() for W in
                                 (packed.mid if bf16 else ())])
    cdims = (_I * len(dims))(*dims)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(
        x.data_ptr(), z.data_ptr(), mlp.base.data_ptr(), te.data_ptr(),
        mlp.WnwT.data_ptr(), mlp.WnaT.data_ptr(), midW, midb, cdims, nmid,
        mlp.WowT.data_ptr(), mlp.WoaT.data_ptr(), mlp.bow.data_ptr(),
        mlp.boa.data_ptr(),
        *((packed.Wnw.data_ptr(), packed.Wna.data_ptr(), pmid,
           packed.Wo.data_ptr()) if bf16 else (None, None, pmid, None)),
        *(t.data_ptr() for t in gops[:-1]),
        gvec.data_ptr(), out.data_ptr(), bs, T, R, p.M, p.S, p.K, p.nLe,
        p.nLn, p.nt2, p.niters, p.tau, p.dt, p.mul_w, p.mul_a, p.lr,
        p.ego_L, p.re, gk.flags(p), int(bf16), int(guided), stream)
    if err != 0:
        raise RuntimeError(f"superstep kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    guided_launches += int(guided)
    return out


def superstep(x: Tensor, z: Tensor, te: Tensor, gvec: Tensor,
              mlp: MlpOperands, gops: gk.Operands, p: gk.KernelParams,
              guided: bool) -> Tensor:
    """One denoise step: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.device.type == "cuda":
        return _launch(x, z, te, gvec, mlp, gops, p, guided)
    if x.device.type == "cpu":
        return superstep_plain(x, z, te, gvec, mlp, gops, p, guided)
    raise ValueError(f"superstep: no implementation for device {x.device}")
