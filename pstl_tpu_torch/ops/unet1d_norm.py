"""The activation pass between two convolutions of ConditionalUnet1D
(``models/unet1d.py``), on channels-last activations: a Conv1dBlock's
convolution bias, GroupNorm, Mish, then the residual block's FiLM or
residual sum, in one pass.

:func:`norm_mish` takes the convolution's output ``y`` (n, L, C) in the
compute dtype (bfloat16, or float32), computes in float32

    v = y + bias;  u = GroupNorm(v) (per row and group of C / G channels
    over all L positions: the mean, then the variance around it; the bias
    folded into the shift, u = y a + sh);  m = Mish(u) (:func:`mish`);
    out = film[:, :C] * m + film[:, C:]   (FiLM; ``m + film`` without scale)
        | m + res                         (no res_bias: res is the float32
                                           residual stream)
        | m + (res + res_bias)            (res in the compute dtype: a 1x1
                                           residual convolution's output)
        | m

and returns ``(out in y's dtype, out in float32 or None)``: the float32
copy where ``stream32`` asks for it (the next residual block's identity
input).  On a CUDA tensor, with autograd not recording through its
operands, it launches the hand-written kernel of ``csrc/unet1d_norm.cu``;
everywhere else (a CPU tensor, or autograd recording: the training path,
for which there is no backward kernel) it runs :func:`norm_mish_plain`,
the same arithmetic in PyTorch ops.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

#: kernel launches since the last reset (the plain version does not count)
launches = 0

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _check_groups(C: int, G: int) -> None:
    if C % G or (C // G) % 8:
        raise ValueError(f"unet1d_norm: {C} channels in {G} groups: the "
                         f"group width must be a whole multiple of 8")


def mish(u: Tensor) -> Tensor:
    """Mish, u tanh(log(1 + e^u)), as the kernel computes it: u n / (n +
    2) with n = e^u (e^u + 2), and u itself above u = 20 (where n / (n +
    2) is 1 in float32)."""
    e = torch.exp(torch.clamp(u, max=20.0))
    n = e * (e + 2.0)
    return torch.where(u > 20.0, u, u * (n / (n + 2.0)))


def norm_mish_plain(y: Tensor, bias: Tensor, gamma: Tensor, beta: Tensor,
                    groups: int, eps: float, film: Optional[Tensor] = None,
                    film_scale: bool = True, res: Optional[Tensor] = None,
                    res_bias: Optional[Tensor] = None,
                    stream32: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
    """:func:`norm_mish` in PyTorch ops, the kernel's arithmetic: the group
    mean first, then the mean of the squared deviations around it, and
    the bias folded into GroupNorm's shift."""
    n, L, C = y.shape
    cg = C // groups
    yg, bg = y.float().view(n, L, groups, cg), bias.float().view(groups, cg)
    v = yg + bg
    count = L * cg
    mean = v.sum((1, 3), keepdim=True) / count
    d = v - mean
    var = (d * d).sum((1, 3), keepdim=True) / count
    # u = y a + sh: GroupNorm's scale and shift with the bias folded in
    a = gamma.view(groups, cg) * (1.0 / torch.sqrt(var + eps))
    sh = beta.view(groups, cg) + (bg - mean) * a
    m = mish(yg * a + sh).view(n, L, C)
    if film is not None:
        f = film.float()[:, None, :]
        out = f[..., :C] * m + f[..., C:] if film_scale else m + f
    elif res is not None and res_bias is None:
        out = m + res
    elif res is not None:
        out = m + (res.float() + res_bias.float())
    else:
        out = m
    return out.to(y.dtype), (out if stream32 else None)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _limits():
    """(the threads a block aims at, most threads a block, most groups,
    most bytes of a row) as the kernel's source defines them."""
    from pstl_tpu_torch.ops import _build
    m = _build.source_macros("unet1d_norm")
    return m["UN_THREADS"], m["UN_MAXB"], m["UN_MAXG"], m["UN_SMEM_MAX"]


def _lib():
    from pstl_tpu_torch.ops import _build
    lib = _build.load("unet1d_norm")
    fn = lib.pstl_unet1d_norm
    if fn.argtypes is None:
        fn.argtypes = ([_I] + [_P] * 5 + [_I] + [_P] * 5 + [_I] * 4 + [_F]
                       + [_I, _P])
        fn.restype = _I
    return lib


def threads(L: int, C: int, dtype: torch.dtype) -> int:
    """Threads a block for a row of (L, C): VC = C / (16 bytes' elements)
    vectors a position times P positions a pass, P = UN_THREADS / VC where
    that is at least 1 and at most L."""
    want, maxb, _, smem_max = _limits()
    size = dtype.itemsize
    vc = C // (16 // size)
    b = vc * min(max(want // vc, 1), L)
    if b > maxb or L * C * size > smem_max:
        raise ValueError(f"unet1d_norm: a row of {L} x {C} in {dtype} needs "
                         f"{b} threads and {L * C * size} bytes of shared "
                         f"memory, beyond the kernel's {maxb} and "
                         f"{smem_max}")
    return b


def _check(name: str, x: Tensor, shape, dtype, dev) -> None:
    if x.device != dev:
        raise ValueError(f"unet1d_norm: {name} is on {x.device}, expected "
                         f"{dev}")
    if x.dtype != dtype:
        raise TypeError(f"unet1d_norm: {name} must be {dtype}, got "
                        f"{x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"unet1d_norm: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"unet1d_norm: {name} must be contiguous and "
                         f"16-byte aligned")


def _launch(y, bias, gamma, beta, groups, eps, film, film_scale, res,
            res_bias, stream32):
    global launches
    n, L, C = y.shape
    dt, dev = y.dtype, y.device
    if dt not in _DTYPES:
        raise TypeError(f"unet1d_norm: no kernel for {dt}")
    _check_groups(C, groups)
    if groups > _limits()[2]:
        raise ValueError(f"unet1d_norm: {groups} groups, beyond the "
                         f"kernel's {_limits()[2]}")
    block = threads(L, C, dt)
    _check("y", y, (n, L, C), dt, dev)
    _check("bias", bias, (C,), dt, dev)
    _check("gamma", gamma, (C,), torch.float32, dev)
    _check("beta", beta, (C,), torch.float32, dev)
    ptrs = {"film": None, "res32": None, "res": None, "res_bias": None}
    if film is not None:
        _check("film", film, (n, 2 * C if film_scale else C), dt, dev)
        ptrs["film"] = film.data_ptr()
    elif res is not None and res_bias is None:
        _check("res", res, (n, L, C), torch.float32, dev)
        ptrs["res32"] = res.data_ptr()
    elif res is not None:
        _check("res", res, (n, L, C), dt, dev)
        _check("res_bias", res_bias, (C,), dt, dev)
        ptrs["res"], ptrs["res_bias"] = res.data_ptr(), res_bias.data_ptr()
    out = torch.empty((n, L, C), dtype=dt, device=dev)
    out32 = torch.empty((n, L, C), dtype=torch.float32, device=dev) \
        if stream32 and dt != torch.float32 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().pstl_unet1d_norm(
        _DTYPES[dt], y.data_ptr(), bias.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), ptrs["film"], int(film_scale), ptrs["res32"],
        ptrs["res"], ptrs["res_bias"], out.data_ptr(),
        None if out32 is None else out32.data_ptr(), n, L, C, groups,
        float(eps), block, stream)
    if err != 0:
        raise RuntimeError(f"unet1d_norm kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    if stream32 and out32 is None:
        out32 = out
    return out, out32


def norm_mish(y: Tensor, bias: Tensor, gamma: Tensor, beta: Tensor,
              groups: int, eps: float, film: Optional[Tensor] = None,
              film_scale: bool = True, res: Optional[Tensor] = None,
              res_bias: Optional[Tensor] = None,
              stream32: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
    """The kernel for CUDA tensors that autograd does not record, the plain
    version otherwise (module docstring)."""
    args = (y, bias, gamma, beta, groups, eps, film, film_scale, res,
            res_bias, stream32)
    recording = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (y, bias, gamma, beta, film, res, res_bias))
    if y.device.type == "cuda" and not recording:
        return _launch(*args)
    return norm_mish_plain(*args)
