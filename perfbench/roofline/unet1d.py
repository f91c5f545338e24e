"""FLOPs of one ConditionalUnet1D pass (``models/unet1d.py``), from the
configuration's ``eps_net`` widths: 2 a multiply-add of every convolution
(the padded positions included, as the layer computes them), transposed
convolution (every input position times every tap), 1x1 residual
convolution, FiLM linear (``cond_encoder``) and step-encoder linear.
GroupNorm, Mish and the sums are not counted.  Equal to
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference
(``perfbench/tests/test_perfbench_unet1d.py``)."""

from __future__ import annotations

#: the planner's global condition a row: scene feature, highlevel, stlp
GLOBAL_DIM = 7 * 32 + 1 + 6
IN_DIM = 2


def conv_flops(rows: int, length: int, ci: int, co: int, k: int) -> int:
    """A convolution with ``length`` output positions (or, transposed,
    input positions) a row."""
    return 2 * rows * length * ci * co * k


def flops(spec: dict, rows: int, nt: int, step_rows: int = 1) -> float:
    """One pass over ``rows`` rows of horizon ``nt``, its step encoder on
    ``step_rows`` timesteps (the planner's chain: 1, every row shares
    t)."""
    E, k = spec["step_embed_dim"], spec["kernel_size"]
    cond = E + GLOBAL_DIM
    film = 2 if spec["cond_predict_scale"] else 1

    def res(ci, co, L):
        f = (conv_flops(rows, L, ci, co, k) + conv_flops(rows, L, co, co, k)
             + 2 * rows * cond * film * co)
        if ci != co:
            f += conv_flops(rows, L, ci, co, 1)
        return f

    total = 2 * step_rows * (E * 4 * E + 4 * E * E)
    dims = [IN_DIM] + list(spec["down_dims"])
    pairs = list(zip(dims[:-1], dims[1:]))
    L = nt
    for i, (a, b) in enumerate(pairs):
        total += res(a, b, L) + res(b, b, L)
        if i < len(pairs) - 1:
            L //= 2
            total += conv_flops(rows, L, b, b, 3)
    total += 2 * res(dims[-1], dims[-1], L)
    for a, b in reversed(pairs[1:]):
        total += res(2 * b, a, L) + res(a, a, L)
        total += conv_flops(rows, L, a, a, 4)
        L *= 2
    s = dims[1]
    total += conv_flops(rows, L, s, s, k) + conv_flops(rows, L, s, IN_DIM, 1)
    return float(total)
