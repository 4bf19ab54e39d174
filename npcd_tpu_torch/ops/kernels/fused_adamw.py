"""K3: one-pass AdamW + EMA + sum of squared gradients (Triton).

Replaces npcd_tpu/ops/pallas/fused_adamw.py:adamw_ema_leaf (_kernel): for
every element, with bc1, bc2, the clip scale and the EMA decays read from
``scalars`` = [bc1, bc2, clip_scale, decay_0, ...] (f32, on the device),

    sumsq += g * g                     (pre-clip, one partial per program)
    g      = g * clip_scale            (only with use_clip)
    mu     = (1 - b1) g + b1 mu
    nu     = (1 - b2) g^2 + b2 nu
    p      = p + (-lr) ((mu / bc1) / (sqrt(nu / bc2) + eps) + wd p)
    ema_i  = ema_i d_i + p (1 - d_i)

in place on p, mu, nu and every EMA, in the op order of npcd_tpu's
FusedAdamWEma.update closure (train/fused_update.py:144-167). This is not
torch.optim.AdamW, which decays the weights before the step and places eps
after sqrt(v)/sqrt(bc2).

What bounds it on the H100: ~7 flops per element against (4 + n_ema) f32
reads and (3 + n_ema) writes, so it is bound by memory bandwidth: with one
EMA, 36 bytes per parameter, ~10.9 GB per step over the 302M-parameter
denoiser, ~3.3 ms at 3.35 TB/s. Design: the trainer keeps parameters,
gradients, moments and EMAs as flat buffers, and the kernel makes one pass
over all of them in blocks of 4096 elements, reading and writing each once;
each program writes its partial sum of g^2 and the wrapper sums the
partials (deterministic, no atomics). Divisions and the square root are
IEEE-rounded (div_rn, sqrt_rn) as in the plain version.

``adamw_ema`` launches the kernel for CUDA tensors and runs
``adamw_ema_plain`` for CPU tensors. Triton is imported only when the
kernel is launched.
"""
from __future__ import annotations

import functools

import torch

from . import build

BLOCK = 4096


def adamw_ema_plain(g: torch.Tensor, p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                    emas: torch.Tensor | None, scalars: torch.Tensor, *, b1: float,
                    b2: float, eps: float, lr: float, wd: float,
                    use_clip: bool) -> torch.Tensor:
    """The closure of npcd_tpu's FusedAdamWEma.update, op by op, in place on
    p, mu, nu and emas [n_ema, N] -> the pre-clip sum of g^2 (0-dim f32)."""
    sumsq = (g * g).sum()
    bc1, bc2, clip = scalars[0], scalars[1], scalars[2]
    if use_clip:
        g = g * clip
    mu2 = (1.0 - b1) * g + b1 * mu
    nu2 = (1.0 - b2) * (g * g) + b2 * nu
    upd = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps)
    upd = upd + wd * p
    p.copy_(p + (-lr) * upd)
    mu.copy_(mu2)
    nu.copy_(nu2)
    if emas is not None:
        for i in range(emas.shape[0]):
            d = scalars[3 + i]
            emas[i].copy_(emas[i] * d + p * (1.0 - d))
    return sumsq


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def adamw_ema_kernel(g_ptr, p_ptr, mu_ptr, nu_ptr, ema_ptr, scal_ptr, sumsq_ptr, n,
                         one_minus_b1, b1, one_minus_b2, b2, eps, neg_lr, wd,
                         N_EMA: tl.constexpr, USE_CLIP: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        g = tl.load(g_ptr + offs, mask=m, other=0.0)
        tl.store(sumsq_ptr + pid, tl.sum(g * g, axis=0))
        if USE_CLIP:
            g = g * tl.load(scal_ptr + 2)
        bc1 = tl.load(scal_ptr)
        bc2 = tl.load(scal_ptr + 1)
        mu2 = one_minus_b1 * g + b1 * tl.load(mu_ptr + offs, mask=m, other=0.0)
        nu2 = one_minus_b2 * (g * g) + b2 * tl.load(nu_ptr + offs, mask=m, other=0.0)
        p = tl.load(p_ptr + offs, mask=m, other=0.0)
        upd = tl.div_rn(tl.div_rn(mu2, bc1), tl.sqrt_rn(tl.div_rn(nu2, bc2)) + eps)
        p2 = p + neg_lr * (upd + wd * p)
        tl.store(p_ptr + offs, p2, mask=m)
        tl.store(mu_ptr + offs, mu2, mask=m)
        tl.store(nu_ptr + offs, nu2, mask=m)
        for i in tl.static_range(N_EMA):
            d = tl.load(scal_ptr + 3 + i)
            e_ptr = ema_ptr + n.to(tl.int64) * i + offs
            e = tl.load(e_ptr, mask=m, other=0.0)
            tl.store(e_ptr, e * d + p2 * (1.0 - d), mask=m)

    return adamw_ema_kernel


def adamw_ema(g: torch.Tensor, p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
              emas: torch.Tensor | None, scalars: torch.Tensor, *, b1: float, b2: float,
              eps: float, lr: float, wd: float, use_clip: bool) -> torch.Tensor:
    """One AdamW + EMA step in place on the f32 buffers p, mu, nu (any
    shape, all like g) and emas [n_ema, *g.shape] (or None); ``scalars`` =
    [bc1, bc2, clip_scale, decays...] f32 -> the pre-clip sum of g^2."""
    what = "adamw_ema"
    n_ema = 0 if emas is None else emas.shape[0]
    build.require(p.shape == g.shape and mu.shape == g.shape and nu.shape == g.shape,
                  what, "p, mu and nu must match g")
    build.require(emas is None or emas.shape[1:] == g.shape, what,
                  "emas must be [n_ema, *g.shape]")
    build.require(scalars.shape == (3 + n_ema,), what,
                  f"scalars must be [3 + {n_ema}]: bc1, bc2, clip scale, decays")
    tensors = (g, p, mu, nu, scalars) + ((emas,) if emas is not None else ())
    kw = dict(b1=b1, b2=b2, eps=eps, lr=lr, wd=wd, use_clip=use_clip)
    if build.route(what, *tensors) == "cpu":
        return adamw_ema_plain(g, p, mu, nu, emas, scalars, **kw)
    build.require_f32_contiguous(what, aligned=False, g=g, p=p, mu=mu, nu=nu,
                                 scalars=scalars,
                                 **({"emas": emas} if emas is not None else {}))
    n = g.numel()
    n_prog = -(-n // BLOCK)
    partial = torch.empty(n_prog, device=g.device, dtype=torch.float32)
    _kernel()[(n_prog,)](g, p, mu, nu, emas if emas is not None else p, scalars, partial, n,
                         1.0 - b1, b1, 1.0 - b2, b2, eps, -lr, wd, N_EMA=n_ema,
                         USE_CLIP=use_clip, BLOCK=BLOCK, num_warps=8)
    adamw_ema.launches += 1
    return partial.sum()


adamw_ema.launches = 0
