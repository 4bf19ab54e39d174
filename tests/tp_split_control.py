"""A one-process control for the port's tensor-parallel denoiser: the
products that tensor parallelism splits (npcd_tpu_torch/parallel/tp.py),
computed as the model ranks compute them, in one process and on the whole
parameters. No JAX: chip_smoke.py (phase 27) imports it too.

In bf16 a tp step differs from one process in the roundings of its split
products, and Adam's first steps turn a near-zero gradient's changed sign
into a move of up to 2 lr. The control has those roundings and nothing
else of tp: at tp 2 the tp step's parameters equal the control's (bitwise
on the CPU), so a check against it can be as tight as the f32 checks,
and a wrong reduce, or a remat replay that gets one wrong, shows.
"""
import torch
import torch.nn.functional as F


class _ContiguousGrad(torch.autograd.Function):
    """Identity; the cotangent made contiguous, as a model rank's own output
    gets it (the GEMMs of the backward then see a rank's layouts)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def split_products(denoiser, tp: int) -> None:
    """Patch ``denoiser`` (an NPCDTransformer built with tp 1) in place.

    c_qkv and c_fc (of every block and of time_embed): tp products on
    blocks of their output columns, whose input gradients autograd sums in
    the compute dtype, as tp_replicate's reduce over the model group does.
    c_proj: tp partial products on blocks of its input rows, each rounded to
    the compute dtype and summed in it, as tp_reduce does, then the bias.
    The sums run in rank order, which at tp 2 is any order. Every block
    and its cotangent is made contiguous, as on a rank, so that each GEMM
    sees a rank's shapes and layouts."""
    def column(m):
        def forward(x):
            dt = m.compute_dtype
            x = x.to(dt)
            return torch.cat([_ContiguousGrad.apply(F.linear(x, w))
                              for w in m.weight.to(dt).chunk(tp, 0)], -1) + m.bias.to(dt)
        return forward

    def row(m):
        def forward(x):
            dt = m.compute_dtype
            parts = [F.linear(xi.contiguous(), wi.contiguous())
                     for xi, wi in zip(x.to(dt).chunk(tp, -1), m.weight.to(dt).chunk(tp, 1))]
            return sum(parts[1:], parts[0]) + m.bias.to(dt)
        return forward

    for mod in [denoiser.time_embed] + [m for b in denoiser.resblocks for m in (b.attn, b.mlp)]:
        up = mod.c_qkv if hasattr(mod, "c_qkv") else mod.c_fc
        up.forward = column(up)
        mod.c_proj.forward = row(mod.c_proj)
