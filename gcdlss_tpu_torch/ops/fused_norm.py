"""Sparse batch norm fused with its residual add, ReLU and row mask (CUDA,
`csrc/batch_norm.cu`), and its plain version.

`sparse_batch_norm` is what `models.layers.SparseBatchNorm` calls. Over the
valid rows of x [N, C] it computes

    z = mask(act(round(round((x - mean) * rstd * weight + bias) + residual)))

with `round` to x's dtype, the residual optional and `act` "none" or "relu";
in training with the batch's mean and biased variance over the valid rows
(over every rank's rows with a process `group`), moving the running
buffers by `momentum` toward the mean and the unbiased variance unless
`update_stats` is false; in eval with the running buffers.

Replaces no TPU kernel: the JAX package leaves the norm and its neighbours
to XLA, which fuses them. On the card eager PyTorch took ~30 launches a norm
over the whole tensor in f32, and autograd kept two f32 copies of
(x - mean): the kernels read bf16 and write bf16, in three launches forward
(two passes of statistics, one that applies them) and two backward (the
sums, then dx), and the Function keeps x, the output and [C] vectors.

On the CPU the plain version runs, with today's eager arithmetic, forward and
backward (the backward recomputes the plain forward from the saved inputs and
differentiates it, so the gradient is the eager chain's bit for bit). For
CUDA tensors the wrapper launches the kernels or raises: bf16 or f32
activations, a bool row mask, f32 parameters and buffers. The forward and
the backward each run inside a span (`norm/fwd`, `norm/bwd`). A plain integer
counts the kernel launches (`sparse_batch_norm.launches`).
"""

from __future__ import annotations

import functools

import torch

from ..parallel.mesh import all_reduce
from ..utils.logging import span
from . import _build
from .conv import masked_batch_norm_stats

ACTS = ("none", "relu")
_DTYPES = (torch.bfloat16, torch.float32)


def _mask(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return x * valid[:, None].to(x.dtype)


def batch_norm_plain(x, valid, weight, bias, running_mean, running_var, training: bool,
                     momentum: float, eps: float, residual=None, act: str = "none", group=None,
                     update_stats: bool = True) -> torch.Tensor:
    """The eager chain, differentiable: the statistics and the affine map in
    f32, the output rounded to x's dtype and masked, then `+ residual`,
    ReLU and the mask again where a residual was added."""
    if training:
        mean, var, cnt = masked_batch_norm_stats(x.float(), valid, group)
        if update_stats:
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                running_mean.mul_(1 - momentum).add_(momentum * mean)
                running_var.mul_(1 - momentum).add_(momentum * unbiased)
    else:
        mean, var = running_mean, running_var
    scale = torch.rsqrt(var + eps) * weight
    out = _mask(((x.float() - mean) * scale + bias).to(x.dtype), valid)
    if residual is not None:
        out = out + residual
    if act == "relu":
        out = torch.relu(out)
    return out if residual is None else _mask(out, valid)


class _PlainNormFn(torch.autograd.Function):
    """The plain version with its backward inside a `norm/bwd` span."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, valid, running_mean, running_var, training,
                momentum, eps, act, group, update_stats):
        out = batch_norm_plain(x, valid, weight, bias, running_mean, running_var, training,
                               momentum, eps, residual, act, group, update_stats)
        stats = () if training else (running_mean.clone(), running_var.clone())
        ctx.save_for_backward(x, weight, bias, residual, valid, *stats)
        ctx.args = (training, momentum, eps, act, group)
        return out

    @staticmethod
    def backward(ctx, g):
        with span("norm/bwd"):
            x, weight, bias, residual, valid, *stats = ctx.saved_tensors
            training, momentum, eps, act, group = ctx.args
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip((x, weight, bias, residual), ctx.needs_input_grad)]
            rm, rv = stats if stats else (None, None)
            with torch.enable_grad():
                out = batch_norm_plain(leaves[0], valid, leaves[1], leaves[2], rm, rv, training,
                                       momentum, eps, leaves[3], act, group, update_stats=False)
                wanted = [t for t in leaves if t is not None and t.requires_grad]
                got = iter(torch.autograd.grad(out, wanted, g))
            grads = [next(got) if t is not None and t.requires_grad else None for t in leaves]
            return (*grads, None, None, None, None, None, None, None, None, None)


def _check(t: torch.Tensor, name: str, dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"sparse_batch_norm: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"sparse_batch_norm: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"sparse_batch_norm: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"sparse_batch_norm: {name} must be contiguous")


@functools.cache
def _row_blocks(n: int, c: int, elem: int, device_index: int) -> int:
    """Blocks along the rows of the reduction kernels (their partials' rows)."""
    with torch.cuda.device(device_index):
        return _build.library().gcd_bn_blocks(n, c, elem)


_COUNTERS = {}  # (device, stream) -> the reduction kernels' uint32 block counter, zero


def _counter(device, stream) -> torch.Tensor:
    """The counter the reduction kernels' last block finds itself by; it
    resets it to zero, so one buffer serves every launch on the stream."""
    key = (device.index, stream.cuda_stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def _ptr(t):
    return None if t is None else t.data_ptr()


class _FusedNormFn(torch.autograd.Function):
    """The kernels. Saves x, the valid mask, the weight, the statistics
    ([2C + 1]: the sums of x, the count, the centred squares; the running
    buffers' values in eval) and, under ReLU, the output."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, valid, running_mean, running_var, training,
                momentum, eps, act, group, update_stats):
        dev = x.device
        n, c = x.shape
        stream = torch.cuda.current_stream(dev)
        lib, st, bf16 = _build.library(), stream.cuda_stream, int(x.dtype == torch.bfloat16)
        stats = None
        if training:
            nb = _row_blocks(n, c, x.element_size(), dev.index)
            stats = torch.empty(2 * c + 1, dtype=torch.float32, device=dev)
            partial = torch.empty(c * nb, dtype=torch.float32, device=dev)
            counts = torch.empty(nb, dtype=torch.int32, device=dev)
            counter = _counter(dev, stream)
            for pas, part in ((0, slice(0, c + 1)), (1, slice(c + 1, 2 * c + 1))):
                _build.check(lib.gcd_bn_stats(
                    x.data_ptr(), valid.data_ptr(), stats.data_ptr(), partial.data_ptr(),
                    counts.data_ptr(), counter.data_ptr(), n, c, pas, nb, bf16, st),
                    "sparse_batch_norm statistics")
                if group is not None:
                    stats[part] = all_reduce(stats[part], group)
        out = torch.empty_like(x)
        _build.check(lib.gcd_bn_apply(
            x.data_ptr(), valid.data_ptr(), _ptr(residual), _ptr(stats), weight.data_ptr(),
            bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), out.data_ptr(),
            n, c, int(training), int(training and update_stats), int(act == "relu"),
            1 - momentum, momentum, eps, bf16, st), "sparse_batch_norm")
        sparse_batch_norm.launches += 3 if training else 1
        if not training and any(ctx.needs_input_grad[:4]):
            stats = torch.cat([running_mean, running_var])
        ctx.save_for_backward(x, valid, weight, stats, out if act == "relu" else None)
        ctx.args = (training, eps, act, group, residual is not None)
        return out

    @staticmethod
    def backward(ctx, g):
        with span("norm/bwd"):
            x, valid, weight, stats, z = ctx.saved_tensors
            training, eps, act, group, has_res = ctx.args
            dev = x.device
            n, c = x.shape
            g = g.contiguous()
            stream = torch.cuda.current_stream(dev)
            lib, st, bf16 = _build.library(), stream.cuda_stream, int(x.dtype == torch.bfloat16)
            nb = _row_blocks(n, c, x.element_size(), dev.index)
            # the statistics the kernels read: train [sums, cnt, squares];
            # eval the running buffers' values at the forward
            rm = rv = stats
            if not training:
                rm, rv = stats[:c], stats[c:]
                stats = None
            dres = torch.empty_like(x) if has_res and ctx.needs_input_grad[3] else None
            partial = torch.empty(2 * c * nb, dtype=torch.float32, device=dev)
            sums = torch.empty(2 * c, dtype=torch.float32, device=dev)
            dweight = torch.empty(c, dtype=torch.float32, device=dev)
            dbias = torch.empty(c, dtype=torch.float32, device=dev)
            _build.check(lib.gcd_bn_grad_sums(
                x.data_ptr(), valid.data_ptr(), g.data_ptr(), _ptr(z), _ptr(stats), _ptr(rm),
                _ptr(rv), _ptr(dres), partial.data_ptr(), _counter(dev, stream).data_ptr(),
                sums.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), n, c, int(training),
                int(act == "relu"), eps, nb, bf16, st), "sparse_batch_norm backward sums")
            sparse_batch_norm.launches += 1
            dx = None
            if ctx.needs_input_grad[0]:
                if training and group is not None:
                    sums = all_reduce(sums, group)
                dx = torch.empty_like(x)
                _build.check(lib.gcd_bn_grad_x(
                    x.data_ptr(), valid.data_ptr(), g.data_ptr(), _ptr(z), _ptr(stats),
                    _ptr(rm), _ptr(rv), weight.data_ptr(), sums.data_ptr(), dx.data_ptr(), n, c,
                    int(training), int(act == "relu"), eps, bf16, st),
                    "sparse_batch_norm backward dx")
                sparse_batch_norm.launches += 1
            return (dx, dweight, dbias, dres, None, None, None, None, None, None, None, None,
                    None)


def _card_checks(x, weight, bias, residual, valid, running_mean, running_var) -> None:
    dev = x.device
    if x.dtype not in _DTYPES:
        raise TypeError(f"sparse_batch_norm: x must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"sparse_batch_norm: x must have 2 dims, got shape {tuple(x.shape)}")
    n, c = x.shape
    _check(x, "x", x.dtype, (n, c), dev)
    _check(valid, "valid", torch.bool, (n,), dev)
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        _check(t, name, torch.float32, (c,), dev)
    if residual is not None:
        _check(residual, "residual", x.dtype, (n, c), dev)


def sparse_batch_norm(x: torch.Tensor, valid: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                      training: bool, momentum: float = 0.1, eps: float = 1e-5,
                      residual: torch.Tensor | None = None, act: str = "none", group=None,
                      update_stats: bool = True) -> torch.Tensor:
    """The norm of `models.layers.SparseBatchNorm` (module docstring): the
    kernels for CUDA tensors, the plain version on the CPU."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    with span("norm/fwd"):
        if x.device.type == "cpu":
            return _PlainNormFn.apply(x, weight, bias, residual, valid, running_mean,
                                      running_var, training, momentum, eps, act, group,
                                      update_stats)
        x = x.contiguous()
        residual = None if residual is None else residual.contiguous()
        _card_checks(x, weight, bias, residual, valid, running_mean, running_var)
        return _FusedNormFn.apply(x, weight, bias, residual, valid, running_mean, running_var,
                                  training, momentum, eps, act, group, update_stats)


sparse_batch_norm.launches = 0
