"""soft_argmin: expected disparity under softmax(-cost) over the last axis.

``disp[b, h, w] = scale * sum_d d * softmax(-cost[b, h, w, :])[d]``, or
``fb / max(disp, 1e-6)`` with ``epilogue="depth"``; always float32.

Kernel 9 of the port, ``csrc/soft_argmin.cu``: the counterpart of the TPU
kernel ``scenedepthestimation_tpu/ops/pallas/soft_argmin.py::
soft_argmin_pallas``. :func:`soft_argmin` launches it for a CUDA tensor
and takes :func:`soft_argmin_plain` for a CPU tensor. On the card a group
of lanes shares a pixel and reads its row once as 16-byte vectors
(:func:`lane_plan`); other rows take a looped path, one warp a pixel.

The backward, for an fp32 cost and no epilogue, is the kernel
``sde_soft_argmin_bwd`` in the same source (:func:`soft_argmin_backward`),
registered as the op's autograd formula: with ``p = softmax(-cost)`` and
``E = sum_d d p_d``, ``dcost_k = -g * scale * p_k * (k - E)``, recomputed
from the cost on the forward's lane groups (:func:`lane_plan`), a looped
path where there is no plan. It replaces what XLA derives for the JAX
package's readout (``scenedepthestimation_tpu/ops/soft_argmin.py::
_soft_argmin_jnp``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from scenedepthestimation_tpu_torch.ops.cuda import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
EPILOGUES = {"none": 0, "depth": 1}
MAX_VECS = 4  # 16-byte vectors a lane of the kernel holds


@functools.lru_cache(maxsize=None)
def lane_plan(d: int, dtype: torch.dtype) -> Optional[Tuple[int, int]]:
    """(lanes a pixel, 16-byte vectors a lane) of the kernel's fast path for
    rows of ``d`` values of ``dtype``: the fewest lanes (a power of two, at
    most 32) that hold the row in at most :data:`MAX_VECS` vectors each,
    lane j taking the row's vectors j, j + lanes, ... None where a row is
    not a whole number of 16-byte vectors or does not fit: the looped path
    (one warp a pixel) takes it."""
    esize = torch.empty((), dtype=dtype).element_size()
    if (d * esize) % 16:
        return None
    nvec, lanes = d * esize // 16, 1
    while -(-nvec // lanes) > MAX_VECS:
        lanes *= 2
        if lanes > 32:
            return None
    return lanes, -(-nvec // lanes)


def _check(cost: torch.Tensor, epilogue: str) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if cost.dim() < 1 or cost.shape[-1] < 1:
        raise ValueError(f"cost needs a non-empty last axis, got {tuple(cost.shape)}")


def soft_argmin_plain(
    cost: torch.Tensor, scale: float = 1.0, epilogue: str = "none", fb: float = 0.0
) -> torch.Tensor:
    """Plain PyTorch version: (..., D) matching cost -> (...) float32."""
    _check(cost, epilogue)
    weights = torch.softmax(-cost.float(), dim=-1)
    disps = torch.arange(cost.shape[-1], dtype=torch.float32, device=cost.device)
    disp = (weights * disps).sum(-1) * scale
    if epilogue == "depth":
        disp = fb / torch.clamp(disp, min=1e-6)
    return disp


def _soft_argmin(
    cost: torch.Tensor, scale: float = 1.0, epilogue: str = "none", fb: float = 0.0
) -> torch.Tensor:
    """The body of :func:`soft_argmin`, and the implementation of its op."""
    if cost.device.type == "cpu":
        return soft_argmin_plain(cost, scale, epilogue, fb)
    if cost.device.type != "cuda":
        raise ValueError(f"soft_argmin runs on cpu or cuda, not {cost.device}")
    _check(cost, epilogue)
    if cost.dtype not in _DTYPES:
        raise TypeError(f"soft_argmin kernel takes float32 or bfloat16, not {cost.dtype}")
    if not cost.is_contiguous():
        raise ValueError("soft_argmin kernel needs a contiguous cost")
    out = torch.empty(cost.shape[:-1], dtype=torch.float32, device=cost.device)
    if out.numel() == 0:
        return out
    plan = lane_plan(cost.shape[-1], cost.dtype)
    if cost.data_ptr() % 16:
        plan = None
    err = _build.lib().sde_soft_argmin(
        cost.data_ptr(), out.data_ptr(), out.numel(), cost.shape[-1],
        _DTYPES[cost.dtype], float(scale), EPILOGUES[epilogue], float(fb),
        *(plan or (0, 0)), cost.device.index, _build.stream_of(cost),
    )
    _build.check(err, "soft_argmin")
    _build.LAUNCHES["soft_argmin"] += 1
    return out


def _soft_argmin_fake(cost, scale, epilogue, fb):
    return cost.new_empty(tuple(cost.shape[:-1]), dtype=torch.float32)


soft_argmin_op = _build.register_op(
    "soft_argmin",
    "(Tensor cost, float scale, str epilogue, float fb) -> Tensor",
    _soft_argmin, _soft_argmin_fake,
)


def soft_argmin_backward_plain(
    grad: torch.Tensor, cost: torch.Tensor, scale: float = 1.0
) -> torch.Tensor:
    """Plain PyTorch version of the backward (no epilogue): ``-grad * scale
    * p_k * (k - E)`` with ``p = softmax(-cost)`` over the last axis and
    ``E = sum_k k p_k``, in fp32, returned in the cost's dtype."""
    p = torch.softmax(-cost.float(), dim=-1)
    k = torch.arange(cost.shape[-1], dtype=torch.float32, device=cost.device)
    mean = (p * k).sum(-1, keepdim=True)
    return (-(grad.float() * scale)[..., None] * p * (k - mean)).to(cost.dtype)


def soft_argmin_backward(
    grad: torch.Tensor, cost: torch.Tensor, scale: float = 1.0, epilogue: str = "none"
) -> torch.Tensor:
    """The gradient of the readout with respect to ``cost``, given ``grad``
    of its output: the backward kernel on CUDA (fp32 cost; ``grad`` made
    contiguous), the plain version on the CPU. The depth epilogue is not on
    any training path, and its backward raises."""
    if epilogue != "none":
        raise NotImplementedError(f"soft_argmin's backward takes epilogue 'none', not {epilogue!r}")
    if cost.device.type == "cpu":
        return soft_argmin_backward_plain(grad, cost, scale)
    _check(cost, epilogue)
    if cost.dtype != torch.float32:
        raise TypeError(f"soft_argmin's backward kernel takes a float32 cost, not {cost.dtype}")
    if tuple(grad.shape) != tuple(cost.shape[:-1]) or grad.device != cost.device:
        raise ValueError(
            f"grad must be {tuple(cost.shape[:-1])} on {cost.device}, got {tuple(grad.shape)} "
            f"on {grad.device}"
        )
    if not cost.is_contiguous():
        raise ValueError("soft_argmin's backward kernel needs a contiguous cost")
    grad = grad.float().contiguous()
    out = torch.empty_like(cost)
    if out.numel() == 0:
        return out
    plan = lane_plan(cost.shape[-1], cost.dtype)
    if cost.data_ptr() % 16:
        plan = None
    err = _build.lib().sde_soft_argmin_bwd(
        grad.data_ptr(), cost.data_ptr(), out.data_ptr(), grad.numel(), cost.shape[-1],
        float(scale), *(plan or (0, 0)), cost.device.index, _build.stream_of(cost),
    )
    _build.check(err, "soft_argmin_bwd")
    _build.LAUNCHES["soft_argmin_bwd"] += 1
    return out


def _setup_context(ctx, inputs, output):
    cost, scale, epilogue, _ = inputs
    ctx.save_for_backward(cost)
    ctx.scale, ctx.epilogue = scale, epilogue


def _backward(ctx, grad):
    (cost,) = ctx.saved_tensors
    return soft_argmin_backward(grad, cost, ctx.scale, ctx.epilogue), None, None, None


soft_argmin_op.register_autograd(_backward, setup_context=_setup_context)


def soft_argmin(
    cost: torch.Tensor, scale: float = 1.0, epilogue: str = "none", fb: float = 0.0
) -> torch.Tensor:
    """The soft_argmin kernel on a CUDA tensor, its plain version on a CPU
    one. On CUDA the cost must be contiguous, float32 or bfloat16;
    anything else raises. A call that autograd records goes through the
    op, whose backward is :func:`soft_argmin_backward`."""
    if _build.tracing or _build.needs_grad(cost):
        return soft_argmin_op(cost, scale, epilogue, fb)
    return _soft_argmin(cost, scale, epilogue, fb)
