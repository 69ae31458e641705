"""winograd: a zero-padded 3x3 stride-1 conv in phase space as Winograd
F(2x2, 3x3), with bias, an optional residual and an optional ReLU fused.

The input comes as its four even/odd phases ``x[:, a::2, b::2, :]``
(``ops/winograd.space_to_phases``), the output goes out the same way. The
weights are ``U`` from ``ops/winograd.transform_weights``, (16, C, Co).

Kernel 5 of the port, ``csrc/winograd.cu``: the counterpart of the TPU
kernel ``scenedepthestimation_tpu/ops/pallas/winograd.py::
winograd_conv3x3_phases``. :func:`winograd_conv3x3_phases` launches it for
CUDA tensors and takes :func:`winograd_conv3x3_phases_plain` for CPU
tensors; there is no other route.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from scenedepthestimation_tpu_torch.ops.cuda import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

Phases = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check(phases, u, bias, residual_phases, out) -> None:
    if len(phases) != 4:
        raise ValueError(f"expected 4 phases, got {len(phases)}")
    shape = tuple(phases[0].shape)
    if len(shape) != 4:
        raise ValueError(f"phases must be (B, Hp, Wp, C), got {shape}")
    b, hp, wp, c = shape
    for p in phases:
        if tuple(p.shape) != shape or p.dtype != phases[0].dtype:
            raise ValueError("the 4 phases must share one shape and dtype")
    if u.dim() != 3 or u.shape[0] != 16 or u.shape[1] != c:
        raise ValueError(f"u must be (16, {c}, Co), got {tuple(u.shape)}")
    co = u.shape[2]
    if tuple(bias.shape) != (co,):
        raise ValueError(f"bias must be ({co},), got {tuple(bias.shape)}")
    for name, group in (("residual_phases", residual_phases), ("out", out)):
        if group is None:
            continue
        if len(group) != 4:
            raise ValueError(f"{name}: expected 4 phases, got {len(group)}")
        for p in group:
            if tuple(p.shape) != (b, hp, wp, co):
                raise ValueError(f"{name} must be (B, Hp, Wp, Co) = {(b, hp, wp, co)}, got {tuple(p.shape)}")


def winograd_conv3x3_phases_plain(
    phases: Sequence[torch.Tensor],
    u: torch.Tensor,
    bias: torch.Tensor,
    residual_phases: Optional[Sequence[torch.Tensor]] = None,
    relu: bool = True,
    out: Optional[Sequence[torch.Tensor]] = None,
) -> Phases:
    """Plain PyTorch version: 4 phases (B, Hp, Wp, C) -> 4 phases (B, Hp,
    Wp, Co) of ``relu(conv3x3(x) + bias + residual)``, zero padding.

    The TPU kernel's arithmetic: the input transform B^T d B in the phases'
    dtype (a bf16 input rounds after the row pass and after the column
    pass), the 16 products with ``u`` cast to that dtype and summed in
    fp32, the output transform, bias (fp32) and residual in fp32, one cast
    to the phases' dtype. ``out``, when given, receives the result.
    """
    _check(phases, u, bias, residual_phases, out)
    p00, p01, p10, p11 = phases
    dtype = p00.dtype
    b, hp, wp, c = p00.shape
    co = u.shape[2]
    zrow = p00.new_zeros((b, 1, wp, c))
    zcol = p00.new_zeros((b, hp, 1, c))

    # Row pass. Row tap k of tile row r: k=0 parity-1 row r-1, k=1 parity-0
    # row r, k=2 parity-1 row r, k=3 parity-0 row r+1 (zero outside).
    def rows(a0, a1):
        s0 = torch.cat([zrow, a1[:, :-1]], dim=1)
        s3 = torch.cat([a0[:, 1:], zrow], dim=1)
        return (s0 - a1, a0 + a1, a1 - a0, a0 - s3)

    # Column pass, the same taps along W; V[4i + j].
    v = []
    for t0, t1 in zip(rows(p00, p10), rows(p01, p11)):
        wl = torch.cat([zcol, t1[:, :, :-1]], dim=2)
        wr = torch.cat([t0[:, :, 1:], zcol], dim=2)
        v += [wl - t1, t0 + t1, t1 - t0, t0 - wr]
    m = torch.bmm(torch.stack(v).reshape(16, -1, c).float(), u.to(dtype).float())
    m = m.reshape(4, 4, -1, co)  # [i][j]
    # Output transform, A^T rows (m0 + m1 + m2, m1 - m2 - m3), along i then j.
    ys = []
    for r in (m[0] + m[1] + m[2], m[1] - m[2] - m[3]):
        ys += [r[0] + r[1] + r[2], r[1] - r[2] - r[3]]
    bias = bias.float()
    res = [None] * 4 if residual_phases is None else residual_phases
    result = []
    for k, y in enumerate(ys):
        y = y.reshape(b, hp, wp, co) + bias
        if res[k] is not None:
            y = y + res[k].float()
        if relu:
            y = torch.relu(y)
        result.append(y.to(dtype))
    if out is None:
        return tuple(result)
    for o, y in zip(out, result):
        o.copy_(y)
    return tuple(out)


def _strides(group, name: str) -> Tuple[int, int, int]:
    """The (batch, row, column) strides that the 4 phases of a group share;
    channels must be contiguous."""
    s = group[0].stride()
    for p in group:
        if p.stride() != s or s[3] != 1:
            raise ValueError(
                f"winograd kernel: the 4 {name} need channel stride 1 and one set of strides"
            )
    return s[0], s[1], s[2]


def winograd_conv3x3_phases(
    phases: Sequence[torch.Tensor],
    u: torch.Tensor,
    bias: torch.Tensor,
    residual_phases: Optional[Sequence[torch.Tensor]] = None,
    relu: bool = True,
    out: Optional[Sequence[torch.Tensor]] = None,
) -> Phases:
    """The winograd kernel on CUDA tensors, its plain version on CPU ones.

    Same contract as :func:`winograd_conv3x3_phases_plain`. On CUDA the
    phases are float32 (CUDA cores) or bfloat16 (tensor cores); the four
    tensors of each group (phases, residual, out) may be strided views, as
    ``space_to_phases`` gives, but share their strides and have contiguous
    channels. ``u`` is read as it is when it is contiguous in the phases'
    dtype (as ``ops/winograd.kept_u_slab`` keeps it), else cast on the way
    in; ``bias`` is read as it is when fp32 or (bf16 path) bf16, else cast
    to fp32. ``out`` must not overlap the inputs. Anything else raises.
    """
    p0 = phases[0]
    if p0.device.type == "cpu":
        return winograd_conv3x3_phases_plain(phases, u, bias, residual_phases, relu, out)
    if p0.device.type != "cuda":
        raise ValueError(f"winograd runs on cpu or cuda, not {p0.device}")
    _check(phases, u, bias, residual_phases, out)
    if p0.dtype not in _DTYPES:
        raise TypeError(f"winograd kernel takes float32 or bfloat16, not {p0.dtype}")
    groups = [("phases", phases)]
    if residual_phases is not None:
        groups.append(("residual_phases", residual_phases))
    if out is not None:
        groups.append(("out", out))
    for name, group in groups:
        for t in group:
            if t.device != p0.device or t.dtype != p0.dtype:
                raise TypeError(f"{name} must be {p0.dtype} on {p0.device}, got {t.dtype} on {t.device}")
    for name, t in (("u", u), ("bias", bias)):
        if t.device != p0.device:
            raise TypeError(f"{name} must be on {p0.device}, got {t.device}")
    b, hp, wp, c = p0.shape
    co = u.shape[2]
    uk = u.to(p0.dtype).contiguous()
    bias_bf16 = p0.dtype == torch.bfloat16 and bias.dtype == torch.bfloat16
    bk = bias.contiguous() if bias_bf16 else bias.float().contiguous()
    if out is None:
        out = tuple(torch.empty((b, hp, wp, co), dtype=p0.dtype, device=p0.device) for _ in range(4))
    if out[0].numel() == 0:
        return tuple(out)
    sx = _strides(phases, "phases")
    sy = _strides(out, "out")
    if residual_phases is None:
        rp, sr = (None,) * 4, (0, 0, 0)
    else:
        rp, sr = tuple(t.data_ptr() for t in residual_phases), _strides(residual_phases, "residual_phases")
    err = _build.lib().sde_winograd(
        *(t.data_ptr() for t in phases), *sx, *rp, *sr, uk.data_ptr(), bk.data_ptr(),
        *(t.data_ptr() for t in out), *sy, b, hp, wp, c, co, int(relu), int(bias_bf16),
        _DTYPES[p0.dtype], p0.device.index, _build.stream_of(p0),
    )
    _build.check(err, "winograd")
    _build.LAUNCHES["winograd"] += 1
    return tuple(out)
