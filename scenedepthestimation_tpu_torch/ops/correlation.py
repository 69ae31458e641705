"""1-D stereo correlation cost volume, the counterpart of
``scenedepthestimation_tpu/ops/correlation.py``.

``cost[b, h, w, d] = mean_c(F_L[b, h, w, c] * F_R[b, h, w - d, c])`` for d
in [0, D); out-of-frame right-view samples contribute zero. Layout:
features NHWC, cost volume (B, H, W, D) with D minor, which is also the
channels-last memory of (B, D, H, W): the aggregation's first conv reads
it with no transpose.
"""

from __future__ import annotations

import torch

from scenedepthestimation_tpu_torch.ops.cuda import correlation as _corr
from scenedepthestimation_tpu_torch.ops.cuda import correlation_gram as _gram


def correlation1d(
    f_left: torch.Tensor, f_right: torch.Tensor, max_disp: int
) -> torch.Tensor:
    """Build the (B, H, W, D) cost volume, D = max_disp, in the features'
    dtype. The dtype decides, as in the JAX package: bf16 features take
    the banded-Gram kernel (the JAX package's ``_correlation_gram``), any
    other the correlation kernel (its fp32 Pallas kernel). On the CPU each
    takes its plain version."""
    if f_left.dtype == torch.bfloat16:
        return _gram.correlation_gram(f_left, f_right, max_disp)
    return _corr.correlation(f_left, f_right, max_disp)
