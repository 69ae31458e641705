"""The fused level-0 decoder tail and its switch, the counterpart of
``scenedepthestimation_tpu/ops/collapsed.py``'s ``set_use_fused_tail`` and
its dispatch in ``collapsed_mono_decoder``.

With the switch on, the mono decoder runs ``upconv_0_0`` -> nearest 2x ->
``upconv_0_1`` as one launch of the fused_tail kernel
(:func:`fused_tail`, from ``ops/cuda/fused_tail.py``, with its plain
version :func:`fused_tail_plain`). The JAX package's values are kept:
None and False leave it off, True and "v2" (its two TPU kernels) both
select the one Hopper kernel. The default is off, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Union

from scenedepthestimation_tpu_torch.ops.cuda.fused_tail import fused_tail, fused_tail_plain

__all__ = ["enabled", "fused_tail", "fused_tail_plain", "set_use_fused_tail"]

_USE_FUSED_TAIL: Optional[Union[bool, str]] = None


def set_use_fused_tail(flag: Optional[Union[bool, str]]) -> None:
    """None or False: the unfused chain; True or "v2": the fused kernel."""
    if flag not in (None, False, True, "v2"):
        raise ValueError(f"fused tail flag must be None, False, True or 'v2', not {flag!r}")
    global _USE_FUSED_TAIL
    _USE_FUSED_TAIL = flag


def enabled() -> bool:
    return bool(_USE_FUSED_TAIL)
