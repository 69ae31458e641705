"""The fused level-0 decoder tail and its switch, the counterpart of
``scenedepthestimation_tpu/ops/collapsed.py``'s ``set_use_fused_tail`` and
its dispatch in ``collapsed_mono_decoder``.

With the switch on, the mono decoder runs ``upconv_0_0`` -> nearest 2x ->
``upconv_0_1`` as one launch of the fused_tail kernel
(:func:`fused_tail`, from ``ops/cuda/fused_tail.py``, with its plain
version :func:`fused_tail_plain`; the bf16 kernel reads its weights as a
slab, :func:`arrange_tail_weights`, which the decoder keeps). The JAX
package's values are kept: None and False leave it off, True and "v2" (its
two TPU kernels) both select the one Hopper kernel. The default is off, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Union

from scenedepthestimation_tpu_torch.ops.cuda.fused_tail import (
    arrange_tail_weights,
    arrange_tail_weights_plain,
    fused_tail,
    fused_tail_plain,
)

__all__ = [
    "arrange_tail_weights",
    "arrange_tail_weights_plain",
    "enabled",
    "fused_tail",
    "fused_tail_plain",
    "jax_tiles_rows",
    "set_use_fused_tail",
]

_USE_FUSED_TAIL: Optional[Union[bool, str]] = None


def set_use_fused_tail(flag: Optional[Union[bool, str]]) -> None:
    """None or False: the unfused chain; True or "v2": the fused kernel."""
    if flag not in (None, False, True, "v2"):
        raise ValueError(f"fused tail flag must be None, False, True or 'v2', not {flag!r}")
    global _USE_FUSED_TAIL
    _USE_FUSED_TAIL = flag


def enabled() -> bool:
    return bool(_USE_FUSED_TAIL)


def jax_tiles_rows(h4: int) -> bool:
    """Whether the JAX package's fused tail finds a row tiling of its packed
    (H/4)-row input, and so runs: ``_pick_th`` of
    ``scenedepthestimation_tpu/ops/pallas/fused_tail.py`` and
    ``fused_tail_v2.py`` wants a tile of 16, 8, 4 or 2 rows that divides
    h4 at least twice. Their VMEM budget, which binds only beyond 5,000 px
    of width at the presets' channels, is not modelled. The port's kernel
    tiles any h4; only fast borders, where level 0's border differs
    between the routes, ask."""
    return any(h4 % th == 0 and h4 // th >= 2 for th in (16, 8, 4, 2))
