"""Weights into the port's ``state_dict``, from the JAX package or from the
reference family's ``.pth`` files.

* :func:`from_jax_variables`: the Flax tree ``{'params', 'batch_stats'}``
  (nested dicts of numpy arrays) -> the port's names. Conv kernels go
  HWIO -> OIHW; BatchNorm ``scale/bias/mean/var`` become
  ``weight/bias/running_mean/running_var``; ``layerN_B`` becomes
  ``layerN.B`` and ``downsample_conv/bn`` become ``downsample.0/1``; the
  decoder's ``upconv_i_j/conv`` and ``dispconv_s/conv`` keep their names,
  and so do the stereo tree's ``tower/*``, ``aggregation/*`` and
  ``refinement/*`` (which has no ``batch_stats``).
* :func:`load_path`: the JAX package's checkpoint forms
  (``scenedepthestimation_tpu/utils/checkpoint.py::load_variables``): a
  directory of ``.pth`` files (:func:`load_torch_dir`, the family's
  ``encoder.pth`` + ``depth.pth`` layout, as
  ``scenedepthestimation_tpu/utils/torch_export.py`` writes it and
  ``utils/torch_import.py`` reads it), or one ``.pth`` / ``.pt`` state-dict
  file (:func:`load_torch_file`). The encoder keys are already
  torchvision's; the decoder's ModuleList indices map to names through
  ``_MD2_DECODER_ORDER``; the stereo net's names pass through.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

# Copied from scenedepthestimation_tpu/utils/torch_import.py: importing
# that package loads JAX. The family's DepthDecoder serializes its convs
# through ``nn.ModuleList(list(self.convs.values()))`` in this order.
_MD2_DECODER_ORDER = tuple(
    f"upconv_{i}_{j}" for i in range(4, -1, -1) for j in (0, 1)
) + tuple(f"dispconv_{s}" for s in (0, 1, 2, 3))

_LEAF_NAMES = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _port_module_parts(parts) -> list:
    """Flax module names -> the port's (torchvision) module path."""
    out = []
    for p in parts:
        m = re.fullmatch(r"(layer\d+)_(\d+)", p)
        if m:
            out += [m.group(1), m.group(2)]
        elif p == "downsample_conv":
            out += ["downsample", "0"]
        elif p == "downsample_bn":
            out += ["downsample", "1"]
        else:
            out.append(p)
    return out


def _leaves(tree: Mapping[str, Any], prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy leaves) -> the port's ``state_dict`` (fp32)."""
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {}) or {}):
            leaf = path[-1]
            if leaf not in _LEAF_NAMES:
                raise ValueError(f"unhandled flax leaf {'/'.join(path)}")
            if leaf == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif leaf == "kernel" and arr.ndim == 2:
                arr = arr.transpose(1, 0)
            key = ".".join(_port_module_parts(path[:-1]) + [_LEAF_NAMES[leaf]])
            state[key] = torch.from_numpy(np.array(arr, np.float32))
    return state


def _strip_bookkeeping(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the non-tensor entries the reference family stores alongside
    weights inside ``encoder.pth`` ('height'/'width'/'use_stereo')."""
    return {
        k: v
        for k, v in state.items()
        if hasattr(v, "ndim") and not isinstance(v, (int, float, str, bool))
    }


def _canonical_key(key: str, nest: str = "") -> str:
    """One family key -> the port's key, under ``nest`` (encoder/decoder)
    when given."""
    parts = key.split(".")
    # DataParallel-saved checkpoints prefix every key with ``module.``.
    if parts and parts[0] == "module":
        parts = parts[1:]
    if (
        len(parts) > 1
        and parts[0] == "decoder"
        and parts[1].isdigit()
        and int(parts[1]) < len(_MD2_DECODER_ORDER)
    ):
        name = _MD2_DECODER_ORDER[int(parts[1])]
        rest = parts[2:]
        # The family's ConvBlock nests Conv3x3 (conv.conv); ours is one
        # module named ``conv``.
        if name.startswith("upconv") and rest[:2] == ["conv", "conv"]:
            rest = rest[1:]
        parts = [name] + rest
    # The family's ResnetEncoder wraps torchvision as ``self.encoder``, so
    # its keys may carry the nesting already.
    if nest and parts[:1] != [nest]:
        parts = [nest] + parts
    return ".".join(parts)


def load_torch_file(path: str, nest: str = "") -> Dict[str, torch.Tensor]:
    """One ``.pth`` state-dict file -> the port's keys in fp32 (under
    ``nest`` when given), without the family's bookkeeping entries and
    BatchNorm counters. With no nest it reads a file of the whole network,
    mono or stereo, as ``torch_import.load_torch_file`` does."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {
        _canonical_key(k, nest): v.float()
        for k, v in _strip_bookkeeping(raw).items()
        if not k.endswith("num_batches_tracked")
    }


# The pose pair of a joint depth + pose export: no part of inference.
_POSE_STEMS = ("pose_encoder", "pose", "pose_decoder")


def load_torch_dir(path: str) -> Dict[str, torch.Tensor]:
    """The family's per-network ``.pth`` directory -> the port's
    ``state_dict``, merged as ``torch_import.load_torch_dir`` merges it:
    ``encoder.pth`` nests under ``encoder``, ``depth.pth`` (or
    ``decoder.pth``) under ``decoder``, any other file (a stereo net's,
    whatever its name) at the root; the pose pair is skipped. A directory
    without a file to load raises; a mono directory without its encoder or
    decoder fails in :func:`load_state`.
    """
    nest_by_stem = {"encoder": "encoder", "depth": "decoder", "decoder": "decoder"}
    state: Dict[str, torch.Tensor] = {}
    for entry in sorted(os.listdir(path)):
        stem, ext = os.path.splitext(entry)
        if ext not in (".pth", ".pt") or stem in _POSE_STEMS:
            continue
        state.update(load_torch_file(os.path.join(path, entry), nest_by_stem.get(stem, "")))
    if not state:
        raise FileNotFoundError(
            f"{path}: no weights file (mono: encoder.pth and depth.pth; stereo: any .pth)"
        )
    return state


def load_path(path: str) -> Dict[str, torch.Tensor]:
    """Dispatch on the checkpoint's form, as the JAX package's
    ``checkpoint.load_variables`` does: a directory holding ``.pth`` or
    ``.pt`` files, or one such file. A directory without them is the JAX
    package's Orbax checkpoint, which the port cannot read (Orbax is a JAX
    library): it raises with the command that converts it."""
    if os.path.isdir(path):
        if any(e.endswith((".pth", ".pt")) for e in os.listdir(path)):
            return load_torch_dir(path)
        raise ValueError(
            f"{path!r} holds no .pth file: an Orbax checkpoint of the JAX package "
            f"loads in the port after `scenedepth export --weights {path} --torch OUT` "
            "writes it as .pth files to OUT"
        )
    if path.endswith((".pth", ".pt")):
        return load_torch_file(path)
    raise ValueError(f"unrecognized checkpoint path {path!r}")


def load_state(model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """``model.load_state_dict`` that tolerates only absent BatchNorm
    ``num_batches_tracked`` counters and raises on any other mismatch."""
    missing, unexpected = model.load_state_dict(dict(state), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(
            f"weights do not fit the model: missing {missing[:8]}, "
            f"unexpected {list(unexpected)[:8]}"
        )
