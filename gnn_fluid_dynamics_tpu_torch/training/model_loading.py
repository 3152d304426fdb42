"""Model-state loading shims (counterpart of ``training/model_loading.py``;
reference ``src/utils/model_loading.py``):

* :func:`backward_compatibility` — legacy parameter names renamed to the
  current ones (reference model_loading.py:90-100), in a nested Flax tree
  or in a flat state dict's dotted keys;
* :func:`load_params_flexible` — a shape-tolerant restore into a module
  (reference ``load_model_state_dict_flexible``, model_loading.py:103-148):
  entries whose names and shapes match are copied, the others keep the
  module's fresh values and are reported by name.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, List

import torch

# legacy name -> current name (extend as checkpoint formats evolve)
LEGACY_RENAMES: Dict[str, str] = {
    "decoder": "decoder_face",
}


def backward_compatibility(tree: Mapping) -> Dict:
    """``tree`` with every legacy name renamed: the keys of a nested tree
    at every level, or each dot-separated part of a flat state dict's
    keys."""
    out = {}
    for key, value in tree.items():
        key = ".".join(LEGACY_RENAMES.get(p, p) for p in str(key).split("."))
        out[key] = (backward_compatibility(value)
                    if isinstance(value, Mapping) else value)
    return out


def load_params_flexible(module: torch.nn.Module,
                         state: Mapping) -> List[str]:
    """Copy into ``module`` every entry of the state dict ``state`` (legacy
    names renamed) whose name and shape match one of the module's; keep the
    module's value for the others. Returns what was not copied, one line
    per name: missing in the checkpoint, a shape mismatch, or unexpected in
    the checkpoint."""
    state = backward_compatibility(state)
    own = module.state_dict()
    merged, skipped = {}, []
    for name, value in own.items():
        src = state.get(name)
        if src is None:
            skipped.append(f"{name} (missing in checkpoint)")
        elif tuple(src.shape) != tuple(value.shape):
            skipped.append(f"{name} (shape {tuple(src.shape)} != "
                           f"{tuple(value.shape)})")
        else:
            merged[name] = src.to(value.dtype)
    skipped += [f"{name} (unexpected in checkpoint)"
                for name in sorted(set(state) - set(own))]
    module.load_state_dict(merged, strict=False)
    if skipped:
        print("load_params_flexible skipped:")
        for line in skipped[:20]:
            print("   ", line)
        if len(skipped) > 20:
            print(f"    ... and {len(skipped) - 20} more")
    return skipped
