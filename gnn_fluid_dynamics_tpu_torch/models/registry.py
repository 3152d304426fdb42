"""Model registry: name -> FluidModel class (counterpart of
``models/registry.py``).

``MODEL_REGISTRY`` holds the classes ported so far; ``JAX_MODEL_NAMES`` lists
every name the JAX package registers, so that asking for one not yet ported
says so instead of calling it unknown.
"""

from __future__ import annotations

from gnn_fluid_dynamics_tpu_torch.models.flux import FluxA, FluxD
from gnn_fluid_dynamics_tpu_torch.models.fvgn import FvgnA, FvgnF
from gnn_fluid_dynamics_tpu_torch.models.mgn import MgnA, MgnB, MgnC

JAX_MODEL_NAMES = (
    "FvgnA", "FvgnB", "FvgnC", "FvgnD", "FvgnE", "FvgnF", "FvgnH", "FvgnI",
    "FvgnJ", "FvgnK",
    "MgnA", "MgnB", "MgnC",
    "FluxA", "FluxB", "FluxC", "FluxD",
    "ConservativeA", "ConservativeB", "ConservativeD", "ConservativeE",
    "ConservativeF", "ConservativeG", "ConservativeH", "ConservativeI",
    "ConservativeJ", "ConservativeK",
    "VertPotA", "VertPotB", "VertPotC", "VertPotD", "VertPotE", "VertPotF",
    "VertPotG",
    "StreamFuncA", "StreamFuncB", "StreamFuncC", "StreamFuncD",
)

MODEL_REGISTRY = {cls.name: cls for cls in (FvgnA, FvgnF, MgnA, MgnB, MgnC,
                                             FluxA, FluxD)}


def get_model_class(name: str):
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        if name in JAX_MODEL_NAMES:
            raise KeyError(f"model {name!r} is not ported yet; ported: "
                           f"{sorted(MODEL_REGISTRY)}") from None
        raise KeyError(f"unknown model {name!r}; ported: "
                       f"{sorted(MODEL_REGISTRY)}") from None
