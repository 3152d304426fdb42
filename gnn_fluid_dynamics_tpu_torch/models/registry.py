"""Model registry: name -> FluidModel class (counterpart of
``models/registry.py``), every one of the JAX package's 38 names. A name not
in it raises ``KeyError``.
"""

from __future__ import annotations

from gnn_fluid_dynamics_tpu_torch.models.conservative import (
    ConservativeA, ConservativeB, ConservativeD, ConservativeE, ConservativeF,
    ConservativeG, ConservativeH, ConservativeI, ConservativeJ, ConservativeK)
from gnn_fluid_dynamics_tpu_torch.models.flux import FluxA, FluxB, FluxC, FluxD
from gnn_fluid_dynamics_tpu_torch.models.fvgn import (FvgnA, FvgnB, FvgnC,
                                                      FvgnD, FvgnE, FvgnF,
                                                      FvgnH, FvgnI, FvgnJ,
                                                      FvgnK)
from gnn_fluid_dynamics_tpu_torch.models.mgn import MgnA, MgnB, MgnC
from gnn_fluid_dynamics_tpu_torch.models.streamfunc import (StreamFuncA,
                                                            StreamFuncB,
                                                            StreamFuncC,
                                                            StreamFuncD)
from gnn_fluid_dynamics_tpu_torch.models.vertpot import (VertPotA, VertPotB,
                                                         VertPotC, VertPotD,
                                                         VertPotE, VertPotF,
                                                         VertPotG)

MODEL_REGISTRY = {cls.name: cls for cls in (
    FvgnA, FvgnB, FvgnC, FvgnD, FvgnE, FvgnF, FvgnH, FvgnI, FvgnJ, FvgnK,
    MgnA, MgnB, MgnC,
    FluxA, FluxB, FluxC, FluxD,
    ConservativeA, ConservativeB, ConservativeD, ConservativeE, ConservativeF,
    ConservativeG, ConservativeH, ConservativeI, ConservativeJ, ConservativeK,
    VertPotA, VertPotB, VertPotC, VertPotD, VertPotE, VertPotF, VertPotG,
    StreamFuncA, StreamFuncB, StreamFuncC, StreamFuncD)}


def get_model_class(name: str):
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{sorted(MODEL_REGISTRY)}") from None
