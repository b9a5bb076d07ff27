"""Hand state between the JAX package and the torch port.

Works on numpy arrays, ints and plain constructor fields, so it imports
neither package's JAX code; the tests use it to give both packages the same
field elements, circuit and parameters.

* limb planes: the JAX package's ``(16, n)`` ``uint32`` arrays of 16-bit
  digits <-> the port's ``int32`` tensors (the same bits);
* an R1CS as COO triplets ``(row, col, coeff)`` plus its sizes;
* a ``WhirConfig`` / ``WhirR1CSScheme`` as its constructor fields.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields import vector as V
from .protocol.scheme import WhirR1CSScheme
from .r1cs import R1CS
from .whir.parameters import WhirConfig

WHIR_CONFIG_FIELDS = ("num_variables", "batch_size", "security_level",
                      "max_pow_bits", "starting_log_inv_rate",
                      "folding_factor")
SCHEME_FIELDS = ("m", "m_0", "a_num_terms", "security_level", "max_pow_bits")


def planes_to_torch(arr: np.ndarray, device) -> torch.Tensor:
    """(16, ...) uint32 digit planes -> int32 tensor on ``device``."""
    return V.from_numpy_u32(arr, device)


def planes_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 digit-plane tensor -> (16, ...) numpy uint32 planes."""
    return V.to_numpy_u32(t)


def r1cs_to_coo(r1cs) -> dict:
    """COO triplets and sizes of an R1CS of either package."""
    return {
        "a": list(r1cs.a.iter_entries()),
        "b": list(r1cs.b.iter_entries()),
        "c": list(r1cs.c.iter_entries()),
        "num_constraints": r1cs.num_constraints,
        "num_witnesses": r1cs.num_witnesses,
    }


def r1cs_from_coo(coo: dict) -> R1CS:
    """The port's R1CS from :func:`r1cs_to_coo` output."""
    r = R1CS()
    r.new_witnesses(coo["num_witnesses"] - r.num_witnesses)
    for mat, key in ((r.a, "a"), (r.b, "b"), (r.c, "c")):
        for row, col, coeff in coo[key]:
            mat.set(row, col, coeff)
        mat.grow(coo["num_constraints"], coo["num_witnesses"])
    return r


def whir_config_fields(cfg) -> dict:
    """Constructor fields of a WhirConfig of either package."""
    return {k: getattr(cfg, k) for k in WHIR_CONFIG_FIELDS}


def whir_config_from_fields(fields: dict) -> WhirConfig:
    return WhirConfig(**fields)


def scheme_fields(scheme) -> dict:
    """Constructor fields of a WhirR1CSScheme of either package."""
    out = {k: getattr(scheme, k) for k in SCHEME_FIELDS}
    out["whir_witness"] = whir_config_fields(scheme.whir_witness)
    out["whir_for_hiding_spartan"] = whir_config_fields(
        scheme.whir_for_hiding_spartan)
    return out


def scheme_from_fields(fields: dict, device) -> WhirR1CSScheme:
    """The port's WhirR1CSScheme, on ``device``, from :func:`scheme_fields`."""
    kw = dict(fields)
    kw["whir_witness"] = whir_config_from_fields(kw["whir_witness"])
    kw["whir_for_hiding_spartan"] = whir_config_from_fields(
        kw["whir_for_hiding_spartan"])
    return WhirR1CSScheme(**kw, device=torch.device(device))
