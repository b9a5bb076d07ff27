"""WHIR statements: linear constraints sum_x w(x) f(x) = sigma.

Mirrors ``whir::whir::statement::{Statement, Weights}`` as used by the
reference (``provekit/prover/src/whir_r1cs.rs:382-412``): weights are dense
evaluation vectors (``Weights::linear``) or evaluation-point weights
(eq tensors).  ``eval_mle`` supports the verifier's deferred weight
evaluation at the final folding point.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fields import bn254 as F
from ..fields import vector as V
from ..ops import sumcheck as sc


def univariate_to_multilinear_point(z: int, m: int) -> list[int]:
    """Univariate-embedding point -> multilinear coords (MSB-first).

    Variable k corresponds to Y^(2^(m-1-k)), so coords are
    [z^(2^(m-1)), ..., z^2, z].
    """
    coords = [0] * m
    acc = z % F.P
    for k in range(m - 1, -1, -1):
        coords[k] = acc
        acc = acc * acc % F.P
    return coords


class Weights:
    """Base: a weight MLE over m variables."""

    num_variables: int

    def table(self) -> torch.Tensor:
        """Dense Montgomery evaluation table (16, 2^m)."""
        raise NotImplementedError

    def eval_mle(self, point: list[int]) -> int:
        """Evaluate the weight MLE at a point (MSB-first coords)."""
        raise NotImplementedError

    def weighted_sum(self, poly_evals: torch.Tensor) -> int:
        got = sc.weighted_sum(self.table(), poly_evals)
        return F.from_mont(V.unpack_scalar(got))


class DenseWeights(Weights):
    """Arbitrary dense weight vector (reference Weights::linear)."""

    def __init__(self, evals: torch.Tensor, num_variables: int):
        assert evals.shape == (16, 1 << num_variables)
        self._evals = evals
        self.num_variables = num_variables

    @classmethod
    def from_ints(cls, values: list[int], num_variables: int,
                  device) -> "DenseWeights":
        vals = list(values) + [0] * ((1 << num_variables) - len(values))
        return cls(V.pack([F.to_mont(v) for v in vals], device),
                   num_variables)

    def table(self) -> torch.Tensor:
        return self._evals

    def eval_mle(self, point: list[int]) -> int:
        assert len(point) == self.num_variables
        return sc.eval_multilinear(self._evals, point)


class EvaluationWeights(Weights):
    """Weight for an evaluation claim f(coords) = sigma: w = eq(coords, .)."""

    def __init__(self, coords: list[int], device):
        self.coords = [c % F.P for c in coords]
        self.num_variables = len(coords)
        self.device = device

    @classmethod
    def from_univariate(cls, z: int, m: int, device) -> "EvaluationWeights":
        return cls(univariate_to_multilinear_point(z, m), device)

    def table(self) -> torch.Tensor:
        return sc.eq_table(self.coords, self.device)

    def eval_mle(self, point: list[int]) -> int:
        return sc.eq_point(self.coords, point)


@dataclass
class Statement:
    num_variables: int
    constraints: list  # list[(Weights, int sigma)]

    def __init__(self, num_variables: int):
        self.num_variables = num_variables
        self.constraints = []

    def add_constraint(self, weights: Weights, sigma) -> None:
        """sigma: host int (verifier path) or (16,1) device scalar (the
        device-resident prover never reads sigmas: they are verifier-side)."""
        assert weights.num_variables == self.num_variables
        if isinstance(sigma, int):
            sigma %= F.P
        self.constraints.append((weights, sigma))

    def __len__(self) -> int:
        return len(self.constraints)
