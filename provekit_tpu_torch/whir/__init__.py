from .parameters import RoundConfig, WhirConfig
from .statement import (DenseWeights, EvaluationWeights, Statement, Weights,
                        univariate_to_multilinear_point)
from . import committer, fold, hints, prover, verifier

__all__ = [
    "RoundConfig", "WhirConfig", "DenseWeights", "EvaluationWeights",
    "Statement", "Weights", "univariate_to_multilinear_point",
    "committer", "fold", "hints", "prover", "verifier",
]
