"""WHIR batch commitment: RS-encode, fold-ordered Merkle leaves, OOD samples.

Port of ``provekit_tpu/whir/committer.py`` (reference
``whir::whir::committer::CommitmentWriter::commit_batch``).

Leaf layout: the oracle over domain N (generator w) is stored so that leaf
``j`` holds the ``2^ff`` evaluations {f(w^(j + t*N/2^ff))}, i.e. exactly the
coset that folds to one point of the next domain; a batch of k polynomials
concatenates per-poly groups (k * 2^ff field elements per leaf).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fields import vector as V
from ..fs import device as D
from ..ops import merkle, ntt
from ..ops import sumcheck as sc
from ..utils.profiling import span
from .parameters import WhirConfig


def fold_leaves_view(enc: torch.Tensor, fold_size: int) -> torch.Tensor:
    """(16, N) encoding -> (16, fold_size, N/fold_size) leaf view."""
    n = enc.shape[1]
    return enc.reshape(16, fold_size, n // fold_size)


@dataclass
class ProverCommitment:
    config: WhirConfig
    polys: list                   # k original (16, 2^m) evaluation tensors
    combined: torch.Tensor        # (16, 2^m) gamma-combined evaluations
    encoding: torch.Tensor        # (16, k, N) per-poly RS encodings
    tree: merkle.MerkleTree
    ood_points: torch.Tensor      # (16, s) canonical device scalars
    ood_answers: torch.Tensor     # (16, s, k) Montgomery device scalars
    batching_randomness: torch.Tensor  # (16, 1) Montgomery device scalar


def commit_pattern(ds, config: WhirConfig, label: str = "") -> None:
    """Transcript shape of a (batch) commitment (commit_statement)."""
    ds.absorb(1, f"merkle_root{label}")
    if config.commitment_ood_samples:
        ds.squeeze(config.commitment_ood_samples, f"ood_query{label}")
        ds.absorb(config.commitment_ood_samples * config.batch_size,
                  f"ood_answers{label}")
    if config.batch_size > 1:
        ds.squeeze(1, f"batching_randomness{label}")


def commit(transcript, config: WhirConfig, polys: list) -> ProverCommitment:
    """Commit a batch of multilinear polys given by hypercube evaluations.

    Device-resident: the Merkle root is absorbed as a device scalar, OOD
    points are squeezed on the device, answers evaluated and absorbed there.
    """
    assert len(polys) == config.batch_size
    m = config.num_variables
    fold_size = 1 << config.initial_folding_factor
    dev = polys[0].device

    with span(f"rs_encode_m{m}"):
        encs = []
        for evals in polys:
            assert tuple(evals.shape) == (16, 1 << m)
            coeffs = ntt.coeffs_of_evals(evals)
            encs.append(ntt.rs_encode(coeffs, config.starting_log_domain))
        encoding = torch.stack(encs, dim=1)  # (16, k, N)

    n = encoding.shape[2]
    # leaf j element (i, t) = enc_i[j + t*N/fold]
    leaves = encoding.reshape(16, len(polys) * fold_size, n // fold_size)
    # Skyscraper hashes canonical values (reference whir.rs:20-26 into_bigint)
    with span(f"merkle_m{m}"):
        tree = merkle.commit_dev(V.from_mont(leaves))
    transcript.add_scalars_dev(merkle.root_dev(tree))

    s = config.commitment_ood_samples
    k = len(polys)
    if s:
        ood_points = transcript.challenge_scalars_dev(s)   # (16, s) canonical
        coords = D.univ_to_ml(D.to_mont(ood_points), m)    # (16, m, s)
        per_poly = [sc.eval_multilinear_batch_dev(ev, coords)
                    for ev in polys]                       # k x (16, s) mont
        ood_answers = torch.stack(per_poly, dim=2)         # (16, s, k)
        # absorb order: per point, per poly
        transcript.add_scalars_dev(
            D.from_mont(ood_answers.reshape(16, s * k)))
    else:
        ood_points = V.zeros((0,), dev)
        ood_answers = V.zeros((0, k), dev)

    if config.batch_size > 1:
        gamma = D.to_mont(transcript.challenge_scalars_dev(1))
    else:
        gamma = D.one_m(dev)

    combined = polys[0]
    g = gamma
    for ev in polys[1:]:
        combined = V.add_mod(combined, D.mul(g, ev))
        g = D.mul(g, gamma)

    return ProverCommitment(
        config=config, polys=polys, combined=combined, encoding=encoding,
        tree=tree, ood_points=ood_points, ood_answers=ood_answers,
        batching_randomness=gamma)
