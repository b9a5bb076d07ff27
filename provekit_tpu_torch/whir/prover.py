"""WHIR opening prover: initial sumcheck, folding rounds, STIR queries, final.

Port of ``provekit_tpu/whir/prover.py`` (reference
``whir::whir::prover::Prover::prove``).  Device-resident: challenges,
sumcheck messages, PoW nonces, STIR indices and combination weights stay on
the device (see ``fs.device``); the host sequences the work and assembles
the transcript bytes from one final fetch.  STIR index dedup is a sort +
unique mask + rank on the device that reproduces the verifier's
``sorted(set(indices))`` and consecutive-powers semantics exactly.  The
sumcheck rounds (``_sumcheck_rounds``) take the reference's hybrid: large
leading rounds one at a time, the tail as one fused segment.
"""

from __future__ import annotations

import torch

from ..fields import bn254 as F
from ..fields import vector as V
from ..fs import device as D
from ..ops import fused, merkle, ntt
from ..ops import pow as pow_mod
from ..ops import sumcheck as sc
from ..utils.profiling import span
from .committer import ProverCommitment, fold_leaves_view
from .parameters import WhirConfig
from .statement import Statement


def proof_pattern(ds, config: WhirConfig, label: str = "") -> None:
    """Transcript shape of a WHIR opening proof (add_whir_proof).

    Hint labels/placement follow the Go verifier's parse surface
    (common.go:44-63) and are VERIFIED against the reference's own Rust
    proof bytes (tooling/provekit-bench/benches/poseidon-1000.np, walked
    structurally by tests/test_reference_transcript.py): per opening the
    hints are "stir_answers" THEN "merkle_proof"; grinding nonces are
    8 wire bytes under the spongefish-pow "pow-nonce" label."""
    ds.squeeze(1, f"initial_combination_randomness{label}")
    for _ in range(config.initial_folding_factor):
        ds.absorb(3, "sumcheck_poly").squeeze(1, "folding_randomness")
    for rc in config.rounds:
        ds.absorb(1, "merkle_root")
        if rc.ood_samples:
            ds.squeeze(rc.ood_samples, "ood_query")
            ds.absorb(rc.ood_samples, "ood_answers")
        if rc.pow_bits > 0:
            ds.squeeze(1, "pow_challenge").absorb(8, "pow-nonce")
        ds.squeeze(rc.num_queries, "stir_queries")
        ds.hint("stir_answers")
        ds.hint("merkle_proof")
        ds.squeeze(1, "combination_randomness")
        for _ in range(rc.folding_factor):
            ds.absorb(3, "sumcheck_poly").squeeze(1, "folding_randomness")
    ds.absorb(1 << config.final_sumcheck_rounds, "final_coefficients")
    if config.final_pow_bits > 0:
        ds.squeeze(1, "pow_challenge").absorb(8, "pow-nonce")
    ds.squeeze(config.final_queries, "final_queries")
    ds.hint("stir_answers")
    ds.hint("merkle_proof")
    for _ in range(config.final_sumcheck_rounds):
        ds.absorb(3, "sumcheck_poly").squeeze(1, "folding_randomness")
    if config.final_folding_pow_bits > 0:
        ds.squeeze(1, "pow_challenge").absorb(8, "pow-nonce")
    ds.hint("deferred_weight_evaluations")


def _scalars_of_block(block, rows: int, cols: int) -> list[list[int]]:
    """numpy (16, rows*cols) limb planes -> rows x cols Python ints."""
    import numpy as np
    arr = np.asarray(block, dtype=np.uint64).reshape(16, rows, cols)
    vals = np.zeros((rows, cols), dtype=object)
    for l in range(16):
        vals = vals + (arr[l].astype(object) << (16 * l))
    return [[int(v) for v in row] for row in vals]


def _multipath_builder(depth: int):
    """merkle_proof hint: ark MultiPath<Digest> (see whir/hints.py).

    Serialized straight from the numpy limb block — scalars become 32-byte
    LE slices of one vectorized ``astype('<u2').tobytes()`` blob instead of
    per-element Python bigints (the bigint path cost seconds per prove at
    reference query counts)."""

    def build(idx_sorted, path_block):
        import numpy as np
        from .hints import _vec_header
        q = len(idx_sorted)
        keep = np.ones(q, dtype=bool)
        keep[1:] = idx_sorted[1:] != idx_sorted[:-1]
        idx = [int(i) for i in idx_sorted[keep]]
        n = len(idx)
        pb = np.asarray(path_block).reshape(16, depth, q)[:, :, keep]
        # node (d, j) -> blob[(d*n + j)*32 : ...]; row 0 = leaf sibling,
        # rows 1.. internal bottom-up
        blob = np.ascontiguousarray(
            pb.transpose(1, 2, 0)).astype("<u2").tobytes()

        out = bytearray()
        out += _vec_header(n)
        out += blob[:n * 32]                     # leaf siblings, j ascending

        rows = list(range(depth - 1, 0, -1))     # top-down internal rows
        shared = np.zeros(max(0, n - 1), dtype=np.int64)
        if n > 1 and rows:
            eq = (pb[:, :, 1:] == pb[:, :, :-1]).all(axis=0)  # (depth, n-1)
            run = np.cumprod(eq[rows, :], axis=0)             # (len, n-1)
            shared = run.sum(axis=0).astype(np.int64)         # per j>=1
        out += _vec_header(n)
        for j in range(n):
            s = 0 if j == 0 else int(shared[j - 1])
            out += s.to_bytes(8, "little")
        out += _vec_header(n)
        for j in range(n):
            s = 0 if j == 0 else int(shared[j - 1])
            sfx = rows[s:]
            out += _vec_header(len(sfx))
            for d in sfx:
                off = (d * n + j) * 32
                out += blob[off:off + 32]
        out += _vec_header(n)
        for i in idx:
            out += i.to_bytes(8, "little")
        return bytes(out)

    return build


def _answers_builder(leaf_elems: int):
    """stir_answers hint: ark Vec<Vec<Fp256>> (numpy-vectorized bytes)."""

    def build(idx_sorted, leaf_block):
        import numpy as np
        from .hints import _vec_header
        q = len(idx_sorted)
        keep = np.ones(q, dtype=bool)
        keep[1:] = idx_sorted[1:] != idx_sorted[:-1]
        leaf = np.asarray(leaf_block).reshape(16, q, leaf_elems)[:, keep, :]
        n = int(keep.sum())
        # scalar (j, i) -> blob[(j*leaf_elems + i)*32 : ...]
        blob = np.ascontiguousarray(
            leaf.transpose(1, 2, 0)).astype("<u2").tobytes()
        row = leaf_elems * 32
        hdr = _vec_header(leaf_elems)
        out = bytearray(_vec_header(n))
        for j in range(n):
            out += hdr
            out += blob[j * row:(j + 1) * row]
        return bytes(out)

    return build


def _deferred_builder():
    def build(block):
        import numpy as np
        from .hints import serialize_scalar_vec
        arr = np.asarray(block)
        k = arr.shape[1]
        return serialize_scalar_vec(_scalars_of_block(arr, 1, k)[0])

    return build


def _open_oracle_dev(transcript, encoding: torch.Tensor,
                     tree: merkle.MerkleTree, idx_sorted: torch.Tensor,
                     fold_size: int) -> None:
    """Gather leaf values + auth paths on the device; defer serialization.

    Emits the reference's two hints per opening: ``stir_answers`` (leaf
    field elements) then ``merkle_proof`` (MultiPath)."""
    k = encoding.shape[1]
    leaf_block = _leaf_gather(encoding, idx_sorted, fold_size)
    path_block = merkle.open_gather_dev(tree, idx_sorted)
    transcript.hint_arrays(_answers_builder(k * fold_size),
                           [idx_sorted, leaf_block])
    transcript.hint_arrays(_multipath_builder(tree.depth),
                           [idx_sorted, path_block])


def _leaf_gather(encoding: torch.Tensor, idx_sorted: torch.Tensor,
                 fold_size: int) -> torch.Tensor:
    """Opened-leaf field elements (canonical), (16, q * k * fold_size)."""
    k = encoding.shape[1]
    n = encoding.shape[2]
    per_leaf = n // fold_size
    dev = encoding.device
    # leaf element (i, t) of leaf idx = enc_i[idx + t*per_leaf]
    ar = torch.arange(k * fold_size, dtype=torch.int64, device=dev)
    offs = (ar % fold_size) * per_leaf
    poly = (ar // fold_size) * n
    flat_idx = (poly[None, :] + offs[None, :]
                + idx_sorted[:, None]).reshape(-1)
    return V.from_mont(encoding.reshape(16, -1)[:, flat_idx])


def _send_pow_dev(transcript, bits: float) -> None:
    ch = transcript.challenge_scalars_dev(1)
    transcript.add_pow_nonce_dev(pow_mod.solve_dev(ch, bits))


def _sumcheck_rounds(transcript, fw: torch.Tensor, count: int):
    """``count`` WHIR sumcheck rounds: the leading rounds on arrays longer
    than ``fused.FUSE_MAX`` one at a time, then the rest as one fused
    segment.  Returns (folded fw, alphas (16, count) canonical)."""
    assert count == 0 or transcript.absorb_pos == 0, \
        "rounds must start after a squeeze"
    lead = fused.lead_rounds(fw.shape[2], count)
    alphas = []
    for run, k in ((fused.whir_rounds, lead),
                   (fused.whir_sumcheck_segment, count - lead)):
        if k:
            fw, state2, msgs, a = run(fw, transcript.state, k)
            transcript.replay_fused(state2, list(msgs.unbind(1)),
                                    [("A", 3), ("S", 1)] * k)
            alphas.append(a)
    if not alphas:
        return fw, V.zeros((0,), fw.device)
    return fw, torch.cat(alphas, dim=1)


def _stir_ranks(qs_canon: torch.Tensor, folded_domain: int):
    """Sorted indices, uniqueness mask, dedup rank for device STIR queries."""
    idx = D.scalar_index_u32(qs_canon, folded_domain - 1)
    idx_sorted, _ = torch.sort(idx)
    uniq = torch.ones_like(idx_sorted, dtype=torch.bool)
    uniq[1:] = idx_sorted[1:] != idx_sorted[:-1]
    rank = torch.cumsum(uniq.to(torch.int64), dim=0) - 1
    return idx_sorted, uniq, rank


def prove(transcript, config: WhirConfig, commitment: ProverCommitment,
          statement: Statement) -> None:
    m = config.num_variables
    iff = config.initial_folding_factor
    fold_size = 1 << iff
    dev = commitment.combined.device

    # --- initial weight combination ----------------------------------------
    # (the running sumcheck CLAIM is verifier-side only; the prover's round
    # coefficients never depend on it, so it is not computed here)
    chat = D.to_mont(transcript.challenge_scalars_dev(1))
    n_ood = commitment.ood_points.shape[1]
    n_cons = len(statement.constraints)
    pw = D.powers(chat, max(1, n_ood + n_cons))

    if n_ood:
        ood_coords = D.univ_to_ml(D.to_mont(commitment.ood_points), m)
        w = sc.combine_eq_weights_dev(ood_coords, pw[:, :n_ood], m)
    else:
        w = V.zeros((1 << m,), dev)
    for j, (wt, _) in enumerate(statement.constraints):
        w = V.add_mod(w, D.mul(pw[:, n_ood + j:n_ood + j + 1], wt.table()))

    fw = torch.stack([commitment.combined, w], dim=1)  # (16, 2, 2^m)

    all_alphas = []  # (16, k) canonical chunks, in draw order

    with span("initial_sumcheck"):
        fw, alphas = _sumcheck_rounds(transcript, fw, iff)
        all_alphas.append(alphas)

    prev_encoding = commitment.encoding
    prev_tree = commitment.tree
    prev_log_domain = config.starting_log_domain
    prev_fold_size = fold_size

    for r, rc in enumerate(config.rounds):
        # commit f^(r+1)
        with span(f"round{r}_commit"):
            f = fw[:, 0]
            log_dom = config.starting_log_domain - (r + 1)
            coeffs_arr = ntt.coeffs_of_evals(f)
            enc = ntt.rs_encode(coeffs_arr, log_dom)
            rfold = 1 << rc.folding_factor
            leaves = fold_leaves_view(enc, rfold)
            tree = merkle.commit_dev(V.from_mont(leaves))
            transcript.add_scalars_dev(merkle.root_dev(tree))

        m_cur = m - iff - rc.folding_factor * r
        coords_blocks, coeff_blocks = [], []
        if rc.ood_samples:
            oods_c = transcript.challenge_scalars_dev(rc.ood_samples)
            oc = D.univ_to_ml(D.to_mont(oods_c), m_cur)
            answers = sc.eval_multilinear_batch_dev(f, oc)
            transcript.add_scalars_dev(D.from_mont(answers))
            coords_blocks.append(oc)

        if rc.pow_bits > 0:
            with span(f"round{r}_pow"):
                _send_pow_dev(transcript, rc.pow_bits)

        folded_domain = (1 << prev_log_domain) // prev_fold_size
        qs = transcript.challenge_scalars_dev(rc.num_queries)
        idx_sorted, uniq, rank = _stir_ranks(qs, folded_domain)
        with span(f"round{r}_open"):
            _open_oracle_dev(transcript, prev_encoding, prev_tree,
                             idx_sorted, prev_fold_size)

        # stir points: omega_prev^(prev_fold_size * idx), folding to f^(r+1)
        omega_prev = F.root_of_unity(prev_log_domain)
        stir_pts = D.pow_base(omega_prev, idx_sorted * prev_fold_size,
                              prev_log_domain)
        coords_blocks.append(D.univ_to_ml(stir_pts, m_cur))

        chat_r = D.to_mont(transcript.challenge_scalars_dev(1))
        pwr = D.powers(chat_r, rc.ood_samples + rc.num_queries)
        stir_c = pwr[:, rc.ood_samples + rank]
        stir_c = torch.where(uniq[None, :], stir_c, 0)
        coeff_blocks = [pwr[:, :rc.ood_samples], stir_c]

        with span(f"round{r}_weights"):
            coords_all = torch.cat(coords_blocks, dim=2)
            coeffs_all = torch.cat(coeff_blocks, dim=1)
            w_add = sc.combine_eq_weights_dev(coords_all, coeffs_all, m_cur)
            fw = torch.stack([fw[:, 0], V.add_mod(fw[:, 1], w_add)], dim=1)

        with span(f"round{r}_sumcheck"):
            fw, alphas = _sumcheck_rounds(transcript, fw, rc.folding_factor)
            all_alphas.append(alphas)

        prev_encoding = enc.reshape(16, 1, 1 << log_dom)
        prev_tree = tree
        prev_log_domain = log_dom
        prev_fold_size = rfold

    # --- final phase ------------------------------------------------------
    final_coeffs_arr = ntt.coeffs_of_evals(fw[:, 0])
    transcript.add_scalars_dev(D.from_mont(final_coeffs_arr))

    if config.final_pow_bits > 0:
        _send_pow_dev(transcript, config.final_pow_bits)

    folded_domain = (1 << prev_log_domain) // prev_fold_size
    qs = transcript.challenge_scalars_dev(config.final_queries)
    idx_sorted, _, _ = _stir_ranks(qs, folded_domain)
    _open_oracle_dev(transcript, prev_encoding, prev_tree, idx_sorted,
                     prev_fold_size)

    fw, alphas = _sumcheck_rounds(transcript, fw,
                                  config.final_sumcheck_rounds)
    all_alphas.append(alphas)

    if config.final_folding_pow_bits > 0:
        _send_pow_dev(transcript, config.final_folding_pow_bits)

    # deferred weight evaluations: each statement weight's MLE at the full
    # folding point (the verifier re-derives and CHECKS them)
    binders = torch.cat(all_alphas, dim=1)              # (16, m) canonical
    point = D.to_mont(binders.flip(1))                  # MSB-first coords
    coords = point.reshape(16, m, 1)
    evs = [sc.eval_multilinear_batch_dev(wt.table(), coords)
           for wt, _ in statement.constraints]
    evs_c = D.from_mont(torch.cat(evs, dim=1))
    transcript.hint_arrays(_deferred_builder(), [evs_c])
