"""Groth16 over the in-tree R1CS type (BN254).

Port of ``provekit_tpu/recursion/groth16.py``.

The reference wraps its WHIR proof in Groth16 through gnark
(``recursive-verifier/app/circuit/common.go:15-177``: CCS build, setup,
prove, verify).  Here the SNARK engine itself is in-tree and operates
directly on :class:`provekit_tpu_torch.r1cs.R1CS` — any circuit the compiler
produces (including a verifier circuit) can be wrapped without an external
toolchain.

Host code: the QAP and the keys in Python ints, and every batch of curve
multiplications and every Fr NTT of setup and prove in the native engine
(``native/curve.cpp``, built at first use).  The engine has no silent
pure-Python fallback: a library that cannot be built or loaded raises, since
a wrap of millions of constraints would run for hours in Python.  The
pure-Python code (``G1.msm``, :func:`_ntt`) stays: ``verify``'s short
public-input MSM runs it, and the tests hold the engine against it.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..fields.bn254 import P as R  # Fr modulus (group order)
from ..native import curve as NC
from .curve import G1, G2, g1_generator, g2_generator
from .pairing import pairing_product_is_one

# Fr multiplicative generator and 2-adicity (r - 1 = 2^28 * odd)
_FR_GEN = 5
_TWO_ADICITY = 28


def _root_of_unity(log_n: int) -> int:
    assert log_n <= _TWO_ADICITY
    return pow(_FR_GEN, (R - 1) >> log_n, R)


def _ntt(vals: list[int], omega: int) -> list[int]:
    """Iterative radix-2 NTT over Fr, in natural order (host ints)."""
    n = len(vals)
    a = list(vals)
    # bit-reverse permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w_len = pow(omega, n // length, R)
        for start in range(0, n, length):
            w = 1
            half = length // 2
            for k in range(start, start + half):
                u, v = a[k], a[k + half] * w % R
                a[k] = (u + v) % R
                a[k + half] = (u - v) % R
                w = w * w_len % R
        length <<= 1
    return a


def _intt(vals: list[int], omega: int) -> list[int]:
    n = len(vals)
    inv_n = pow(n, R - 2, R)
    out = _ntt(vals, pow(omega, R - 2, R))
    return [v * inv_n % R for v in out]


def _batch_inverse(vals: list[int]) -> list[int]:
    """Montgomery batch inversion: one modular inverse for the whole list."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % R
    inv = pow(prefix[n], R - 2, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv % R
        inv = inv * vals[i] % R
    return out


@dataclass
class Groth16Keys:
    # proving key
    alpha1: tuple
    beta1: tuple
    beta2: tuple
    delta1: tuple
    delta2: tuple
    u1: list      # [u_i(tau)]_1 per wire
    v1: list      # [v_i(tau)]_1 per wire
    v2: list      # [v_i(tau)]_2 per wire
    kw1: list     # [(beta u_i + alpha v_i + w_i)/delta]_1, private wires
    zt1: list     # [tau^i t(tau)/delta]_1, i < n-1
    # verifying key
    gamma2: tuple
    ic1: list     # [(beta u_i + alpha v_i + w_i)/gamma]_1, public wires
    n_public: int  # statement length including the constant-1 wire
    # commitment extension (gnark-style, for in-circuit logUp lookups):
    # committed wires are moved from the delta group to the gamma group and
    # aggregated into a Pedersen commitment D carried by the proof; the
    # lookup challenges are derived by hashing D (wrap.py).  A proof of
    # knowledge (basis scaled by a secret eta) pins D to the committed span.
    committed: list | None = None   # sorted committed wire indices
    ck1: list | None = None         # [K_i/gamma]_1 per committed wire
    ck1_eta: list | None = None     # [eta K_i/gamma]_1 (PoK basis)
    eta2: tuple | None = None       # [eta]_2


@dataclass
class Groth16Proof:
    a: tuple  # G1
    b: tuple  # G2
    c: tuple  # G1
    d: tuple | None = None    # G1 Pedersen commitment over committed wires
    pok: tuple | None = None  # G1 knowledge proof for d


def _qap_evals_at_tau(r1cs, tau: int, n: int, omega: int):
    """u_i(tau), v_i(tau), w_i(tau) for every wire i.

    L_j(tau) = omega^j (tau^n - 1) / (n (tau - omega^j)); each sparse entry
    (row j, col i, val) contributes val * L_j(tau) to the wire polynomial.
    """
    m = r1cs.num_witnesses
    zt = (pow(tau, n, R) - 1) % R
    inv_n = pow(n, R - 2, R)
    wjs = [1] * n
    for j in range(1, n):
        wjs[j] = wjs[j - 1] * omega % R
    denoms = _batch_inverse([(tau - wj) % R for wj in wjs])
    lj = [wj * zt % R * d % R * inv_n % R for wj, d in zip(wjs, denoms)]
    u = [0] * m
    v = [0] * m
    w = [0] * m
    for mat, out in ((r1cs.a, u), (r1cs.b, v), (r1cs.c, w)):
        for row, col, val in mat.iter_entries():
            out[col] = (out[col] + val * lj[row]) % R
    return u, v, w


def setup(r1cs, rng=None, committed=None) -> Groth16Keys:
    """Circuit-specific trusted setup (toxic waste drawn locally).

    ``committed``: wire indices (all >= the public count) whose K elements
    move from the delta group into a gamma-scaled Pedersen basis; the proof
    then carries their aggregate D + a knowledge proof, and the verifier
    folds D into the public-input term.  Their kw1 slots are zeroed and
    skipped by the prover.
    """
    rng = rng or secrets.SystemRandom()
    tau = rng.randrange(1, R)
    alpha = rng.randrange(1, R)
    beta = rng.randrange(1, R)
    gamma = rng.randrange(1, R)
    delta = rng.randrange(1, R)

    n = max(2, 1 << (r1cs.num_constraints - 1).bit_length())
    omega = _root_of_unity(n.bit_length() - 1)
    u, v, w = _qap_evals_at_tau(r1cs, tau, n, omega)

    g1, g2 = g1_generator(), g2_generator()
    n_public = r1cs.num_public_inputs + 1  # + constant-1 wire
    inv_gamma = pow(gamma, R - 2, R)
    inv_delta = pow(delta, R - 2, R)

    k = [(beta * u[i] + alpha * v[i] + w[i]) % R
         for i in range(r1cs.num_witnesses)]
    ic1 = NC.g1_mul_base_batch(
        g1, [k[i] * inv_gamma % R for i in range(n_public)])

    committed = sorted(committed) if committed else None
    ck1 = ck1_eta = eta2 = None
    cset = set(committed or ())
    if committed:
        assert committed[0] >= n_public, "cannot commit public wires"
        eta = rng.randrange(1, R)
        ck_scalars = [k[i] * inv_gamma % R for i in committed]
        ck1 = NC.g1_mul_base_batch(g1, ck_scalars)
        ck1_eta = NC.g1_mul_base_batch(g1,
                                       [s * eta % R for s in ck_scalars])
        eta2 = G2.mul(g2, eta)
    kw1 = NC.g1_mul_base_batch(g1, [
        0 if i in cset else k[i] * inv_delta % R
        for i in range(n_public, r1cs.num_witnesses)])

    zt = (pow(tau, n, R) - 1) % R
    zts = []
    ti = 1
    for _ in range(n - 1):
        zts.append(ti * zt % R * inv_delta % R)
        ti = ti * tau % R
    zt1 = NC.g1_mul_base_batch(g1, zts)

    return Groth16Keys(
        alpha1=G1.mul(g1, alpha), beta1=G1.mul(g1, beta),
        beta2=G2.mul(g2, beta), delta1=G1.mul(g1, delta),
        delta2=G2.mul(g2, delta),
        u1=NC.g1_mul_base_batch(g1, u),
        v1=NC.g1_mul_base_batch(g1, v),
        v2=NC.g2_mul_base_batch(g2, v),
        kw1=kw1, zt1=zt1,
        gamma2=G2.mul(g2, gamma),
        ic1=ic1, n_public=n_public,
        committed=committed, ck1=ck1, ck1_eta=ck1_eta, eta2=eta2)


def _h_coeffs(r1cs, z: list[int], n: int, omega: int) -> list[int]:
    """Coefficients of h(X) = (u(X) v(X) - w(X)) / t(X), deg <= n-2.

    Domain evals of u/v/w are just Az/Bz/Cz rows; h is recovered from its
    values on the coset g*<omega> where t(g x) = g^n - 1 is constant.
    """
    def rows(mat):
        out = [0] * n
        for row, col, val in mat.iter_entries():
            out[row] = (out[row] + val * z[col]) % R
        return out

    az, bz, cz = rows(r1cs.a), rows(r1cs.b), rows(r1cs.c)
    ua = NC.fr_ntt(az, omega, invert=True)
    vb = NC.fr_ntt(bz, omega, invert=True)
    wc = NC.fr_ntt(cz, omega, invert=True)
    g = _FR_GEN
    # shift to coset: coeff_i *= g^i, then forward NTT
    def coset_evals(coeffs):
        gi = 1
        shifted = []
        for c in coeffs:
            shifted.append(c * gi % R)
            gi = gi * g % R
        return NC.fr_ntt(shifted, omega)

    ue, ve, we = coset_evals(ua), coset_evals(vb), coset_evals(wc)
    t_inv = pow((pow(g, n, R) - 1) % R, R - 2, R)
    he = [(ue[i] * ve[i] - we[i]) % R * t_inv % R for i in range(n)]
    hc = NC.fr_ntt(he, omega, invert=True)
    g_inv = pow(g, R - 2, R)
    gi = 1
    out = []
    for c in hc:
        out.append(c * gi % R)
        gi = gi * g_inv % R
    assert out[-1] == 0, "h has degree n-1: constraint system inconsistent"
    return out[:n - 1]


def prove(keys: Groth16Keys, r1cs, z: list[int], rng=None,
          d_pt=None) -> Groth16Proof:
    """z: full witness vector (canonical ints, z[0] == 1).

    ``d_pt``: optional precomputed commitment point (the wrapper already
    computed it to derive the lookup challenges; skips one large MSM)."""
    assert z[0] == 1, "witness vector must start with the constant 1"
    rng = rng or secrets.SystemRandom()
    r = rng.randrange(R)
    s = rng.randrange(R)
    g1 = g1_generator()

    n = max(2, 1 << (r1cs.num_constraints - 1).bit_length())
    omega = _root_of_unity(n.bit_length() - 1)
    h = _h_coeffs(r1cs, z, n, omega)

    nz = [(i, a) for i, a in enumerate(z) if a]
    a_pt = G1.add(keys.alpha1, NC.g1_msm([keys.u1[i] for i, _ in nz],
                                         [a for _, a in nz]))
    a_pt = G1.add(a_pt, G1.mul(keys.delta1, r))

    b2_pt = G2.add(keys.beta2, NC.g2_msm([keys.v2[i] for i, _ in nz],
                                         [a for _, a in nz]))
    b2_pt = G2.add(b2_pt, G2.mul(keys.delta2, s))
    b1_pt = G1.add(keys.beta1, NC.g1_msm([keys.v1[i] for i, _ in nz],
                                         [a for _, a in nz]))
    b1_pt = G1.add(b1_pt, G1.mul(keys.delta1, s))

    cset = set(keys.committed or ())
    priv = [(i, a) for i, a in nz if i >= keys.n_public and i not in cset]
    c_pt = NC.g1_msm([keys.kw1[i - keys.n_public] for i, _ in priv],
                     [a for _, a in priv])
    hnz = [(i, c) for i, c in enumerate(h) if c]
    c_pt = G1.add(c_pt, NC.g1_msm([keys.zt1[i] for i, _ in hnz],
                                   [c for _, c in hnz]))
    c_pt = G1.add(c_pt, G1.mul(a_pt, s))
    c_pt = G1.add(c_pt, G1.mul(b1_pt, r))
    c_pt = G1.add(c_pt, G1.neg(G1.mul(keys.delta1, r * s % R)))

    pok_pt = None
    if keys.committed:
        cz = [z[i] for i in keys.committed]
        if d_pt is None:
            d_pt = commit(keys, cz)
        pok_pt = NC.g1_msm(keys.ck1_eta, cz)
    else:
        d_pt = None
    return Groth16Proof(a=a_pt, b=b2_pt, c=c_pt, d=d_pt, pok=pok_pt)


def commit(keys: Groth16Keys, committed_values: list[int]):
    """Pedersen commitment D over the committed wires' values (in the order
    of ``keys.committed``).  Exposed so the wrapper can derive the lookup
    challenges from D before solving the challenge-dependent wires."""
    return NC.g1_msm(keys.ck1, [v % R for v in committed_values])


def verify(keys: Groth16Keys, proof: Groth16Proof,
           public_inputs: list[int]) -> bool:
    """public_inputs: z[1..n_public-1] (the constant-1 wire is implicit)."""
    stmt = [1] + [x % R for x in public_inputs]
    if len(stmt) != keys.n_public:
        raise ValueError(
            f"{len(stmt) - 1} public inputs, expected {keys.n_public - 1}")
    vk_x = G1.msm(keys.ic1, stmt)
    if keys.committed:
        if proof.d is None or proof.pok is None:
            return False
        # knowledge proof: D really is a combination of the committed basis
        # (e(D, [eta]_2) == e(pok, [1]_2))
        if not pairing_product_is_one([
                (proof.d, keys.eta2),
                (G1.neg(proof.pok), g2_generator()),
        ]):
            return False
        vk_x = G1.add(vk_x, proof.d)
    # e(A, B) = e(alpha, beta) e(vk_x, gamma) e(C, delta)
    return pairing_product_is_one([
        (G1.neg(proof.a), proof.b),
        (keys.alpha1, keys.beta2),
        (vk_x, keys.gamma2),
        (proof.c, keys.delta2),
    ])
