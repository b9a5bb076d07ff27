"""A small R1CS and scheme for checks: the JAX package's test system.

``build_system`` is the JAX package's ``tests/test_e2e.py`` system (the
chain z_{i+1} = z_i * z_i + z_i) and ``tiny_scheme`` its
``tests/test_verifier_circuit.py`` scheme, on the port's classes.  The
smoke run, the sharded prover's dry run and its ranks build them.
"""

from __future__ import annotations

import random

from ..fields import bn254 as F
from ..r1cs import R1CS
from ..whir.parameters import WhirConfig
from .scheme import WhirR1CSScheme, next_power_of_two_log


def build_system(seed: int, n_mults: int):
    """(r1cs, witness) of ``n_mults`` steps z_{i+1} = z_i * z_i + z_i from
    a seeded z_0: two constraints a step."""
    rng = random.Random(seed)
    r = R1CS()
    x0 = r.new_witness()
    vals = {0: 1, x0: rng.randrange(F.P)}
    prev = x0
    for _ in range(n_mults):
        sq = r.new_witness()
        r.add_constraint([(1, prev)], [(1, prev)], [(1, sq)])
        vals[sq] = vals[prev] * vals[prev] % F.P
        nxt = r.new_witness()
        r.add_constraint([(1, sq), (1, prev)], [(1, 0)], [(1, nxt)])
        vals[nxt] = (vals[sq] + vals[prev]) % F.P
        prev = nxt
    return r, [vals[i] for i in range(r.num_witnesses)]


def tiny_scheme(r1cs, device, security=3, folding=2, max_pow=2):
    """The scheme of ``r1cs``'s shape at a low security level."""
    m = next_power_of_two_log(r1cs.num_witnesses) + 1
    m_0 = max(1, next_power_of_two_log(r1cs.num_constraints))
    bv = next_power_of_two_log(4 * m_0) + 1
    cfg = dict(batch_size=2, security_level=security, max_pow_bits=max_pow,
               folding_factor=folding)
    return WhirR1CSScheme(
        m=m, m_0=m_0, a_num_terms=next_power_of_two_log(max(1, r1cs.a.nnz)),
        whir_witness=WhirConfig(num_variables=m, **cfg),
        whir_for_hiding_spartan=WhirConfig(num_variables=bv, **cfg),
        security_level=security, max_pow_bits=max_pow, device=device)
