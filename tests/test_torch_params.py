"""The port's WHIR parameter derivation against the JAX package's, exactly.

``WhirConfig`` fixes every round of a proof (folding factors, out-of-domain
samples, queries, proof-of-work bits, the domains and their generators) and
what the gnark export and the proof-size budget read from it.  For each
number of variables and folding factor, every security level, batch size,
rate and proof-of-work cap below must give the JAX package's configuration
field for field.  All host arithmetic: no kernel, no compile.
"""

import itertools

import pytest

from provekit_tpu.whir import parameters as JP
from provekit_tpu_torch.whir import parameters as P

NUM_VARIABLES = [1, 3, 9, 12, 16, 20, 24]
FOLDING = [1, 2, 4]
# (security level, batch size, starting log inverse rate, max pow bits)
INNER = list(itertools.product([3, 40, 128], [1, 2], [1, 2], [None, 2]))


def _fields(cfg) -> dict:
    out = {k: v for k, v in vars(cfg).items() if k != "rounds"}
    out["rounds"] = [vars(r) for r in cfg.rounds]
    return out


@pytest.mark.parametrize("folding_factor", FOLDING)
@pytest.mark.parametrize("num_variables", NUM_VARIABLES)
def test_whir_config_is_the_jax_config(num_variables, folding_factor):
    for sec, batch, rate, max_pow in INNER:
        kw = dict(num_variables=num_variables, batch_size=batch,
                  security_level=sec, max_pow_bits=max_pow,
                  starting_log_inv_rate=rate, folding_factor=folding_factor)
        got, want = P.WhirConfig(**kw), JP.WhirConfig(**kw)
        case = (sec, batch, rate, max_pow)
        assert _fields(got) == _fields(want), case
        assert got.describe() == want.describe(), case
        assert got.opening_budgets() == want.opening_budgets(), case
        assert got.commit_size() == want.commit_size(), case
        for n in (1, 1 << num_variables):
            assert got.proof_size_budget(n) == want.proof_size_budget(n), case
        for r in range(got.n_rounds + 1):
            assert (got.round_domain_generator(r)
                    == want.round_domain_generator(r)), (case, r)


def test_round_schedule_folds_every_variable():
    """The rounds fold all variables away: the initial fold, one fold a
    round, then the final sumcheck's rounds; each round's domain halves."""
    for nv, ff in itertools.product(NUM_VARIABLES, FOLDING):
        cfg = P.WhirConfig(num_variables=nv, folding_factor=ff)
        folded = cfg.initial_folding_factor + sum(
            r.folding_factor for r in cfg.rounds) + cfg.final_sumcheck_rounds
        assert folded == nv, (nv, ff)
        assert len(cfg.rounds) == cfg.n_rounds
        assert cfg.final_log_domain == cfg.starting_log_domain - cfg.n_rounds


def test_parameter_helpers_are_the_jax_helpers():
    for nv, rate in itertools.product(range(1, 30), range(1, 4)):
        assert P.default_max_pow(nv, rate) == JP.default_max_pow(nv, rate)
        for sec in (3, 40, 100, 128):
            assert (P.ood_samples(sec, nv, rate)
                    == JP.ood_samples(sec, nv, rate)), (sec, nv, rate)
    for sec, rate in itertools.product(range(0, 129, 7), range(1, 4)):
        assert P._queries(sec, rate) == JP._queries(sec, rate), (sec, rate)
