"""The port's tensor-core Montgomery experiment against the JAX package's.

``mont_mul_mma_plain`` (what the kernel wrapper runs on the CPU) is held,
exactly, to ``mont_mul_mxu_f32`` of ``scripts/mxu_mont_experiment.py``
(imported by path), to ``mont_mul_plain`` and to the field formula; the
band matrices equal the script's.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from provekit_tpu_torch import convert
from provekit_tpu_torch.experiments import mxu_mont as M
from provekit_tpu_torch.fields import bn254 as F
from provekit_tpu_torch.fields import vector as V

# The suite runs in parallel workers: the port's small CPU limb ops only
# lose to intra-op threads competing for the same cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / \
    "mxu_mont_experiment.py"


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("mxu_mont_experiment",
                                                  SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(1)
    a_vals, b_vals = M.random_values(rng, 256), M.random_values(rng, 256)
    # edge values: 0, 1, P - 1 and R against P - 1
    a_vals[:4] = [0, 1, F.P - 1, F.R % F.P]
    b_vals[:4] = [F.P - 1] * 4
    return a_vals, b_vals


def test_band_matrices_match_script(script):
    assert np.array_equal(M.BAND_NP, np.asarray(script.BT_NP_F32))
    assert np.array_equal(M.BAND_P, np.asarray(script.BT_P_F32))


def test_plain_matches_script_and_formula(script, operands):
    a_vals, b_vals = operands
    a, b = V.pack(a_vals, CPU), V.pack(b_vals, CPU)
    got = M.mont_mul_mma_plain(a, b)
    want = script.mont_mul_mxu_f32(jnp.asarray(convert.planes_to_numpy(a)),
                                   jnp.asarray(convert.planes_to_numpy(b)))
    assert np.array_equal(convert.planes_to_numpy(got), np.asarray(want))
    assert torch.equal(got, V.mont_mul_plain(a, b))
    assert M.check(got, a_vals, b_vals)


def test_wrapper_takes_plain_on_cpu(operands):
    a_vals, b_vals = operands
    a, b = V.pack(a_vals, CPU), V.pack(b_vals, CPU)
    before = M.mont_mul_mma.launches
    assert torch.equal(M.mont_mul_mma(a, b), M.mont_mul_mma_plain(a, b))
    assert M.mont_mul_mma.launches == before


def test_experiment_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        M.run(CPU)
