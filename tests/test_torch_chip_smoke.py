"""The smoke run's bound arithmetic (chip_smoke.py), pinned on the CPU.

A kernel's bound is the larger of its bytes over the HBM rate and its
operations over the card's peak: 32-bit integer multiply-adds at 132 SMs x
64 a clock x the maximum SM clock, two for each 32 x 32 -> 64-bit limb
product and one for each reduction factor (low word only).
"""

import pytest

import chip_smoke as C


def test_peak_rates_at_the_h100_clock():
    rates = C.peak_rates(1980)
    assert rates["int32_muladd"] == 132 * 64 * 1980e6
    assert rates["int8_tensor"] == 1979e12


def test_multiply_adds_of_a_square_and_a_product():
    # square: 36 + 64 full limb products and 8 low-only factors; CIOS
    # product: 64 + 64 and 8
    assert C.MONT_SQR_MULADDS == 208
    assert C.MONT_MUL_MULADDS == 264
    assert C.ladder_ops(3) == {"int32_muladd": 3 * 14 * 208}
    assert C.mont_mul_ops(5) == {"int32_muladd": 5 * 264}


def test_bound_of_compress_at_2_20_is_operations():
    # 2^20 compressions: 14 squares of 208 multiply-adds each, against 192
    # bytes an element
    ms, by = C.bound(3 * 64 * 2**20, C.ladder_ops(2**20), C.peak_rates(1980))
    assert by == "operations"
    assert ms == pytest.approx(2**20 * 14 * 208 / (132 * 64 * 1.98e9)
                               * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.18255, abs=1e-5)


def test_bound_of_mont_mul_at_2_21_is_bytes():
    # 384 MiB at 3.35 TB/s; 264 multiply-adds an element stay under it
    ms, by = C.bound(3 * 64 * 2**21, C.mont_mul_ops(2**21), C.peak_rates(1980))
    assert by == "bytes"
    assert ms == pytest.approx(3 * 64 * 2**21 / 3.35e12 * 1e3, rel=1e-12)
    ops_ms = 2**21 * 264 / (132 * 64 * 1.98e9) * 1e3
    assert ops_ms == pytest.approx(0.03310, abs=1e-5)
    assert ops_ms < ms
