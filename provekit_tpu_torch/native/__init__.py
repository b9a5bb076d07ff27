"""The port's native host code: the BN254 curve engine (``curve.py``)."""
