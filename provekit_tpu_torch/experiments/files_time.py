"""Time each stage of writing and reading the passport circuit's .nps file.

    python3 provekit_tpu_torch/experiments/files_time.py

Builds ``passport_test_vector(seed=1)`` with its signature, compiles it for
the CPU (no stage below touches the card), then times the stages of
``io.files.write`` and ``io.files.read`` one by one, with the cyclic
collector off as in those functions: the document (``scheme_to_doc``), its
binary body (``binenc.encode``), the compressed file (zstd where the
``zstandard`` module is installed, zlib where it is not), and back:
decompression, ``binenc.decode``, ``scheme_from_doc``.  The body read back
must re-encode to the same bytes.  It prints one JSON line: the body's and
the file's sizes, the compressor, the SHA-256 of the body and the seconds
of each stage.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

    from provekit_tpu_torch.circuits import passport
    from provekit_tpu_torch.compiler import NoirProofScheme
    from provekit_tpu_torch.io import binenc, files

    seconds = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    dg1, sod, off, date, age, sig = passport.passport_test_vector(seed=1)
    program, _ = stage("circuit", lambda: passport.passport_circuit(
        dg1, sod, off, date, age, signature=sig))
    scheme = stage("from_program", lambda: NoirProofScheme.from_program(
        program, device="cpu"))
    gc.disable()
    try:
        doc = stage("scheme_to_doc", lambda: files.scheme_to_doc(scheme))
        body = stage("encode", lambda: binenc.encode(doc))
        blob = stage("compress", lambda: files._compress(body))
        del doc
        got = stage("decompress", lambda: files._decompress_body(blob))
        doc = stage("decode", lambda: binenc.decode(got))
        stage("scheme_from_doc", lambda: files.scheme_from_doc(doc, "cpu"))
        if binenc.encode(doc) != body:
            raise SystemExit("the body read back encodes to other bytes")
    finally:
        gc.enable()
    print(json.dumps({
        "body_bytes": len(body), "file_bytes": 20 + len(blob),
        "compressor": "zstd" if files._zstd is not None else "zlib",
        "body_sha256": hashlib.sha256(body).hexdigest(),
        "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
