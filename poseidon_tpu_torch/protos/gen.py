"""Regenerate the port's protobuf Python modules from its .proto copies.

Run as: ``python -m poseidon_tpu_torch.protos.gen``

The generated ``*_pb2.py`` files are checked in, so importing the package
needs no protoc; this script regenerates them after a contract edit (the
contract is frozen against the reference, so that should be rare).  gRPC
service stubs are not generated: the service wiring is done by hand from
the method tables in ``poseidon_tpu_torch.protos.services``.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
PROTOS = ["firmament.proto", "poseidonstats.proto"]


def protoc_command() -> list:
    return ["protoc", f"--proto_path={HERE}", f"--python_out={HERE}"] + [
        str(HERE / p) for p in PROTOS
    ]


def generate() -> None:
    subprocess.check_call(protoc_command())


def main() -> int:
    cmd = protoc_command()
    if shutil.which("protoc") is None:
        # The checked-in *_pb2.py files are authoritative without protoc.
        print("protos: protoc not installed; skipping regeneration "
              "(checked-in *_pb2.py files are used as-is)")
        return 0
    print("+", " ".join(cmd))
    return subprocess.call(cmd)


if __name__ == "__main__":
    sys.exit(main())
