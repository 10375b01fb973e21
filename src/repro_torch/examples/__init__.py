"""The paper's example applications on the port, counterparts of the
repository's `examples/`: the same programs at the same parameters,
printing the same lines and ending in the same assertions.

Run from the repository root, e.g.
``PYTHONPATH=src python -m repro_torch.examples.lola_mnist --device cpu``
(the default device is CUDA, which raises where there is none). Each
``main(argv)`` returns its decrypted outputs beside the plaintext results.
"""
from __future__ import annotations

import argparse
from typing import Sequence

import torch

from repro_torch.core.context import resolve_device


def parse_device(argv: Sequence[str], doc: str) -> torch.device:
    """The example's one option: ``--device {cuda,cpu}``, CUDA by default."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ciphertext arithmetic runs")
    return resolve_device(ap.parse_args(list(argv)).device)
