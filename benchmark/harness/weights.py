"""The configuration's weight files.  ``detector_weights`` and
``encoder_weights`` each name a trained file (a path from the root of
the checkout) or ask for ``"seeded"`` weights: those the benchmark
draws for the run with the network file's ``init``, from the run's seed
and a fixed salt of the role, and writes in the trained files' layout
into the run's directory, where the program loads them as it loads a
trained file and the reference reads the same file after the window."""

from __future__ import annotations

import math
import os
from typing import Dict

import torch

from reference import msgpack, nets

SEEDED = "seeded"
SALT = {"detector": 0xDE7EC7, "encoder": 0xE4C0DE}


def write_seeded(kind: str, seed: int, path: str, device) -> Dict[str, torch.Tensor]:
    """Seeded weights of network ``kind`` from ``seed``, drawn on
    ``device`` and written to ``path``; returns their state dict."""
    network = nets.network(kind)
    with torch.device("meta"):
        net = network.build()
    net = net.to_empty(device=device).eval()
    with torch.no_grad():
        for t in net.state_dict().values():
            t.fill_(math.nan)
        g = torch.Generator(device=device)
        g.manual_seed(int(seed) % (2**63))
        network.init(net, g)
    sd = net.state_dict()
    unset = [k for k, t in sd.items() if torch.isnan(t).any()]
    if unset:
        raise ValueError(f"{kind}.init left {len(unset)} leaves unset: {unset[:5]}")
    msgpack.write(path, msgpack.tree_of(sd, network.UNIT_BN_SCALE))
    return sd


def resolve(cfg: dict, seed: int, run_dir: str, device) -> dict:
    """``cfg`` with each weight entry that asks for seeded weights
    replaced by the path of the file drawn for this run."""
    out = dict(cfg)
    for role, salt in SALT.items():
        if cfg[f"{role}_weights"] == SEEDED:
            path = os.path.join(run_dir, f"{role}-{cfg[role]}.msgpack")
            write_seeded(cfg[role], int(seed) + salt, path, device)
            out[f"{role}_weights"] = path
    return out
