"""NUTS kernel configuration.

Counterpart of the ``NUTS`` class of ``brancher_tpu/inference/nuts.py``:
the settings ``sample()`` reads (``max_depth``, ``target_accept``,
``max_delta_energy``).  The per-chain engine of that module
(``make_step``, ``nuts_sample``) and the pipelined option are still to
port (ROADMAP queue 1, item 12).
"""
from __future__ import annotations


class NUTS:
    """NUTS kernel config (plugs into mcmc.sample)."""

    def __init__(self, max_depth: int = 10, target_accept: float = 0.8,
                 max_delta_energy: float = 1000.0):
        self.max_depth = max_depth
        self.target_accept = target_accept
        self.max_delta_energy = max_delta_energy
