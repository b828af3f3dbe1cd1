"""Fused potentials and their hand-written CUDA kernels (``../csrc``).

Counterpart of ``brancher_tpu/ops``.  Ported: the fused GLM value+grad
(``glm.py``, kernels K1-K4).  The fused leapfrog (K5), the whole-X logreg
kernel (K6), ``batched_hmc`` and ``resampling`` are still to port
(ROADMAP queues 1 and 2).
"""
