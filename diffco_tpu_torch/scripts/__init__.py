"""Measurement entry points of the port, named as the JAX package's
``scripts/`` they mirror; run each as
``python3 -m diffco_tpu_torch.scripts.<name>``:

- ``roofline_fk_score``: kernel B1's time and its attribution to stages
  (the ablation kernels B7, ``csrc/dh_ablation.cu``), and a block-size
  sweep;
- ``ab_dual_tile``: B1 against its two-rows-per-thread variants (kernel B6,
  ``csrc/dh_dual_score.cu``).
"""
