"""End-to-end examples of the port, each run as a module::

    python -m convex_dim_red_tpu_torch.examples.hadisst_case_study OUT_DIR
    python -m convex_dim_red_tpu_torch.examples.jra55_case_study OUT_DIR
    python -m convex_dim_red_tpu_torch.examples.distributed_scaling

The case studies take ``--quick`` (small grids, few restarts: the same
steps and artifacts) and ``--platform cuda|cpu`` (the card by default,
with no fallback); the scaling tour takes ``--platform`` and
``--world-size``.
"""
