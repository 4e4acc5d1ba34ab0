"""Applications on the DPF server (port of ``dpf_tpu/apps``).

``batch_pir`` plans private batched lookups over access patterns and
runs them on the card through the per-key-table evaluations; ``sweep``
grids the planner's configurations, ``codesign`` joins a sweep with
measured server throughput into latency / recovery frontiers, and
``plots`` draws them (matplotlib, where it imports).
"""
