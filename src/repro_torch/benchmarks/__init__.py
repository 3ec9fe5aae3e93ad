"""The reference's benchmarks (``benchmarks/``) replayed through the port:
``table1_census`` (paper Table 1), ``table3_transfer`` (paper Table 3),
``bucket_exchange`` (the bucketed dense exchange) and ``adaptive_replan``
(static against adaptive planning, and the two-table plan with overflow
growth); ``run`` dispatches them."""
