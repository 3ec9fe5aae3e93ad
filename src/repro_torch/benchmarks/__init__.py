"""The reference's benchmarks (``benchmarks/``) replayed through the port:
``adaptive_replan`` (static against adaptive planning, and the two-table
plan with overflow growth)."""
