"""The port's tools (the repo-level ``tools/`` of the JAX package), each a
module run with ``python -m repro_torch.tools.<name>``:

``check_env``            the environment in one report: torch, CUDA, the
                         cards, ``nvcc``, the kernels' build directory,
                         the autotune cache, the elastic eligibility, the
                         lint; PASS or WARN;
``profile_collectives``  ``dump``: a dry-run cell's largest collectives
                         (its record); ``fit``: time all-reduces on ranks,
                         fit α + β·b per tier, write a hw_profile.json;
``spmd_lint``            the port's lint (analysis/lint.py), non-zero on a
                         finding;
``profile_dots``         a dry step's counted operations by operator,
                         largest first, with the total;
``make_experiments``     an experiments page from the dry-run's cells and
                         the port's benchmark records.
"""
