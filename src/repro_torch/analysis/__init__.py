"""Static analysis: plan-contract checking and the port's lint (the port
of ``repro/analysis``).

  * ``contract`` — diff the collectives one training step issued, as
    ``core/collectives.py::record`` saw them, against the exchange
    contract its :class:`~repro_torch.core.plan.Plan` implies (bucket
    count and sizes, the two-level triple, the gatherv row-buffer pushes,
    the overlap schedule, the single fused scalar all-reduce).
  * ``lint`` — AST rules over the port's source: ``RunConfig`` stays
    hashable, and only the modules that own the process groups talk to
    the distributed package, so every exchange passes the record.

Both report :class:`~repro_torch.analysis.findings.Finding` records;
clean code produces an empty list.
"""
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.contract import (ContractViolation, check_contract,
                                           verify_step_contract)
from repro_torch.analysis.lint import lint_file, lint_paths, lint_repo

__all__ = [
    "Finding", "ContractViolation", "check_contract",
    "verify_step_contract", "lint_file", "lint_paths", "lint_repo",
]
