"""Transfer budgets and tick-path markers of the port (the reference
``analysis/budget.py``).  The analyzer that reads them (synccheck, the AST
lint, kernelcheck, poolcheck) is not ported yet; the engine's live STR002
accounting reads the budgets today."""
