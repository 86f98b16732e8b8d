"""Fleet tools for PyTorch jobs: the gang trace (unitrace), the merged
capture report (trace_report), the straggler sweep (fleetstatus), the
journal merge (eventlog) and the local mini-fleet harness (minifleet)."""
