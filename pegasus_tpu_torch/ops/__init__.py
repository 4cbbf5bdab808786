"""Record blocks, predicates and the scan-predicate kernel."""
