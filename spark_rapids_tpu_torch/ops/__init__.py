"""Relational kernels: filter compaction, join ranges and gather maps,
grouping and segmented reductions, orderable keys."""
