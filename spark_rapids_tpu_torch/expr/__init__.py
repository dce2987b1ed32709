"""Expressions: references, literals, predicates, arithmetic and
aggregate functions."""
