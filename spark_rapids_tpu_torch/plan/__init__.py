"""Logical plans, the optimizer, the planner and adaptive execution."""
