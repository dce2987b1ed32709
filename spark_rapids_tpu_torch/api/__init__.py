"""The user-facing surface: session, DataFrame, Column and functions."""
