"""Helpers of the reference's plan compiler that the fused engine uses."""
