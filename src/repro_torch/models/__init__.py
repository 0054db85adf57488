"""MLP stack."""
