"""Evaluation entry points."""
