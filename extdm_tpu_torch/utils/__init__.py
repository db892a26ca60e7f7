"""Seeding, logging and the training jobs' picture helpers."""
