"""Noise schedules and solvers."""
