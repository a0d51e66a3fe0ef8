"""Solver engines of the port."""
