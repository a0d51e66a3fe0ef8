"""Test-support library of the port: the KKT oracle and a batch generator."""
