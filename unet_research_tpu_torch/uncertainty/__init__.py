"""Uncertainty ensembles."""
