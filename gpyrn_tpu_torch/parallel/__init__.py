"""Populations of hyperparameter searches on one device."""
