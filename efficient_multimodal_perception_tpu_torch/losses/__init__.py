"""Pretraining losses."""
